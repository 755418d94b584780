// Dense mode-0 MTTKRP for Hopper (sm_90a), exact and through the pSRAM numerics.
//
// Replaces two TPU kernels of src/repro/kernels/mttkrp.py:
//   * mttkrp_fused (pallas_call at :70, body _kernel :30): the exact
//       A = X_(0) @ (B ⊙ C),  (B ⊙ C)[j*K + k, r] = B[j, r] * C[k, r]
//     with each KR tile formed on the fly (never materialised in device
//     memory) and rounded to f32 before its product with X;
//   * mttkrp_psram_fused (pallas_call at :145, body _psram_kernel :90): the
//     same walk on int8 operands with per-row scales,
//       kr = (float(qb) * float(qc)) * (sb * sc),   x = float(qx) * sx,
//     f32 accumulation, then the ADC transfer of every `bi`-row output tile
//     over that tile's own max|acc| (full scale max(max|acc|, 1e-30)).
//
// What is carried over is the function, not the TPU's shape:
//
// * The TPU grid (I/bi, J, K/bk) runs in order and carries the accumulator
//   in VMEM across the (j, k) steps; one core walks the whole contraction of
//   a row block. At the shapes CP-ALS hands it, I/bi is 6-9 row blocks, which
//   would light up 9 of 132 SMs. Here the J*K contraction is SPLIT across
//   CTAs: CTA (row tile, rank tile, split) walks a contiguous range of
//   32-column stages and writes its (128 x 32) partial sum to a scratch
//   (splits, I, R); a second pass adds the splits in a fixed order, so the
//   result is deterministic.
// * The psram variant's ADC full scale is a property of the COMPLETE bi x R
//   output tile, so `bi` is numerics and no partial may be digitised: the
//   second pass of that variant (one CTA per bi-row tile) adds the splits,
//   reduces the tile's max|acc|, and only then applies the transfer curve.
//   The CTA tiling of the contraction (128 rows, 32 columns) is free and has
//   nothing to do with `bi`.
// * Per 32-column stage, a CTA has a tile of X_(0) in shared memory and
//   forms the 32 x 32 KR tile kr[kk, r] = b[j, r] * c[k, r] (column
//   j*K + k) in shared memory from L2-resident factor rows.
//   - The exact variant with 16-byte aligned rows (every CP-ALS shape) runs
//     mttkrp_ring_kernel: a two-stage TMA ring of 256 x 32 X tiles under
//     mbarriers, so X never passes through registers, three CTAs a SM; the
//     KR tile's (j, k) advance without a division; each thread accumulates
//     an 8-row x 8-column block (details at the kernel).
//   - The int8 variant runs mttkrp_psram_ring_kernel, a TMA ring of its
//     own that reads either the f32 tensor in place in any mode and
//     quantizes each tile as it stages it (the dense path), or the int8
//     codes of X_(0) (details at the kernel).
//   - The int8 variant on codes TMA cannot take, and the exact one on rows
//     that are not 16-byte aligned, run mttkrp_partials_kernel: 128 x 32 X
//     tiles loaded into registers one stage ahead and stored to shared
//     memory (as f32, scaled, for int8), each thread accumulating an 8-row x
//     4-column block (two shared-memory buffers, one barrier per stage).
//
// What bounds it: at CP-ALS shapes (R = 32) the exact variant reads X_(0)
// once, 4 bytes per entry, for 2R = 64 flops per entry: bytes and f32 FMA
// throughput are close (3.62 GB at 3.35 TB/s vs 5.8e10 flops at 67 TFLOP/s).
// The int8 variant on codes reads a quarter of the bytes and is bound by the
// f32 operations; on the f32 tensor it is bound by the bytes again. The
// design reads X_(0) exactly once, coalesced (16-byte loads where the row
// length allows), streaming past L2 so the factors stay there.
//
// Arithmetic contract: IEEE f32 throughout (fmaf, no TF32, no tensor cores);
// the KR tile is rounded to f32 before its product with x, as on the TPU; the
// ADC epilogue is rintf of a true division, clamped to +-(levels/2 - 1), the
// arithmetic of csrc/psram_matmul.cu. Built without --use_fast_math.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int TI = 128;        // rows of X_(0) per CTA
constexpr int TR = 32;         // rank columns per CTA
constexpr int TK = 32;         // contraction columns per stage
constexpr int THREADS = 128;   // 16 row groups x 8 column groups
constexpr int RM = TI / 16;    // rows per thread: ty, ty + 16, ..., ty + 112
constexpr int RN = TR / 8;     // rank columns per thread: 4 tx .. 4 tx + 3
constexpr int XS = TK + 4;     // padded row of the X tile in shared memory
constexpr int KR_PER_THREAD = TK * TR / THREADS;
constexpr int ADC_THREADS = 256;

// Registers that carry one stage of X_(0) from global to shared memory:
// 16-byte loads where `VEC` (int8 only), else one element per load.
template <bool QUANT, bool VEC>
struct XRaw {
    static_assert(QUANT || !VEC, "aligned f32 rows go through mttkrp_ring_kernel");
    using type = typename std::conditional<
        QUANT, typename std::conditional<VEC, int4[2], int[32]>::type, float[32]>::type;
};

template <bool QUANT, bool VEC>
__device__ __forceinline__ void load_x(typename XRaw<QUANT, VEC>::type& raw, const void* xv,
                                       int i0, long long col0, int I, long long JK, int tid) {
    if constexpr (VEC) {
        const int8_t* x = static_cast<const int8_t*>(xv);
#pragma unroll
        for (int u = 0; u < 2; ++u) {
            const int idx = u * THREADS + tid;
            const int row = i0 + (idx >> 1);
            const long long col = col0 + (idx & 1) * 16;
            raw[u] = (row < I && col < JK)
                         ? __ldcs(reinterpret_cast<const int4*>(x + row * JK + col))
                         : make_int4(0, 0, 0, 0);
        }
    } else {
#pragma unroll
        for (int u = 0; u < 32; ++u) {
            const int idx = u * THREADS + tid;
            const int row = i0 + (idx >> 5);
            const long long col = col0 + (idx & 31);
            const bool ok = row < I && col < JK;
            if constexpr (QUANT) {
                raw[u] = ok ? static_cast<int>(__ldcs(static_cast<const signed char*>(xv) + row * JK + col)) : 0;
            } else {
                raw[u] = ok ? __ldcs(static_cast<const float*>(xv) + row * JK + col) : 0.f;
            }
        }
    }
}

// x = float(q) * sx[row] for the int8 variant; the f32 value as it is otherwise.
template <bool QUANT, bool VEC>
__device__ __forceinline__ void store_x(float (*xs)[XS], const typename XRaw<QUANT, VEC>::type& raw,
                                        const float* srow, const float* __restrict__ sx,
                                        int i0, int I, int tid) {
    if constexpr (VEC) {
#pragma unroll
        for (int u = 0; u < 2; ++u) {
            const int idx = u * THREADS + tid;
            const int words[4] = {raw[u].x, raw[u].y, raw[u].z, raw[u].w};
            float* dst = &xs[idx >> 1][(idx & 1) * 16];
#pragma unroll
            for (int w = 0; w < 4; ++w) {
                float4 v;
                v.x = __fmul_rn(static_cast<float>(static_cast<int8_t>(words[w] & 0xff)), srow[u]);
                v.y = __fmul_rn(static_cast<float>(static_cast<int8_t>((words[w] >> 8) & 0xff)), srow[u]);
                v.z = __fmul_rn(static_cast<float>(static_cast<int8_t>((words[w] >> 16) & 0xff)), srow[u]);
                v.w = __fmul_rn(static_cast<float>(static_cast<int8_t>((words[w] >> 24) & 0xff)), srow[u]);
                *reinterpret_cast<float4*>(dst + 4 * w) = v;
            }
        }
    } else {
#pragma unroll
        for (int u = 0; u < 32; ++u) {
            const int idx = u * THREADS + tid;
            const int rl = idx >> 5;
            if constexpr (QUANT) {
                const float s = (i0 + rl < I) ? sx[i0 + rl] : 0.f;
                xs[rl][idx & 31] = __fmul_rn(static_cast<float>(raw[u]), s);
            } else {
                xs[rl][idx & 31] = raw[u];
            }
        }
    }
}

// The KR tile of one stage: kr[kk, rr] for contraction column col0 + kk
// (j = col / K, k = col % K) and rank column r0 + rr; 0 outside the matrix.
template <bool QUANT>
__device__ __forceinline__ void form_kr(float (&kr)[KR_PER_THREAD], const void* bv,
                                        const float* __restrict__ sb, const void* cv,
                                        const float* __restrict__ sc, long long col0, int r0,
                                        int K, int R, long long JK, int tid) {
    const int rr = tid & 31;
    const int r = r0 + rr;
    // column of u = 0; the thread's columns step by THREADS / 32 = 4
    const long long colw = col0 + (tid >> 5);
    long long j = colw / K;
    int k = static_cast<int>(colw - j * K);
#pragma unroll
    for (int u = 0; u < KR_PER_THREAD; ++u) {
        const long long col = colw + 4 * u;
        float v = 0.f;
        if (col < JK && r < R) {
            if constexpr (QUANT) {
                const float qprod = __fmul_rn(
                    static_cast<float>(static_cast<const int8_t*>(bv)[j * R + r]),
                    static_cast<float>(static_cast<const int8_t*>(cv)[static_cast<long long>(k) * R + r]));
                v = __fmul_rn(qprod, __fmul_rn(sb[j], sc[k]));
            } else {
                v = __fmul_rn(static_cast<const float*>(bv)[j * R + r],
                              static_cast<const float*>(cv)[static_cast<long long>(k) * R + r]);
            }
        }
        kr[u] = v;
        k += 4;
        while (k >= K) {     // K >= 32 in practice: at most once
            k -= K;
            ++j;
        }
    }
}

// Pass 1: partial[split, i, r] = sum over the split's stages of x[i, col] * kr[col, r].
template <bool QUANT, bool VEC>
__global__ void __launch_bounds__(THREADS)
mttkrp_partials_kernel(const void* __restrict__ xv, const float* __restrict__ sx,
                       const void* __restrict__ bv, const float* __restrict__ sb,
                       const void* __restrict__ cv, const float* __restrict__ sc,
                       float* __restrict__ partials, int I, int K, int R, long long JK,
                       int n_chunks, int chunks_per_split) {
    __shared__ __align__(16) float xs[2][TI][XS];
    __shared__ __align__(16) float ks[2][TK][TR];

    const int tid = threadIdx.x;
    const int tx = tid & 7;
    const int ty = tid >> 3;
    const int i0 = blockIdx.x * TI;
    const int r0 = blockIdx.y * TR;
    const int split = blockIdx.z;
    const int t_begin = split * chunks_per_split;
    const int t_end = min(n_chunks, t_begin + chunks_per_split);

    // per-row scales of the rows this thread stages (16-byte int8 path)
    float srow[2] = {0.f, 0.f};
    if constexpr (QUANT && VEC) {
#pragma unroll
        for (int u = 0; u < 2; ++u) {
            const int row = i0 + ((u * THREADS + tid) >> 1);
            srow[u] = row < I ? sx[row] : 0.f;
        }
    }

    float acc[RM][RN];
#pragma unroll
    for (int m = 0; m < RM; ++m)
#pragma unroll
        for (int n = 0; n < RN; ++n) acc[m][n] = 0.f;

    typename XRaw<QUANT, VEC>::type raw;
    float kr[KR_PER_THREAD];
    if (t_begin < t_end) {
        load_x<QUANT, VEC>(raw, xv, i0, static_cast<long long>(t_begin) * TK, I, JK, tid);
        form_kr<QUANT>(kr, bv, sb, cv, sc, static_cast<long long>(t_begin) * TK, r0, K, R, JK, tid);
        store_x<QUANT, VEC>(xs[0], raw, srow, sx, i0, I, tid);
#pragma unroll
        for (int u = 0; u < KR_PER_THREAD; ++u) ks[0][4 * u + (tid >> 5)][tid & 31] = kr[u];
        __syncthreads();
    }
    for (int t = t_begin; t < t_end; ++t) {
        const int buf = (t - t_begin) & 1;
        const bool more = t + 1 < t_end;
        if (more) {
            const long long col0 = static_cast<long long>(t + 1) * TK;
            load_x<QUANT, VEC>(raw, xv, i0, col0, I, JK, tid);
            form_kr<QUANT>(kr, bv, sb, cv, sc, col0, r0, K, R, JK, tid);
        }
#pragma unroll
        for (int k4 = 0; k4 < TK; k4 += 4) {
            float4 kv[4];
#pragma unroll
            for (int q = 0; q < 4; ++q) kv[q] = *reinterpret_cast<const float4*>(&ks[buf][k4 + q][4 * tx]);
#pragma unroll
            for (int m = 0; m < RM; ++m) {
                const float4 xv4 = *reinterpret_cast<const float4*>(&xs[buf][ty + 16 * m][k4]);
                const float xq[4] = {xv4.x, xv4.y, xv4.z, xv4.w};
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                    acc[m][0] = fmaf(xq[q], kv[q].x, acc[m][0]);
                    acc[m][1] = fmaf(xq[q], kv[q].y, acc[m][1]);
                    acc[m][2] = fmaf(xq[q], kv[q].z, acc[m][2]);
                    acc[m][3] = fmaf(xq[q], kv[q].w, acc[m][3]);
                }
            }
        }
        if (more) {
            store_x<QUANT, VEC>(xs[buf ^ 1], raw, srow, sx, i0, I, tid);
#pragma unroll
            for (int u = 0; u < KR_PER_THREAD; ++u) ks[buf ^ 1][4 * u + (tid >> 5)][tid & 31] = kr[u];
        }
        __syncthreads();
    }

    float* dst = partials + static_cast<size_t>(split) * I * R;
#pragma unroll
    for (int m = 0; m < RM; ++m) {
        const int row = i0 + ty + 16 * m;
        if (row >= I) continue;
#pragma unroll
        for (int n = 0; n < RN; ++n) {
            const int r = r0 + 4 * tx + n;
            if (r < R) dst[static_cast<size_t>(row) * R + r] = acc[m][n];
        }
    }
}

// ---- the exact variant on an asynchronous ring (16-byte aligned rows) ----
//
// X_(0) never passes through registers: thread 0 keeps two 256 x 32 tiles
// in flight by TMA (the 128-byte swizzle, streaming past L2 with an
// evict-first policy so the factors stay there), each stage behind its own
// mbarrier; the shared memory holds three such CTAs a SM (on the H100,
// three stages at two CTAs a SM, and 128-row tiles with 4 x 8 outputs a
// thread, were both slower). The KR tile of a stage is formed by all
// threads from L2-resident rows of b and c, with (j, k) advanced from stage
// to stage without a division, one stage ahead in registers. Each thread accumulates an 8-row x
// 8-rank block: per 4 columns, 8 swizzled 16-byte loads of x (8 consecutive
// rows a warp: conflict-free) and 8 of KR feed 256 FMAs. One CTA barrier a
// stage releases the stage to the TMA and publishes the next KR tile.

constexpr int XI = 256;                    // rows of X_(0) per CTA
constexpr int X_STAGES = 2;                // X tiles in the ring
constexpr int X_THREADS = 128;             // 32 row groups x 4 rank groups
constexpr int X_CTAS_PER_SM = 3;           // what the shared memory holds
constexpr int X_STAGE_BYTES = XI * TK * 4; // 128-byte rows
constexpr int X_SMEM = 1024 + X_STAGES * X_STAGE_BYTES + 2 * TK * TR * 4 + 8 * X_STAGES;

// KR entries (kk = (tid >> 5) + 4u, rank r0 + (tid & 31)), u = 0..7, of the
// stage starting at column col = j * K + k; 0 outside the matrix.
__device__ __forceinline__ void kr_stage(float (&kr)[KR_PER_THREAD], const float* __restrict__ b,
                                         const float* __restrict__ c, long long j, int k,
                                         long long col, int r0, int K, int R, long long JK,
                                         int tid) {
    const int r = r0 + (tid & 31);
    const int first = tid >> 5;
    col += first;
    k += first;
    while (k >= K) {
        k -= K;
        ++j;
    }
#pragma unroll
    for (int u = 0; u < KR_PER_THREAD; ++u) {
        kr[u] = (col < JK && r < R)
                    ? __fmul_rn(__ldg(b + j * R + r), __ldg(c + static_cast<long long>(k) * R + r))
                    : 0.f;
        col += 4;
        k += 4;
        while (k >= K) {
            k -= K;
            ++j;
        }
    }
}

__global__ void __launch_bounds__(X_THREADS, X_CTAS_PER_SM)
mttkrp_ring_kernel(const __grid_constant__ CUtensorMap xmap, const float* __restrict__ b,
                   const float* __restrict__ c, float* __restrict__ partials, int I, int K, int R,
                   long long JK, int n_chunks, int chunks_per_split) {
    extern __shared__ uint8_t smem_raw[];
    uint8_t* base = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
    const float* xs = reinterpret_cast<const float*>(base);
    float (*ks)[TK][TR] = reinterpret_cast<float (*)[TK][TR]>(base + X_STAGES * X_STAGE_BYTES);
    const uint32_t x_s = smem_u32(base);
    const uint32_t bars = x_s + X_STAGES * X_STAGE_BYTES + 2 * TK * TR * 4;

    const int tid = threadIdx.x;
    const int tx = tid & 3;           // ranks 8 tx .. 8 tx + 7
    const int ty = tid >> 2;          // rows ty + 32 m, m = 0..7
    const int i0 = blockIdx.x * XI;
    const int r0 = blockIdx.y * TR;
    const int t_begin = blockIdx.z * chunks_per_split;
    const int n = min(n_chunks, t_begin + chunks_per_split) - t_begin;

    if (tid == 0) {
        for (int st = 0; st < X_STAGES; ++st) mbar_init(bars + 8 * st, 1);
        mbar_init_fence();
    }
    __syncthreads();
    const uint64_t policy = evict_first_policy();
    if (tid == 0) {
        for (int st = 0; st < min(X_STAGES, n); ++st) {
            mbar_expect_tx(bars + 8 * st, X_STAGE_BYTES);
            tma_load_2d(x_s + st * X_STAGE_BYTES, &xmap, bars + 8 * st, (t_begin + st) * TK, i0,
                        policy);
        }
    }

    // (j, k) of the first column of the stage whose KR tile is in `kr`
    long long col = static_cast<long long>(t_begin) * TK;
    long long j = col / K;
    int k = static_cast<int>(col - j * K);
    auto advance = [&]() {
        col += TK;
        k += TK;
        while (k >= K) {
            k -= K;
            ++j;
        }
    };
    float kr[KR_PER_THREAD];
    kr_stage(kr, b, c, j, k, col, r0, K, R, JK, tid);
#pragma unroll
    for (int u = 0; u < KR_PER_THREAD; ++u) ks[0][4 * u + (tid >> 5)][tid & 31] = kr[u];
    if (n > 1) {
        advance();
        kr_stage(kr, b, c, j, k, col, r0, K, R, JK, tid);
    }
    __syncthreads();

    float acc[8][8];
#pragma unroll
    for (int m = 0; m < 8; ++m)
#pragma unroll
        for (int q = 0; q < 8; ++q) acc[m][q] = 0.f;

    const int sw = ty & 7;            // the swizzle phase of every row this thread reads
    for (int u = 0; u < n; ++u) {
        const int st = u % X_STAGES;
        const int buf = u & 1;
        mbar_wait(bars + 8 * st, (u / X_STAGES) & 1);
        const float* xt = xs + st * (X_STAGE_BYTES / 4) + ty * TK;
#pragma unroll
        for (int k4 = 0; k4 < TK / 4; ++k4) {
            float4 xv[8];
#pragma unroll
            for (int m = 0; m < 8; ++m) {
                xv[m] = *reinterpret_cast<const float4*>(xt + m * 32 * TK + ((k4 ^ sw) << 2));
            }
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                const float4 ka = *reinterpret_cast<const float4*>(&ks[buf][4 * k4 + q][8 * tx]);
                const float4 kb = *reinterpret_cast<const float4*>(&ks[buf][4 * k4 + q][8 * tx + 4]);
#pragma unroll
                for (int m = 0; m < 8; ++m) {
                    const float x = q == 0 ? xv[m].x : q == 1 ? xv[m].y : q == 2 ? xv[m].z : xv[m].w;
                    acc[m][0] = fmaf(x, ka.x, acc[m][0]);
                    acc[m][1] = fmaf(x, ka.y, acc[m][1]);
                    acc[m][2] = fmaf(x, ka.z, acc[m][2]);
                    acc[m][3] = fmaf(x, ka.w, acc[m][3]);
                    acc[m][4] = fmaf(x, kb.x, acc[m][4]);
                    acc[m][5] = fmaf(x, kb.y, acc[m][5]);
                    acc[m][6] = fmaf(x, kb.z, acc[m][6]);
                    acc[m][7] = fmaf(x, kb.w, acc[m][7]);
                }
            }
        }
        if (u + 1 < n) {
#pragma unroll
            for (int v = 0; v < KR_PER_THREAD; ++v) ks[buf ^ 1][4 * v + (tid >> 5)][tid & 31] = kr[v];
        }
        __syncthreads();              // stage st and KR tile buf are consumed
        if (tid == 0 && u + X_STAGES < n) {
            mbar_expect_tx(bars + 8 * st, X_STAGE_BYTES);
            tma_load_2d(x_s + st * X_STAGE_BYTES, &xmap, bars + 8 * st,
                        (t_begin + u + X_STAGES) * TK, i0, policy);
        }
        if (u + 2 < n) {
            advance();
            kr_stage(kr, b, c, j, k, col, r0, K, R, JK, tid);
        }
    }

    float* dst = partials + static_cast<size_t>(blockIdx.z) * I * R;
#pragma unroll
    for (int m = 0; m < 8; ++m) {
        const int row = i0 + ty + 32 * m;
        if (row >= I) continue;
#pragma unroll
        for (int q = 0; q < 8; ++q) {
            const int r = r0 + 8 * tx + q;
            if (r < R) dst[static_cast<size_t>(row) * R + r] = acc[m][q];
        }
    }
}

// Pass 2 of the exact variant: out[e] = sum over splits, in split order.
__global__ void __launch_bounds__(256)
mttkrp_sum_kernel(const float* __restrict__ partials, float* __restrict__ out,
                  long long n_values, int splits) {
    const long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (e >= n_values) return;
    float sum = 0.f;
    for (int s = 0; s < splits; ++s) sum = __fadd_rn(sum, partials[s * n_values + e]);
    out[e] = sum;
}

// Pass 2 of the psram variant: one CTA per bi-row output tile adds the
// splits in order, reduces the tile's max|acc|, then digitises the tile.
__global__ void __launch_bounds__(ADC_THREADS)
mttkrp_adc_kernel(const float* __restrict__ partials, float* __restrict__ out,
                  long long n_values, int splits, int tile_values, float levels,
                  float code_max) {
    __shared__ float warp_max[ADC_THREADS / 32];
    const long long lo = static_cast<long long>(blockIdx.x) * tile_values;
    float amax = 0.f;
    for (int e = threadIdx.x; e < tile_values; e += ADC_THREADS) {
        float sum = 0.f;
        for (int s = 0; s < splits; ++s) sum = __fadd_rn(sum, partials[s * n_values + lo + e]);
        out[lo + e] = sum;
        amax = fmaxf(amax, fabsf(sum));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
    if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = amax;
    __syncthreads();
    float fs = 0.f;
#pragma unroll
    for (int w = 0; w < ADC_THREADS / 32; ++w) fs = fmaxf(fs, warp_max[w]);
    fs = fmaxf(fs, 1e-30f);
    const float lsb = __fdiv_rn(__fmul_rn(2.0f, fs), levels);
    // each thread digitises the values it wrote itself: no barrier needed
    for (int e = threadIdx.x; e < tile_values; e += ADC_THREADS) {
        float code = rintf(__fdiv_rn(out[lo + e], lsb));
        code = fminf(fmaxf(code, -code_max), code_max);
        out[lo + e] = __fmul_rn(code, lsb);
    }
}

// ---- the psram variant on the TMA ring: the tensor read in place ----
//
// The unfolding is the array's DRIVEN operand, quantized per row on every
// call: q = clamp(rint(x / s), -127, 127), s = max|x over the row| / 127, and
// the kernel multiplies float(q) * s. Here that quantization happens as each
// tile is staged, so neither the unfolding nor its codes ever reach HBM:
//
// * For mode m of a contiguous (I, J, K) tensor, row r and contraction column
//   (a, b) of the unfolding (b fastest) lie at base + (a * Rw + r) * B + b:
//   (A, Rw, B) = (1, I, J*K), (I, J, K), (I*J, K, 1). A TMA map addresses
//   each in place: {B, Rw, A} (boxes of 32 b x 256 rows x 1 a, the 128-byte
//   swizzle, "rows") where B > 1, {Rw, A} (boxes of 256 rows x 32 a, no
//   swizzle: one box lands as a column-major [32][256] tile, "cols") where
//   B = 1. The contraction is cut into pieces of P columns (P = B for "rows",
//   all J*K columns otherwise) and each piece into 32-column stages, so a
//   stage never straddles a; TMA's zero fill pads a piece's ragged last
//   stage and the KR entries of the padded columns are 0.
// * mttkrp_rowmax_*_kernel stream the tensor once in memory order for the
//   row maxima (exact, so atomicMax on the non-negative bit patterns gives
//   the same bits in any order; NaN's pattern exceeds inf's); the wrapper
//   turns them into scales with quantize_symmetric's own torch ops.
// * mttkrp_psram_ring_kernel keeps two stages in flight under mbarriers
//   (evict-first, so the factors stay in L2), as mttkrp_ring_kernel does,
//   with one CTA barrier a stage. Every staged value is loaded by one
//   thread and drive-quantized in registers (drive_codes); the two threads
//   of a pair swap theirs by one shuffle, and each multiplies the pair's
//   four rows into its half of the 32 ranks (4 x 16 sums, ~20 floats read
//   from shared memory for 64 FMAs; mttkrp_ring_kernel's 8 x 8 block reads
//   16). Quantizing where mttkrp_ring_kernel has each value loaded by four
//   threads would cost four times the quantizations; a thread owning two
//   whole rows x 32 ranks reads 34 floats for 64 FMAs; a pass that converts
//   the tile in place first costs a second barrier a stage and a phase with
//   no FMAs in it.
// * The codes front end ("codes") stages the TPU kernel's own inputs, the
//   int8 unfolding qx0 (I, J*K) and its scales: 256 x 32-byte boxes (no
//   swizzle), each thread loading its two rows' 32 codes once a stage;
//   x = float(q) * sx[row], store_x's arithmetic. Every front end adds each
//   output's products in column order, so where two cut the contraction
//   into the same stages (A = 1, B = 1, or B % 32 = 0) and plan the same
//   splits they give the same bits.
// * drive_codes forms the IEEE quotient from a per-row reciprocal and two
//   fma corrections, no division and no branch in the unrolled stage;
//   mttkrp_drive_codes_kernel writes what it computes, for the checks.
//
// The splits, their order, the KR tile rounded to f32 before its product
// (kr = (float(qb) * float(qc)) * (sb * sc)) and the ADC pass over each
// bi-row tile are those of the partials kernel.

enum Front : int { FRONT_ROWS = 0, FRONT_COLS = 1, FRONT_CODES = 2 };

constexpr int AMAX_THREADS = 256;
constexpr int Q_I8_STAGE = XI * TK;        // an f32 stage's tile of int8 codes: 8 KB

// The f32 front ends stage what the exact ring stages: the same rows, stage
// and shared memory, so the split plan is the one mttkrp_ring_shape states.
template <int FRONT>
struct QRing {
    static constexpr int STAGE = FRONT == FRONT_CODES ? Q_I8_STAGE : X_STAGE_BYTES;
    static constexpr int SMEM = 1024 + X_STAGES * STAGE + 2 * TK * TR * 4 + 8 * X_STAGES;
};
static_assert(QRing<FRONT_ROWS>::SMEM == X_SMEM && QRing<FRONT_COLS>::SMEM == X_SMEM,
              "the f32 front ends' ring is the exact ring's");

// q[e] = rint(x[e] / s[e]) with x / s the IEEE quotient, as quantize_symmetric
// computes it, without a division or a branch: rs = RN(1/s) (__frcp_rn),
// q0 = RN(x rs), then two corrections q' = RN(q + r rs) by the exact
// remainder r = x - s q (one fma), as the division's own sequence does;
// q1 is within an ulp of x / s, and from a faithful quotient and the
// correctly rounded reciprocal one correction gives RN(x / s) (Markstein).
// That holds where nothing overflows (max|x| below ~3e38) or underflows:
// s >= 1e-12 / 127 is normal, and wherever |x / s| >= 1/4 (the codes that
// can round either way) x and r are normal too; below, every quotient
// rounds to 0. No clamp: |x / s| <= 127 (1 + 2^-23) never rounds past
// +-127. The checks hold it to torch's division on every value they see.
template <int N>
__device__ __forceinline__ void drive_codes(const float (&x)[N], const float (&s)[N],
                                            const float (&rs)[N], float (&q)[N]) {
#pragma unroll
    for (int e = 0; e < N; ++e) {
        const float q0 = __fmul_rn(x[e], rs[e]);
        const float q1 = __fmaf_rn(__fmaf_rn(-s[e], q0, x[e]), rs[e], q0);
        q[e] = rintf(__fmaf_rn(__fmaf_rn(-s[e], q1, x[e]), rs[e], q1));
    }
}

__device__ __forceinline__ unsigned abs_bits(float v) { return __float_as_uint(v) & 0x7fffffffu; }

// Row maxima where B > 1 (B % 4 == 0): CTA (r, chunk) scans row r's values
// w = a * B + b, w in [chunk * span, (chunk + 1) * span), at
// x[(a * Rw + r) * B + b], 16 bytes a thread a step; amax holds bit patterns.
__global__ void __launch_bounds__(AMAX_THREADS)
mttkrp_rowmax_rows_kernel(const float* __restrict__ x, unsigned* __restrict__ amax, int Rw,
                          long long B, long long AB, long long span, long long step_b,
                          long long step_off, long long wrap) {
    __shared__ unsigned warp_max[AMAX_THREADS / 32];
    const int r = blockIdx.x;
    const long long w0 = static_cast<long long>(blockIdx.y) * span + 4 * threadIdx.x;
    const long long w1 = min(AB, (static_cast<long long>(blockIdx.y) + 1) * span);
    const long long a = w0 / B;
    long long b = w0 - a * B;
    long long off = (a * Rw + r) * B + b;
    unsigned m = 0;
#pragma unroll 4
    for (long long w = w0; w < w1; w += 4 * AMAX_THREADS) {
        const float4 v = __ldcs(reinterpret_cast<const float4*>(x + off));
        m = max(m, max(max(abs_bits(v.x), abs_bits(v.y)), max(abs_bits(v.z), abs_bits(v.w))));
        off += step_off;
        b += step_b;
        if (b >= B) {       // into the next piece of the row: skip the other rows' pieces
            b -= B;
            off += wrap;
        }
    }
    m = __reduce_max_sync(0xffffffffu, m);
    if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
    __syncthreads();
    if (threadIdx.x == 0) {
#pragma unroll
        for (int w = 1; w < AMAX_THREADS / 32; ++w) m = max(m, warp_max[w]);
        atomicMax(amax + r, m);
    }
}

// Row maxima where B == 1 (rows contiguous, Rw % 4 == 0): CTA (tile,
// chunk) scans rows tile * 256 .. + 255 over a in [chunk * span, ...), a
// thread four rows of every fourth a.
__global__ void __launch_bounds__(AMAX_THREADS)
mttkrp_rowmax_cols_kernel(const float* __restrict__ x, unsigned* __restrict__ amax, long long A,
                          int Rw, long long span) {
    constexpr int LANES = 64;                         // 64 x 4 rows
    constexpr int GROUPS = AMAX_THREADS / LANES;      // a's in flight
    __shared__ uint4 part[GROUPS][LANES];
    const int lane = threadIdx.x % LANES;
    const int r = blockIdx.x * 4 * LANES + 4 * lane;
    const long long a0 = static_cast<long long>(blockIdx.y) * span;
    const long long a1 = min(A, a0 + span);
    uint4 m = make_uint4(0u, 0u, 0u, 0u);
    if (r < Rw) {
#pragma unroll 4
        for (long long a = a0 + threadIdx.x / LANES; a < a1; a += GROUPS) {
            const float4 v = __ldcs(reinterpret_cast<const float4*>(x + a * Rw + r));
            m.x = max(m.x, abs_bits(v.x));
            m.y = max(m.y, abs_bits(v.y));
            m.z = max(m.z, abs_bits(v.z));
            m.w = max(m.w, abs_bits(v.w));
        }
    }
    part[threadIdx.x / LANES][lane] = m;
    __syncthreads();
    if (threadIdx.x < LANES && r < Rw) {
#pragma unroll
        for (int g = 1; g < GROUPS; ++g) {
            const uint4 o = part[g][lane];
            m.x = max(m.x, o.x);
            m.y = max(m.y, o.y);
            m.z = max(m.z, o.z);
            m.w = max(m.w, o.w);
        }
        atomicMax(amax + r, m.x);
        atomicMax(amax + r + 1, m.y);
        atomicMax(amax + r + 2, m.z);
        atomicMax(amax + r + 3, m.w);
    }
}

// The check entry's kernel: codes[r, a * B + b] = the int8 code drive_code
// gives x[(a * Rw + r) * B + b] against sx[r], in the tensor's memory order.
__global__ void __launch_bounds__(256)
mttkrp_drive_codes_kernel(const float* __restrict__ x, const float* __restrict__ sx,
                          int8_t* __restrict__ codes, long long A, int Rw, long long B) {
    const unsigned long long n = static_cast<unsigned long long>(A) * Rw * B;
    for (unsigned long long e = static_cast<unsigned long long>(blockIdx.x) * blockDim.x + threadIdx.x;
         e < n; e += static_cast<unsigned long long>(gridDim.x) * blockDim.x) {
        const unsigned long long t = e / B;
        const long long b = static_cast<long long>(e - t * B);
        const int r = static_cast<int>(t % Rw);
        const long long a = static_cast<long long>(t / Rw);
        const float v[1] = {x[e]};
        const float sv[1] = {sx[r]};
        const float rv[1] = {__frcp_rn(sv[0])};
        float q[1];
        drive_codes<1>(v, sv, rv, q);
        codes[static_cast<long long>(r) * A * B + a * B + b] =
            static_cast<int8_t>(static_cast<int>(q[0]));
    }
}

// Where the ring stands in the contraction: stage s is chunk c of piece p,
// columns col = p * P + 32 c .. of the unfolding, none at or past the
// piece's end lim; (j, k) = divmod(col, K) name the KR entry's factor rows.
struct StageWalk {
    long long col, lim, j;
    int k, c;

    __device__ __forceinline__ void start(int s, int cpp, long long P, int K) {
        const int p = s / cpp;
        c = s - p * cpp;
        col = p * P + static_cast<long long>(c) * TK;
        lim = (p + 1) * P;
        j = col / K;
        k = static_cast<int>(col - j * K);
    }
    __device__ __forceinline__ void next(int cpp, long long P, int K) {
        const int d = c + 1 < cpp ? TK : static_cast<int>(lim - col);   // d <= TK
        if (++c == cpp) {
            c = 0;
            lim += P;
        }
        col += d;
        k += d;
        while (k >= K) {
            k -= K;
            ++j;
        }
    }
};

// KR entries (kk = (tid >> 5) + 4u, rank r0 + (tid & 31)) of the stage at
// column col = j * K + k from the quantized factors, as form_kr<true> forms
// them; 0 at or past lim.
__device__ __forceinline__ void kr_stage_q(float (&kr)[KR_PER_THREAD], const int8_t* __restrict__ qb,
                                           const float* __restrict__ sb, const int8_t* __restrict__ qc,
                                           const float* __restrict__ sc, long long j, int k,
                                           long long col, long long lim, int r0, int K, int R,
                                           int tid) {
    const int r = r0 + (tid & 31);
    const int first = tid >> 5;
    col += first;
    k += first;
    while (k >= K) {
        k -= K;
        ++j;
    }
#pragma unroll
    for (int u = 0; u < KR_PER_THREAD; ++u) {
        kr[u] = (col < lim && r < R)
                    ? __fmul_rn(__fmul_rn(static_cast<float>(__ldg(qb + j * R + r)),
                                          static_cast<float>(__ldg(qc + static_cast<long long>(k) * R + r))),
                                __fmul_rn(__ldg(sb + j), __ldg(sc + k)))
                    : 0.f;
        col += 4;
        k += 4;
        while (k >= K) {
            k -= K;
            ++j;
        }
    }
}

// thread 0: stage s (piece p, chunk c) of the walk into ring slot `dst`
template <int FRONT>
__device__ __forceinline__ void load_stage(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                           int s, int cpp, int i0, uint64_t policy) {
    mbar_expect_tx(bar, QRing<FRONT>::STAGE);
    const int p = s / cpp;
    const int c = s - p * cpp;
    if constexpr (FRONT == FRONT_ROWS) {
        tma_load_3d(dst, map, bar, c * TK, i0, p, policy);
    } else if constexpr (FRONT == FRONT_COLS) {
        tma_load_2d(dst, map, bar, i0, c * TK, policy);
    } else {
        tma_load_2d(dst, map, bar, c * TK, i0, policy);
    }
}

// The thread's two rows of a landed stage at columns 4 k4 .. 4 k4 + 3 into
// x[0..1], as the FMA loop multiplies them: float(q) * s with q drive-quantized from the
// f32 values (rows t and t + 128 of a swizzled "rows" tile, 2t and 2t + 1
// of a [TK][XI] "cols" tile), or float(q) * sx of the codes (rows t and
// t + 128, `w` their 32 codes as loaded at the stage's start). A code of
// 0 gives +0, as float(int8) does.
template <int FRONT>
__device__ __forceinline__ void stage_x4(float (&x)[4][4], const uint8_t* stage, const int4 (&w)[2][2],
                                         int k4, int tid, const float (&s)[2], const float (&rs)[2]) {
    if constexpr (FRONT == FRONT_CODES) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int4 v = w[h][k4 >> 2];
            const int word = (k4 & 3) == 0 ? v.x : (k4 & 3) == 1 ? v.y : (k4 & 3) == 2 ? v.z : v.w;
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
                x[h][kk] = __fmul_rn(static_cast<float>(static_cast<int8_t>((word >> (8 * kk)) & 0xff)),
                                     s[h]);
            }
        }
    } else {
        const float* xs = reinterpret_cast<const float*>(stage);
        float v[8], sv[8], rv[8], q[8];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            if constexpr (FRONT == FRONT_ROWS) {
                const int row = tid + 128 * h;            // row & 7 == tid & 7: 8 rows, 8 banks
                const float4 f = *reinterpret_cast<const float4*>(xs + row * TK + ((k4 ^ (tid & 7)) << 2));
                v[4 * h] = f.x;
                v[4 * h + 1] = f.y;
                v[4 * h + 2] = f.z;
                v[4 * h + 3] = f.w;
            }
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
                sv[4 * h + kk] = s[h];
                rv[4 * h + kk] = rs[h];
            }
        }
        if constexpr (FRONT == FRONT_COLS) {
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
                const float2 f = *reinterpret_cast<const float2*>(xs + (4 * k4 + kk) * XI + 2 * tid);
                v[kk] = f.x;
                v[4 + kk] = f.y;
            }
        }
        drive_codes<8>(v, sv, rv, q);
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) x[h][kk] = __fmaf_rn(q[4 * h + kk], s[h], 0.f);
    }
}

// Pass 1 of the psram variant on the ring: partial[split, i, r] over the
// split's stages, `FRONT` the staging; I is the unfolding's rows (Rw). Each
// thread loads and quantizes two rows of every stage (stage_x4), in
// registers, so each staged value is quantized once; the two threads of a
// pair (lanes 2p, 2p + 1) swap their values by one shuffle, and each owns
// the pair's four rows x its half of the 32 ranks:
// acc[m][c] = fmaf(x[m][kk], kr[kk][16 par + c], acc[m][c]) for kk in
// column order, the KR row read from shared memory (two addresses a warp).
template <int FRONT>
__global__ void __launch_bounds__(X_THREADS, X_CTAS_PER_SM)
mttkrp_psram_ring_kernel(const __grid_constant__ CUtensorMap xmap, const float* __restrict__ sx,
                         const int8_t* __restrict__ qb, const float* __restrict__ sb,
                         const int8_t* __restrict__ qc, const float* __restrict__ sc,
                         float* __restrict__ partials, int I, int K, int R, long long P, int cpp,
                         int n_stages, int chunks_per_split) {
    using L = QRing<FRONT>;
    constexpr int HALF = TR / 2;     // ranks a thread
    extern __shared__ uint8_t smem_raw[];
    uint8_t* stages = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
    float (*ks)[TK][TR] = reinterpret_cast<float (*)[TK][TR]>(stages + X_STAGES * L::STAGE);
    const uint32_t st_s = smem_u32(stages);
    const uint32_t bars = smem_u32(ks) + 2 * TK * TR * 4;

    const int tid = threadIdx.x;
    const int par = tid & 1;          // the pair's rank half
    const int i0 = blockIdx.x * XI;
    const int r0 = blockIdx.y * TR;
    const int t_begin = blockIdx.z * chunks_per_split;
    const int n = min(n_stages, t_begin + chunks_per_split) - t_begin;
    // the thread's rows and their scales (rows past I: zero-filled, scale
    // 1); rows[2 + h] are the partner's, whose values the shuffle brings
    int rows[4];
    float s[2], rs[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        rows[h] = i0 + (FRONT == FRONT_COLS ? 2 * tid + h : tid + 128 * h);
        rows[2 + h] = rows[h] ^ (FRONT == FRONT_COLS ? 2 : 1);
        s[h] = rows[h] < I ? __ldg(sx + rows[h]) : 1.f;
        rs[h] = __frcp_rn(s[h]);
    }

    if (tid == 0) {
        for (int st = 0; st < X_STAGES; ++st) mbar_init(bars + 8 * st, 1);
        mbar_init_fence();
    }
    __syncthreads();
    const uint64_t policy = evict_first_policy();
    if (tid == 0) {
        for (int st = 0; st < min(X_STAGES, n); ++st) {
            load_stage<FRONT>(st_s + st * L::STAGE, &xmap, bars + 8 * st, t_begin + st, cpp, i0,
                              policy);
        }
    }

    // the walk of the stage whose KR tile is in `kr`
    StageWalk walk;
    walk.start(t_begin, cpp, P, K);
    float kr[KR_PER_THREAD];
    kr_stage_q(kr, qb, sb, qc, sc, walk.j, walk.k, walk.col, walk.lim, r0, K, R, tid);
#pragma unroll
    for (int u = 0; u < KR_PER_THREAD; ++u) ks[0][4 * u + (tid >> 5)][tid & 31] = kr[u];
    if (n > 1) {
        walk.next(cpp, P, K);
        kr_stage_q(kr, qb, sb, qc, sc, walk.j, walk.k, walk.col, walk.lim, r0, K, R, tid);
    }
    __syncthreads();                  // KR tile 0 is published

    float acc[4][HALF];
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int c = 0; c < HALF; ++c) acc[m][c] = 0.f;

    for (int u = 0; u < n; ++u) {
        const int st = u % X_STAGES;
        const int buf = u & 1;
        const uint8_t* stage = stages + st * L::STAGE;
        mbar_wait(bars + 8 * st, (u / X_STAGES) & 1);
        int4 w[2][2];                 // the codes front end: the two rows' 32 codes
        if constexpr (FRONT == FRONT_CODES) {
#pragma unroll
            for (int h = 0; h < 2; ++h)
#pragma unroll
                for (int half = 0; half < 2; ++half) {
                    w[h][half] = *reinterpret_cast<const int4*>(stage + (tid + 128 * h) * TK + 16 * half);
                }
        }
#pragma unroll
        for (int k4 = 0; k4 < TK / 4; ++k4) {
            float x[4][4];
            stage_x4<FRONT>(x, stage, w, k4, tid, s, rs);
#pragma unroll
            for (int h = 0; h < 2; ++h)
#pragma unroll
                for (int kk = 0; kk < 4; ++kk) x[2 + h][kk] = __shfl_xor_sync(0xffffffffu, x[h][kk], 1);
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
                const float* krow = ks[buf][4 * k4 + kk] + HALF * par;
#pragma unroll
                for (int c4 = 0; c4 < HALF / 4; ++c4) {
                    const float4 k = *reinterpret_cast<const float4*>(krow + 4 * c4);
#pragma unroll
                    for (int m = 0; m < 4; ++m) {
                        acc[m][4 * c4] = fmaf(x[m][kk], k.x, acc[m][4 * c4]);
                        acc[m][4 * c4 + 1] = fmaf(x[m][kk], k.y, acc[m][4 * c4 + 1]);
                        acc[m][4 * c4 + 2] = fmaf(x[m][kk], k.z, acc[m][4 * c4 + 2]);
                        acc[m][4 * c4 + 3] = fmaf(x[m][kk], k.w, acc[m][4 * c4 + 3]);
                    }
                }
            }
        }
        if (u + 1 < n) {
#pragma unroll
            for (int v = 0; v < KR_PER_THREAD; ++v) ks[buf ^ 1][4 * v + (tid >> 5)][tid & 31] = kr[v];
        }
        __syncthreads();              // stage st and KR tile buf are consumed
        if (tid == 0 && u + X_STAGES < n) {
            load_stage<FRONT>(st_s + st * L::STAGE, &xmap, bars + 8 * st, t_begin + u + X_STAGES,
                              cpp, i0, policy);
        }
        if (u + 2 < n) {
            walk.next(cpp, P, K);
            kr_stage_q(kr, qb, sb, qc, sc, walk.j, walk.k, walk.col, walk.lim, r0, K, R, tid);
        }
    }

    float* dst = partials + static_cast<size_t>(blockIdx.z) * I * R;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
        if (rows[m] >= I) continue;
#pragma unroll
        for (int c = 0; c < HALF; ++c) {
            const int r = r0 + HALF * par + c;
            if (r < R) dst[static_cast<size_t>(rows[m]) * R + r] = acc[m][c];
        }
    }
}

template <int FRONT>
cudaError_t launch_ring(const CUtensorMap& xmap, const float* sx, const int8_t* qb, const float* sb,
                        const int8_t* qc, const float* sc, float* partials, int I, int K, int R,
                        long long P, int cpp, int n_stages, int chunks_per_split, int splits,
                        cudaStream_t stream) {
    const cudaError_t err = cudaFuncSetAttribute(
        mttkrp_psram_ring_kernel<FRONT>, cudaFuncAttributeMaxDynamicSharedMemorySize, QRing<FRONT>::SMEM);
    if (err != cudaSuccess) return err;
    const dim3 grid((I + XI - 1) / XI, (R + TR - 1) / TR, splits);
    mttkrp_psram_ring_kernel<FRONT><<<grid, X_THREADS, QRing<FRONT>::SMEM, stream>>>(
        xmap, sx, qb, sb, qc, sc, partials, I, K, R, P, cpp, n_stages, chunks_per_split);
    return cudaGetLastError();
}

template <bool QUANT, bool VEC>
cudaError_t launch_partials(const void* x, const float* sx, const void* b, const float* sb,
                            const void* c, const float* sc, float* partials, int I, int K, int R,
                            long long JK, int n_chunks, int chunks_per_split, int splits,
                            cudaStream_t stream) {
    const dim3 grid((I + TI - 1) / TI, (R + TR - 1) / TR, splits);
    mttkrp_partials_kernel<QUANT, VEC><<<grid, THREADS, 0, stream>>>(
        x, sx, b, sb, c, sc, partials, I, K, R, JK, n_chunks, chunks_per_split);
    return cudaGetLastError();
}

// Shapes the launch entries accept: the splits must cover the stages exactly.
bool bad_shape(int I, int J, int K, int R, int splits, int chunks_per_split) {
    if (I < 1 || J < 1 || K < 1 || R < 1 || splits < 1 || chunks_per_split < 1) return true;
    const long long n_chunks = (static_cast<long long>(J) * K + TK - 1) / TK;
    if (n_chunks >= (1ll << 31)) return true;
    return static_cast<long long>(splits - 1) * chunks_per_split >= n_chunks ||
           static_cast<long long>(splits) * chunks_per_split < n_chunks || splits > 65535;
}

}  // namespace

// Exact variant. x0 (I, J*K) f32 row-major, b (J, R), c (K, R) f32, partials
// (splits, I, R) f32 scratch, out (I, R) f32. `vec` = 1 when every row of x0
// starts on a 16-byte boundary (J*K % 4 == 0, J*K < 2^31 and an aligned
// base): the TMA ring kernel, 256-row CTA tiles; else element-wise loads,
// 128-row tiles. Returns the first failing cudaError_t as an int (0 =
// launched).
extern "C" int mttkrp_fused_launch(const void* x0, const void* b, const void* c, void* partials,
                                   void* out, int I, int J, int K, int R, int splits,
                                   int chunks_per_split, int vec, void* stream_ptr) {
    if (bad_shape(I, J, K, R, splits, chunks_per_split)) return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    const long long JK = static_cast<long long>(J) * K;
    const int n_chunks = static_cast<int>((JK + TK - 1) / TK);
    cudaError_t err;
    if (vec) {
        if (JK >= (1ll << 31)) return static_cast<int>(cudaErrorInvalidValue);
        CUtensorMap xmap;
        const cuuint64_t dims[2] = {static_cast<cuuint64_t>(JK), static_cast<cuuint64_t>(I)};
        const cuuint32_t box[2] = {TK, XI};
        if (!encode_map(&xmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, 2, x0, dims, box)) {
            return static_cast<int>(cudaErrorInvalidValue);
        }
        err = cudaFuncSetAttribute(mttkrp_ring_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   X_SMEM);
        if (err != cudaSuccess) return static_cast<int>(err);
        const dim3 grid((I + XI - 1) / XI, (R + TR - 1) / TR, splits);
        mttkrp_ring_kernel<<<grid, X_THREADS, X_SMEM, stream>>>(
            xmap, static_cast<const float*>(b), static_cast<const float*>(c),
            static_cast<float*>(partials), I, K, R, JK, n_chunks, chunks_per_split);
        err = cudaGetLastError();
    } else {
        err = launch_partials<false, false>(x0, nullptr, b, nullptr, c, nullptr,
                                            static_cast<float*>(partials), I, K, R, JK, n_chunks,
                                            chunks_per_split, splits, stream);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long n_values = static_cast<long long>(I) * R;
    mttkrp_sum_kernel<<<static_cast<unsigned int>((n_values + 255) / 256), 256, 0, stream>>>(
        static_cast<const float*>(partials), static_cast<float*>(out), n_values, splits);
    return static_cast<int>(cudaGetLastError());
}

// psram variant. qx0 (I, J*K) int8, sx (I, 1), qb (J, R) int8, sb (J, 1),
// qc (K, R) int8, sc (K, 1) f32; partials (splits, I, R) f32 scratch; out
// (I, R) f32 digitised per `bi`-row tile (I % bi == 0). `vec` = 1 when every
// row of qx0 starts on a 16-byte boundary (J*K % 16 == 0 and an aligned base).
extern "C" int mttkrp_psram_launch(const void* qx0, const void* sx, const void* qb, const void* sb,
                                   const void* qc, const void* sc, void* partials, void* out,
                                   int I, int J, int K, int R, int splits, int chunks_per_split,
                                   int vec, int bi, float levels, float code_max,
                                   void* stream_ptr) {
    if (bad_shape(I, J, K, R, splits, chunks_per_split) || bi < 1 || I % bi != 0 ||
        static_cast<long long>(bi) * R >= (1ll << 31)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    const long long JK = static_cast<long long>(J) * K;
    const int n_chunks = static_cast<int>((JK + TK - 1) / TK);
    cudaError_t err = (vec ? launch_partials<true, true> : launch_partials<true, false>)(
        qx0, static_cast<const float*>(sx), qb, static_cast<const float*>(sb), qc,
        static_cast<const float*>(sc), static_cast<float*>(partials), I, K, R, JK, n_chunks,
        chunks_per_split, splits, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long n_values = static_cast<long long>(I) * R;
    mttkrp_adc_kernel<<<I / bi, ADC_THREADS, 0, stream>>>(
        static_cast<const float*>(partials), static_cast<float*>(out), n_values, splits, bi * R,
        levels, code_max);
    return static_cast<int>(cudaGetLastError());
}

// Row maxima of |x| over the rows of the (A, Rw, B) view of x (f32, 16-byte
// aligned; B % 4 == 0 where B > 1, Rw % 4 == 0 where B == 1) into amax (Rw)
// as f32 bit patterns, zeroed first; each CTA scans about 1/(16 sms) of the
// tensor. Returns the first failing cudaError_t as an int (0 = launched).
extern "C" int mttkrp_rowmax_launch(const void* x, void* amax, long long A, int Rw, long long B,
                                    int sms, void* stream_ptr) {
    if (A < 1 || Rw < 1 || B < 1 || sms < 1 || (B > 1 && B % 4 != 0) || (B == 1 && Rw % 4 != 0)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    cudaError_t err = cudaMemsetAsync(amax, 0, static_cast<size_t>(Rw) * 4, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long per_cta = std::max(65536ll, A * Rw * B / (16ll * sms));   // values a CTA scans
    unsigned* out = static_cast<unsigned*>(amax);
    if (B > 1) {
        constexpr long long STEP = 4 * AMAX_THREADS;
        const long long AB = A * B;
        long long span = (std::min(AB, per_cta) + STEP - 1) / STEP * STEP;
        if ((AB + span - 1) / span > 65535) span = ((AB + 65534) / 65535 + STEP - 1) / STEP * STEP;
        const dim3 grid(Rw, static_cast<unsigned>((AB + span - 1) / span));
        const long long step_a = STEP / B;
        const long long step_b = STEP % B;
        mttkrp_rowmax_rows_kernel<<<grid, AMAX_THREADS, 0, stream>>>(
            static_cast<const float*>(x), out, Rw, B, AB, span, step_b, step_a * Rw * B + step_b,
            (static_cast<long long>(Rw) - 1) * B);
    } else {
        const int rows = 4 * 64;
        const long long tiles = (Rw + rows - 1) / rows;
        long long span = std::max(1ll, per_cta / rows);
        if ((A + span - 1) / span > 65535) span = (A + 65534) / 65535;
        const dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>((A + span - 1) / span));
        mttkrp_rowmax_cols_kernel<<<grid, AMAX_THREADS, 0, stream>>>(static_cast<const float*>(x), out,
                                                                    A, Rw, span);
    }
    return static_cast<int>(cudaGetLastError());
}

// psram variant on the TMA ring. front 0 ("rows", B > 1) and 1 ("cols",
// B == 1): x is the f32 (A, Rw, B) view, read in place and drive-quantized
// against the row scales sx (Rw, 1); front 2 ("codes"): x is the int8
// unfolding qx0 (Rw, B) with its scales sx, A == 1. qb (J, R) int8, sb (J, 1),
// qc (K, R) int8, sc (K, 1) f32 with J * K == A * B; partials (splits, Rw, R)
// f32 scratch; out (Rw, R) f32 digitised per `bi`-row tile (Rw % bi == 0).
// The splits must cover the walk's stages exactly: A * ceil(B / 32) for
// "rows", ceil(A * B / 32) otherwise.
extern "C" int mttkrp_psram_ring_launch(const void* x, const void* sx, const void* qb,
                                        const void* sb, const void* qc, const void* sc,
                                        void* partials, void* out, int front, long long A, int Rw,
                                        long long B, int K, int R, int splits,
                                        int chunks_per_split, int bi, float levels, float code_max,
                                        void* stream_ptr) {
    const cudaError_t bad = cudaErrorInvalidValue;
    if (front < FRONT_ROWS || front > FRONT_CODES || A < 1 || Rw < 1 || B < 1 || K < 1 || R < 1 ||
        splits < 1 || splits > 65535 || chunks_per_split < 1 || bi < 1 || Rw % bi != 0 ||
        static_cast<long long>(bi) * R >= (1ll << 31) || A >= (1ll << 31) || B >= (1ll << 31)) {
        return static_cast<int>(bad);
    }
    const long long JK = A * B;
    if (JK >= (1ll << 31) || JK % K != 0 || (front == FRONT_COLS && B != 1) ||
        (front == FRONT_CODES && A != 1)) {
        return static_cast<int>(bad);
    }
    const long long P = front == FRONT_ROWS ? B : JK;        // columns of a piece
    const long long cpp = (P + TK - 1) / TK;                  // stages of a piece
    const long long n_stages = JK / P * cpp;
    if (n_stages >= (1ll << 31) || static_cast<long long>(splits - 1) * chunks_per_split >= n_stages ||
        static_cast<long long>(splits) * chunks_per_split < n_stages) {
        return static_cast<int>(bad);
    }
    CUtensorMap xmap;
    bool ok;
    if (front == FRONT_ROWS) {
        const cuuint64_t dims[3] = {static_cast<cuuint64_t>(B), static_cast<cuuint64_t>(Rw),
                                    static_cast<cuuint64_t>(A)};
        const cuuint32_t box[3] = {TK, XI, 1};
        ok = encode_map(&xmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, 3, x, dims, box);
    } else if (front == FRONT_COLS) {
        const cuuint64_t dims[2] = {static_cast<cuuint64_t>(Rw), static_cast<cuuint64_t>(A)};
        const cuuint32_t box[2] = {XI, TK};
        ok = encode_map(&xmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, 2, x, dims, box,
                        CU_TENSOR_MAP_SWIZZLE_NONE);
    } else {
        const cuuint64_t dims[2] = {static_cast<cuuint64_t>(B), static_cast<cuuint64_t>(Rw)};
        const cuuint32_t box[2] = {TK, XI};
        ok = encode_map(&xmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, 2, x, dims, box,
                        CU_TENSOR_MAP_SWIZZLE_NONE);
    }
    if (!ok) return static_cast<int>(bad);
    cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    const auto* fsx = static_cast<const float*>(sx);
    const auto* iqb = static_cast<const int8_t*>(qb);
    const auto* fsb = static_cast<const float*>(sb);
    const auto* iqc = static_cast<const int8_t*>(qc);
    const auto* fsc = static_cast<const float*>(sc);
    auto* fpart = static_cast<float*>(partials);
    const int ncpp = static_cast<int>(cpp);
    const int nst = static_cast<int>(n_stages);
    cudaError_t err;
    if (front == FRONT_ROWS) {
        err = launch_ring<FRONT_ROWS>(xmap, fsx, iqb, fsb, iqc, fsc, fpart, Rw, K, R, P, ncpp, nst,
                                      chunks_per_split, splits, stream);
    } else if (front == FRONT_COLS) {
        err = launch_ring<FRONT_COLS>(xmap, fsx, iqb, fsb, iqc, fsc, fpart, Rw, K, R, P, ncpp, nst,
                                      chunks_per_split, splits, stream);
    } else {
        err = launch_ring<FRONT_CODES>(xmap, fsx, iqb, fsb, iqc, fsc, fpart, Rw, K, R, P, ncpp, nst,
                                       chunks_per_split, splits, stream);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long n_values = static_cast<long long>(Rw) * R;
    mttkrp_adc_kernel<<<Rw / bi, ADC_THREADS, 0, stream>>>(fpart, static_cast<float*>(out), n_values,
                                                           splits, bi * R, levels, code_max);
    return static_cast<int>(cudaGetLastError());
}

// The checks' entry: codes (Rw, A * B) int8 = the codes the f32 front ends
// compute for the (A, Rw, B) view of x against the row scales sx (Rw, 1).
extern "C" int mttkrp_drive_codes_launch(const void* x, const void* sx, void* codes, long long A,
                                         int Rw, long long B, void* stream_ptr) {
    if (A < 1 || Rw < 1 || B < 1) return static_cast<int>(cudaErrorInvalidValue);
    const long long n = A * Rw * B;
    const unsigned blocks = static_cast<unsigned>(std::min((n + 255) / 256, 132ll * 64));
    mttkrp_drive_codes_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream_ptr)>>>(
        static_cast<const float*>(x), static_cast<const float*>(sx), static_cast<int8_t*>(codes), A,
        Rw, B);
    return static_cast<int>(cudaGetLastError());
}

// The TMA ring kernels' CTA tile rows and CTAs a SM (the exact ring's and
// the psram ring's), from which the caller plans the split of the
// contraction into one wave.
extern "C" void mttkrp_ring_shape(int* rows, int* ctas_per_sm) {
    *rows = XI;
    *ctas_per_sm = X_CTAS_PER_SM;
}

// The runtime's text for an error code returned by a launch entry.
extern "C" const char* mttkrp_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}
