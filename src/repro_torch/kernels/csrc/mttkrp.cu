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
//   - The int8 variant, and the exact one on rows that are not 16-byte
//     aligned, run mttkrp_partials_kernel: 128 x 32 X tiles loaded into
//     registers one stage ahead and stored to shared memory (as f32, scaled,
//     for int8), each thread accumulating an 8-row x 4-column block (two
//     shared-memory buffers, one barrier per stage).
//
// What bounds it: at CP-ALS shapes (R = 32) the exact variant reads X_(0)
// once, 4 bytes per entry, for 2R = 64 flops per entry: bytes and f32 FMA
// throughput are close (3.62 GB at 3.35 TB/s vs 5.8e10 flops at 67 TFLOP/s).
// The int8 variant reads a quarter of the bytes and is bound by the f32
// operations. The design reads X_(0) exactly once, coalesced (16-byte loads
// where the row length allows), streaming past L2 so the factors stay there.
//
// Arithmetic contract: IEEE f32 throughout (fmaf, no TF32, no tensor cores);
// the KR tile is rounded to f32 before its product with x, as on the TPU; the
// ADC epilogue is rintf of a true division, clamped to +-(levels/2 - 1), the
// arithmetic of csrc/psram_matmul.cu. Built without --use_fast_math.

#include <cuda_runtime.h>
#include <stdint.h>

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

// The TMA ring kernel's CTA tile rows and CTAs a SM, from which the caller
// plans the split of the contraction into one wave.
extern "C" void mttkrp_ring_shape(int* rows, int* ctas_per_sm) {
    *rows = XI;
    *ctas_per_sm = X_CTAS_PER_SM;
}

// The runtime's text for an error code returned by a launch entry.
extern "C" const char* mttkrp_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}
