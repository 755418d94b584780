// Flash attention (online softmax, GQA, causal, logit softcap) for Hopper
// (sm_90a): out = softmax(softcap(q k^T * scale) + causal mask) v.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:_kernel
// (launched by flash_attention at :74, pallas_call at :103). The TPU grid
// (B*H, Sq/bq, Skv/bkv) walks kv blocks in order on one core and carries the
// running max, denominator and accumulator across grid steps in VMEM; here
// one CTA owns a (batch*head, q tile) pair, the kv axis is a loop inside it,
// and those three stay in registers for the whole walk. Tiles wholly above
// the causal diagonal are never loaded (the loop stops at the diagonal), and
// the q tiles are handed out heaviest first so the last wave is short.
//
// Semantics kept from the reference (and its plain version in
// kernels/flash_attention.py): s = dot(q, k) * scale; then
// tanh(s / softcap) * softcap when softcap > 0; then the causal mask
// row >= col applied as -1e30 (not -inf), top-left aligned; online max, sum
// and accumulator in f32; out = acc / max(l, 1e-30) rounded once to q's
// dtype. The kv head of flat head bh is (bh / H) * Hkv + (bh % H) / (H / Hkv).
// expf, tanhf and the divisions are the accurate ones (no --use_fast_math).
//
// What bounds it: operations. A causal prefill at 32k tokens and D = 128 does
// 4 * D operations per unmasked (query, key) pair against 4 * D bytes per
// token of q, k, v and out, far above the card's byte/operation balance.
//
// Two kernels:
//
// * bf16 (the serving path's type): the products run on the tensor cores
//   through warp-level mma.sync m16n8k16 with f32 accumulation. A CTA is 4
//   warps over a 64-row q tile (16 rows a warp, q fragments held in
//   registers); each 64-key tile of K and V is staged in shared memory by
//   cp.async, the next tile's K load overlapping this tile's softmax and PV
//   product, and V's next load the next tile's QK^T. Q K^T: products of two
//   bf16 values are exact in f32, so the tensor cores compute the same sums
//   as f32 FMAs up to order. P V: the reference keeps P in f32; a bf16 P
//   would cost 2^-9 relative per weight. Here P is split into two bf16 terms
//   (hi = bf16(p), lo = bf16(p - hi)) and both are multiplied into the f32
//   accumulator, which keeps every weight to 2^-17 relative (V is bf16 and
//   exact). The accumulator fragments of Q K^T are the A fragments of P V,
//   so P never leaves registers; V's B fragments come from ldmatrix.trans.
// * f32: IEEE f32 FMAs on the CUDA cores, no TF32. A CTA is 128 threads
//   over a 32-row q tile, 4 threads per row, each holding a quarter of the
//   row's q and accumulator (dims sub, sub + 4, ...); a score is the
//   quarter-sums added by a butterfly, so the four threads agree bit for bit.
//
// Row strides in shared memory are padded (D + 8 bf16) so that the 8 rows x
// 4 words of a fragment load, and the 8 rows of an ldmatrix phase, fall in 32
// different banks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG = -1e30f;

__device__ __forceinline__ float score(float dot, float scale, float softcap, bool masked) {
    float s = __fmul_rn(dot, scale);
    if (softcap > 0.f) s = __fmul_rn(tanhf(__fdiv_rn(s, softcap)), softcap);
    return masked ? NEG : s;
}

// ------------------------------------------------------------------ bf16 ---

constexpr int BQ = 64;            // q rows per CTA: 4 warps x 16
constexpr int BKV = 64;           // keys per shared-memory tile
constexpr int THREADS = 128;

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* smem) {
    const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr));
}

// 16 bytes global -> shared; src_bytes = 0 fills the 16 bytes with zeros.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
    const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
    const int n = valid ? 16 : 0;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// two bf16 values as one 32-bit fragment register, the first in the low half
__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 first, __nv_bfloat16 second) {
    return static_cast<uint32_t>(__bfloat16_as_ushort(first)) |
           (static_cast<uint32_t>(__bfloat16_as_ushort(second)) << 16);
}

__device__ __forceinline__ uint32_t pack_bf16(float first, float second) {
    return pack2(__float2bfloat16_rn(first), __float2bfloat16_rn(second));
}

// rows [r0, r0 + 64) of a (rows, D) bf16 matrix into a padded shared tile;
// rows at or past n_rows read as zeros
template <int D, int STRIDE>
__device__ __forceinline__ void load_tile(__nv_bfloat16 (*tile)[STRIDE],
                                          const __nv_bfloat16* __restrict__ base, int r0,
                                          int n_rows, int tid) {
    constexpr int CHUNKS = D / 8;                 // 16-byte chunks per row
#pragma unroll
    for (int it = 0; it < (BKV * CHUNKS) / THREADS; ++it) {
        const int c = tid + it * THREADS;
        const int row = c / CHUNKS;
        const int col = (c % CHUNKS) * 8;
        const bool valid = r0 + row < n_rows;
        const __nv_bfloat16* src = base + (valid ? static_cast<size_t>(r0 + row) * D + col : 0);
        cp_async16(&tile[row][col], src, valid);
    }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out, int H,
                  int Hkv, int Sq, int Skv, float scale, float softcap, int causal) {
    constexpr int STRIDE = D + 8;
    static_assert(D % 16 == 0 && (BKV * (D / 8)) % THREADS == 0, "D must be a multiple of 16");
    __shared__ __align__(16) __nv_bfloat16 Ks[BKV][STRIDE];
    __shared__ __align__(16) __nv_bfloat16 Vs[BKV][STRIDE];

    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int g = lane >> 2;          // fragment row group
    const int tig = lane & 3;         // thread in group
    const int qt = gridDim.x - 1 - blockIdx.x;    // heaviest (last) q tiles first
    const int q0 = qt * BQ;
    const int bh = blockIdx.y;
    const int kvh = (bh / H) * Hkv + (bh % H) / (H / Hkv);
    const __nv_bfloat16* qb = q + static_cast<size_t>(bh) * Sq * D;
    const __nv_bfloat16* kb = k + static_cast<size_t>(kvh) * Skv * D;
    const __nv_bfloat16* vb = v + static_cast<size_t>(kvh) * Skv * D;

    int n_tiles = (Skv + BKV - 1) / BKV;
    if (causal) n_tiles = min(n_tiles, (min(q0 + BQ, Sq) - 1) / BKV + 1);

    // Q staged through Vs, K tile 0 into Ks: one group
    load_tile<D, STRIDE>(Vs, qb, q0, Sq, tid);
    load_tile<D, STRIDE>(Ks, kb, 0, Skv, tid);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    uint32_t qf[D / 16][4];
    const int wr = warp * 16 + g;     // the warp's fragment rows wr, wr + 8
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
        const int c = kk * 16 + tig * 2;
        qf[kk][0] = *reinterpret_cast<const uint32_t*>(&Vs[wr][c]);
        qf[kk][1] = *reinterpret_cast<const uint32_t*>(&Vs[wr + 8][c]);
        qf[kk][2] = *reinterpret_cast<const uint32_t*>(&Vs[wr][c + 8]);
        qf[kk][3] = *reinterpret_cast<const uint32_t*>(&Vs[wr + 8][c + 8]);
    }
    __syncthreads();
    load_tile<D, STRIDE>(Vs, vb, 0, Skv, tid);
    cp_async_commit();

    const int row0 = q0 + wr;         // global rows of c0,c1 and of c2,c3
    const int row1 = row0 + 8;
    float o[D / 8][4];
#pragma unroll
    for (int i = 0; i < D / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
    float m0 = NEG, m1 = NEG, l0 = 0.f, l1 = 0.f;

    for (int t = 0; t < n_tiles; ++t) {
        const int kv0 = t * BKV;
        const bool more = t + 1 < n_tiles;
        cp_async_wait<1>();           // K tile t has landed (V tile t may be in flight)
        __syncthreads();

        float s[BKV / 8][4];
#pragma unroll
        for (int nt = 0; nt < BKV / 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
            for (int nt = 0; nt < BKV / 8; ++nt) {
                const __nv_bfloat16* kr = &Ks[nt * 8 + g][kk * 16 + tig * 2];
                mma_bf16(s[nt], qf[kk], *reinterpret_cast<const uint32_t*>(kr),
                         *reinterpret_cast<const uint32_t*>(kr + 8));
            }
        }
        __syncthreads();              // every warp is done with Ks
        if (more) {
            load_tile<D, STRIDE>(Ks, kb, kv0 + BKV, Skv, tid);
            cp_async_commit();
        }

        // scores, masks and the online softmax (rows row0 and row1)
        float mx0 = NEG, mx1 = NEG;
#pragma unroll
        for (int nt = 0; nt < BKV / 8; ++nt) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const int col = kv0 + nt * 8 + tig * 2 + e;
                const bool out_col = col >= Skv;
                s[nt][e] = score(s[nt][e], scale, softcap, out_col || (causal && col > row0));
                s[nt][2 + e] = score(s[nt][2 + e], scale, softcap, out_col || (causal && col > row1));
                mx0 = fmaxf(mx0, s[nt][e]);
                mx1 = fmaxf(mx1, s[nt][2 + e]);
            }
        }
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
            mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
            mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
        }
        const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
        const float alpha0 = expf(m0 - mn0), alpha1 = expf(m1 - mn1);
        float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
        for (int nt = 0; nt < BKV / 8; ++nt) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                s[nt][e] = expf(s[nt][e] - mn0);
                s[nt][2 + e] = expf(s[nt][2 + e] - mn1);
                sum0 += s[nt][e];
                sum1 += s[nt][2 + e];
            }
        }
        l0 = l0 * alpha0 + sum0;      // this thread's share of the row sums
        l1 = l1 * alpha1 + sum1;
        m0 = mn0;
        m1 = mn1;
#pragma unroll
        for (int i = 0; i < D / 8; ++i) {
            o[i][0] *= alpha0;
            o[i][1] *= alpha0;
            o[i][2] *= alpha1;
            o[i][3] *= alpha1;
        }

        if (more) {
            cp_async_wait<1>();       // V tile t has landed (K tile t+1 may be in flight)
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();

        // P V over four 16-key steps; P as hi + lo bf16 A fragments
#pragma unroll
        for (int j = 0; j < BKV / 16; ++j) {
            // reg order of an A fragment: (row g, keys 2tig..), (row g+8, keys
            // 2tig..), (row g, keys 8+2tig..), (row g+8, keys 8+2tig..) — the
            // C fragments of n-tiles 2j and 2j+1 as they lie
            uint32_t ph[4], pl[4];
#pragma unroll
            for (int r = 0; r < 4; ++r) {
                const float x0 = s[2 * j + (r >> 1)][(r & 1) * 2];
                const float x1 = s[2 * j + (r >> 1)][(r & 1) * 2 + 1];
                const __nv_bfloat16 h0 = __float2bfloat16_rn(x0), h1 = __float2bfloat16_rn(x1);
                ph[r] = pack2(h0, h1);
                pl[r] = pack_bf16(x0 - __bfloat162float(h0), x1 - __bfloat162float(h1));
            }
            const int mat = lane >> 3;
            const int vrow = j * 16 + (mat & 1) * 8 + (lane & 7);
#pragma unroll
            for (int dt = 0; dt < D / 8; dt += 2) {
                uint32_t vb4[4];
                ldmatrix_x4_trans(vb4, &Vs[vrow][(dt + (mat >> 1)) * 8]);
                mma_bf16(o[dt], ph, vb4[0], vb4[1]);
                mma_bf16(o[dt], pl, vb4[0], vb4[1]);
                mma_bf16(o[dt + 1], ph, vb4[2], vb4[3]);
                mma_bf16(o[dt + 1], pl, vb4[2], vb4[3]);
            }
        }
        __syncthreads();              // every warp is done with Vs
        if (more) {
            load_tile<D, STRIDE>(Vs, vb, kv0 + BKV, Skv, tid);
            cp_async_commit();
        }
    }

#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
        l0 += __shfl_xor_sync(0xffffffffu, l0, off);
        l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
    __nv_bfloat16* ob = out + static_cast<size_t>(bh) * Sq * D;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
        const int c = i * 8 + tig * 2;
        if (row0 < Sq) {
            *reinterpret_cast<uint32_t*>(&ob[static_cast<size_t>(row0) * D + c]) =
                pack_bf16(__fdiv_rn(o[i][0], d0), __fdiv_rn(o[i][1], d0));
        }
        if (row1 < Sq) {
            *reinterpret_cast<uint32_t*>(&ob[static_cast<size_t>(row1) * D + c]) =
                pack_bf16(__fdiv_rn(o[i][2], d1), __fdiv_rn(o[i][3], d1));
        }
    }
}

// ------------------------------------------------------------------- f32 ---

constexpr int FQ = 32;            // q rows per CTA (4 threads a row)
constexpr int FKV = 32;           // keys per shared-memory tile

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out, int H, int Hkv, int Sq,
                 int Skv, float scale, float softcap, int causal) {
    constexpr int NV = D / 4;         // dims a thread holds: sub, sub + 4, ...
    __shared__ __align__(16) float Ks[FKV][D];
    __shared__ __align__(16) float Vs[FKV][D];

    const int tid = threadIdx.x;
    const int sub = tid & 3;
    const int qt = gridDim.x - 1 - blockIdx.x;
    const int q0 = qt * FQ;
    const int row = q0 + (tid >> 2);
    const int bh = blockIdx.y;
    const int kvh = (bh / H) * Hkv + (bh % H) / (H / Hkv);
    const float* kb = k + static_cast<size_t>(kvh) * Skv * D;
    const float* vb = v + static_cast<size_t>(kvh) * Skv * D;

    float qr[NV], acc[NV];
#pragma unroll
    for (int i = 0; i < NV; ++i) {
        qr[i] = row < Sq ? q[(static_cast<size_t>(bh) * Sq + row) * D + sub + 4 * i] : 0.f;
        acc[i] = 0.f;
    }
    float m = NEG, l = 0.f;
    int n_tiles = (Skv + FKV - 1) / FKV;
    if (causal) n_tiles = min(n_tiles, (min(q0 + FQ, Sq) - 1) / FKV + 1);

    for (int t = 0; t < n_tiles; ++t) {
        const int kv0 = t * FKV;
        __syncthreads();              // the previous tile is consumed
#pragma unroll
        for (int it = 0; it < (FKV * D / 4) / THREADS; ++it) {
            const int c = tid + it * THREADS;
            const int r = c / (D / 4);
            const int col = (c % (D / 4)) * 4;
            float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
            if (kv0 + r < Skv) {
                kv = *reinterpret_cast<const float4*>(kb + static_cast<size_t>(kv0 + r) * D + col);
                vv = *reinterpret_cast<const float4*>(vb + static_cast<size_t>(kv0 + r) * D + col);
            }
            *reinterpret_cast<float4*>(&Ks[r][col]) = kv;
            *reinterpret_cast<float4*>(&Vs[r][col]) = vv;
        }
        __syncthreads();

        float s[FKV];
        float mx = NEG;
#pragma unroll
        for (int c = 0; c < FKV; ++c) {
            float part = 0.f;
#pragma unroll
            for (int i = 0; i < NV; ++i) part = fmaf(qr[i], Ks[c][sub + 4 * i], part);
            part += __shfl_xor_sync(0xffffffffu, part, 1);
            part += __shfl_xor_sync(0xffffffffu, part, 2);
            const int col = kv0 + c;
            s[c] = score(part, scale, softcap, col >= Skv || (causal && col > row));
            mx = fmaxf(mx, s[c]);
        }
        const float mn = fmaxf(m, mx);
        const float alpha = expf(m - mn);
        float sum = 0.f;
#pragma unroll
        for (int c = 0; c < FKV; ++c) {
            s[c] = expf(s[c] - mn);
            sum += s[c];
        }
        l = l * alpha + sum;
        m = mn;
#pragma unroll
        for (int i = 0; i < NV; ++i) acc[i] *= alpha;
#pragma unroll
        for (int c = 0; c < FKV; ++c) {
#pragma unroll
            for (int i = 0; i < NV; ++i) acc[i] = fmaf(s[c], Vs[c][sub + 4 * i], acc[i]);
        }
    }

    if (row < Sq) {
        const float d = fmaxf(l, 1e-30f);
        float* orow = out + (static_cast<size_t>(bh) * Sq + row) * D;
#pragma unroll
        for (int i = 0; i < NV; ++i) orow[sub + 4 * i] = __fdiv_rn(acc[i], d);
    }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int B, int H,
                   int Hkv, int Sq, int Skv, int bf16, float scale, float softcap, int causal,
                   cudaStream_t stream) {
    if (bf16) {
        dim3 grid((Sq + BQ - 1) / BQ, B * H);
        flash_bf16_kernel<D><<<grid, THREADS, 0, stream>>>(
            static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
            static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), H, Hkv, Sq,
            Skv, scale, softcap, causal);
    } else {
        dim3 grid((Sq + FQ - 1) / FQ, B * H);
        flash_f32_kernel<D><<<grid, THREADS, 0, stream>>>(
            static_cast<const float*>(q), static_cast<const float*>(k),
            static_cast<const float*>(v), static_cast<float*>(out), H, Hkv, Sq, Skv, scale,
            softcap, causal);
    }
    return cudaGetLastError();
}

}  // namespace

// q (B,H,Sq,D), k/v (B,Hkv,Skv,D), out (B,H,Sq,D): contiguous device pointers,
// 16-byte aligned, all f32 (bf16 = 0) or all bf16 (bf16 = 1). D in
// {16, 32, 64, 128}; H a multiple of Hkv. Returns the launch's cudaError_t.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* out,
                                      int B, int H, int Hkv, int Sq, int Skv, int D, int bf16,
                                      float scale, float softcap, int causal, void* stream) {
    if (B <= 0 || H <= 0 || Sq <= 0) return static_cast<int>(cudaSuccess);
    if (Hkv <= 0 || H % Hkv != 0 || Skv <= 0) return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (D) {
        case 16: return static_cast<int>(launch<16>(q, k, v, out, B, H, Hkv, Sq, Skv, bf16, scale, softcap, causal, s));
        case 32: return static_cast<int>(launch<32>(q, k, v, out, B, H, Hkv, Sq, Skv, bf16, scale, softcap, causal, s));
        case 64: return static_cast<int>(launch<64>(q, k, v, out, B, H, Hkv, Sq, Skv, bf16, scale, softcap, causal, s));
        case 128: return static_cast<int>(launch<128>(q, k, v, out, B, H, Hkv, Sq, Skv, bf16, scale, softcap, causal, s));
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

// The runtime's text for an error code returned by the launch entry.
extern "C" const char* flash_attention_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}
