// Hopper (sm_90a) building blocks shared by the kernels of this directory:
// mbarriers, TMA loads, the warpgroup MMA (wgmma) descriptor, fences and
// register pins, the host-side encoding of TMA tensor maps, cp.async copies,
// the opt-in to 227 KB of dynamic shared memory, and the factor operand and
// the quantized chain of the kernels that form a sparse stream's chain.
// Included by every .cu of this directory but stream_mttkrp.cu;
// kernels/_build.py hashes this header into every library name, so editing
// it rebuilds them.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#if CUDART_VERSION < 12050
#error "the kernels need CUDA 12.5 or newer (cudaGetDriverEntryPointByVersion)"
#endif

namespace hopper {

// The most modes a sparse stream may have where a kernel forms its exact
// chain (the ordered fold's chain route, the blocked segment sum's chain
// route), and those kernels' factor operand: the stream's non-target
// factors (I_d, R) f32 row-major, in mode order, passed by value in the
// kernel's parameters.
constexpr int CHAIN_MAX_MODES = 8;

struct ChainFactors {
    const float* f[CHAIN_MAX_MODES - 1];
};

// The quantized chain of those kernels (their psram variants): the port's
// core.mttkrp.psram_chain, bit for bit. Every quotient is the IEEE one
// (RN(x / y), as a true division rounds it), every rounding rintf (half to
// even, as torch.round), every product __fmul_rn (no FMA). A quotient by a
// row's scale or by the ADC's LSB is formed without a division (psram_div):
// the divisor's reciprocal, made once per row or per launch, and two fma
// corrections. The codes stay floats: the product of two codes is exact in
// f32 (|.| <= 127^2 < 2^24), and the ADC turns a product of either zero's
// sign into +0.0, as the plain version's int32 product is; the ADC's code
// keeps its sign, so a product that rounds to code -0 stays -0.0 as
// adc_transfer's does.
struct PsramAdc {
    float lsb;        // the products' LSB, 2 * 127^2 / 2^adc_bits rounded once to f32
    float code_max;   // the largest code, 2^adc_bits / 2 - 1: the clamp fires at a
                      // full-scale product (127 * 127 is code 2^(adc_bits - 1))
    float rlsb;       // RN(1 / lsb), made once on the host (adc_operands)
};

// symmetric_scale: max(amax, 1e-12) / 127, a true division (once a row)
__device__ __forceinline__ float psram_scale(float amax) {
    return __fdiv_rn(fmaxf(amax, 1e-12f), 127.0f);
}

// RN(x / s) from rs = RN(1 / s) (__frcp_rn, or the host's f32 quotient):
// q0 = RN(x rs), then two corrections q' = RN(q + r rs) by the exact
// remainder r = x - s q (one fma each), kernel 4's drive_codes sequence
// (csrc/mttkrp.cu). q1 is within an ulp of x / s, and from a faithful
// quotient and the correctly rounded reciprocal one correction gives the
// IEEE quotient (Markstein), wherever nothing overflows or underflows:
// * a row's code, x / scale: scale = max(amax, 1e-12) / 127 >= 7.8e-15 is
//   normal and |x / scale| <= 127 (1 + 2^-23); wherever |x / scale| >= 1/4
//   (the codes that can round either way) x and r are normal too, and below
//   every quotient rounds to code 0;
// * the ADC, acc / lsb: acc is an integer, |acc| <= 127^2, and lsb =
//   2 * 127^2 / 2^bits is normal for bits 1..24, so |acc / lsb| < 2^24.
// q0 is fma(x, rs, +0): RN(x rs) where the product is not zero, and +0.0
// for a zero x of either sign (the corrections keep it +0.0).
// ordered_fold.cu's psram_division_probe holds it to __fdiv_rn: every
// integer product at every ADC width, every finite f32 value's code, rows.
__device__ __forceinline__ float psram_div(float x, float s, float rs) {
    const float q0 = __fmaf_rn(x, rs, 0.0f);
    const float q1 = __fmaf_rn(__fmaf_rn(-s, q0, x), rs, q0);
    return __fmaf_rn(__fmaf_rn(-s, q1, x), rs, q1);
}

// quantize_symmetric's code of x at scale s (rs its reciprocal): round(x /
// s) clamped to +-127, as a float
__device__ __forceinline__ float psram_code(float x, float s, float rs) {
    return fminf(fmaxf(rintf(psram_div(x, s, rs)), -127.0f), 127.0f);
}

// adc_transfer of an integer accumulation p (a product of two codes):
// round(p / lsb) clamped to the codes, times lsb
__device__ __forceinline__ float psram_adc(float p, const PsramAdc& a) {
    const float code = rintf(psram_div(p, a.lsb, a.rlsb));
    return __fmul_rn(fminf(fmaxf(code, -a.code_max), a.code_max), a.lsb);
}

// The max of x over an aligned group of G lanes (a power of 2 up to 32);
// every lane of the warp takes part.
template <int G>
__device__ __forceinline__ float group_max(float x) {
#pragma unroll
    for (int o = G / 2; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
    return x;
}

// The same for U rows at once over groups of g lanes (g a power of 2 up to
// 32, known at compile time or not), so the rows' shuffles overlap.
template <int U>
__device__ __forceinline__ void group_max_rows(float (&x)[U], int g) {
    for (int o = g / 2; o > 0; o >>= 1) {
#pragma unroll
        for (int u = 0; u < U; ++u) x[u] = fmaxf(x[u], __shfl_xor_sync(0xffffffffu, x[u], o));
    }
}

// The quantized chain of one nonzero of value v, formed in place of its
// first non-target row: its K non-target factors' rows of R columns lie in
// shared memory at row + k * kstride (mode order). CP1 folds them pairwise
// through the ADC (the running Hadamard requantized, the next row quantized,
// the integer product digitized, times both scales); CP2 drives v through
// it once more. Each quantization's scale reduces |.| over the whole row.
// The whole warp takes the row, lane l the columns l, l + 32, ..., through
// shared memory: the routes' form at ranks whose rows psram_chain_pieces
// cannot take.
__device__ __forceinline__ void psram_chain_row(float* row, int kstride, int K, int R, float v,
                                                const PsramAdc& a) {
    const int lane = static_cast<int>(threadIdx.x) & 31;
    auto each = [&](auto&& f) {
        for (int c = lane; c < R; c += 32) f(c);
    };
    float m = 0.0f;
    each([&](int c) { m = fmaxf(m, fabsf(row[c])); });
    const float s0 = psram_scale(group_max<32>(m));
    const float r0 = __frcp_rn(s0);
    each([&](int c) { row[c] = __fmaf_rn(psram_code(row[c], s0, r0), s0, 0.0f); });
    for (int k = 1; k < K; ++k) {                                      // CP 1
        const float* f = row + k * kstride;
        float mh = 0.0f, mf = 0.0f;
        each([&](int c) {
            mh = fmaxf(mh, fabsf(row[c]));
            mf = fmaxf(mf, fabsf(f[c]));
        });
        const float sa = psram_scale(group_max<32>(mh)), ra = __frcp_rn(sa);
        const float sb = psram_scale(group_max<32>(mf)), rb = __frcp_rn(sb);
        const float sab = __fmul_rn(sa, sb);
        each([&](int c) {
            const float p = __fmul_rn(psram_code(row[c], sa, ra), psram_code(f[c], sb, rb));
            row[c] = __fmul_rn(psram_adc(p, a), sab);
        });
    }
    const float sv = psram_scale(fabsf(v));                            // CP 2
    const float qv = psram_code(v, sv, __frcp_rn(sv));
    float mh = 0.0f;
    each([&](int c) { mh = fmaxf(mh, fabsf(row[c])); });
    const float sh = psram_scale(group_max<32>(mh)), rh = __frcp_rn(sh);
    const float svh = __fmul_rn(sv, sh);
    each([&](int c) {
        row[c] = __fmul_rn(psram_adc(__fmul_rn(qv, psram_code(row[c], sh, rh)), a), svh);
    });
}

// The same chain for U rows at once, in registers: lane l holds 4
// neighbouring columns (one 16-byte piece) of each of its U rows, a row
// being an aligned group of g lanes (R = 4 g, g a power of 2 up to 32).
// Row u's piece of the first factor lies at at[u] in shared memory (16-byte
// aligned), factor k's at at[u] + k * kstride; its value is v[u]. The
// running Hadamard stays in registers through the K + 1 steps: each factor
// row is read once and only the final chain row is written back, in place
// of the first factor's piece. The U rows' steps interleave, so their
// shuffles, reciprocals and quotients overlap. A row with live[u] false
// (uniform over its group) is neither read nor written.
template <int U>
__device__ __forceinline__ void psram_chain_pieces(float* const (&at)[U], const bool (&live)[U],
                                                   const float (&v)[U], int kstride, int K,
                                                   int g, const PsramAdc& a) {
    float h[U][4], m[U];
    auto load = [&](float (&x)[4], const float* p, bool ok) {
        const float4 t = ok ? *reinterpret_cast<const float4*>(p) : make_float4(0.f, 0.f, 0.f, 0.f);
        x[0] = t.x; x[1] = t.y; x[2] = t.z; x[3] = t.w;
    };
    auto amax = [](const float (&x)[4]) {
        return fmaxf(fmaxf(fabsf(x[0]), fabsf(x[1])), fmaxf(fabsf(x[2]), fabsf(x[3])));
    };
#pragma unroll
    for (int u = 0; u < U; ++u) {
        load(h[u], at[u], live[u]);
        m[u] = amax(h[u]);
    }
    group_max_rows<U>(m, g);
#pragma unroll
    for (int u = 0; u < U; ++u) {
        const float s = psram_scale(m[u]), r = __frcp_rn(s);
#pragma unroll
        for (int e = 0; e < 4; ++e) h[u][e] = __fmaf_rn(psram_code(h[u][e], s, r), s, 0.0f);
    }
    for (int k = 1; k < K; ++k) {                                      // CP 1
        float f[U][4], mm[2 * U];                  // the maxima of h, then of f
#pragma unroll
        for (int u = 0; u < U; ++u) {
            load(f[u], at[u] + k * kstride, live[u]);
            mm[u] = amax(h[u]);
            mm[U + u] = amax(f[u]);
        }
        group_max_rows<2 * U>(mm, g);
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const float sa = psram_scale(mm[u]), ra = __frcp_rn(sa);
            const float sb = psram_scale(mm[U + u]), rb = __frcp_rn(sb);
            const float sab = __fmul_rn(sa, sb);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const float p = __fmul_rn(psram_code(h[u][e], sa, ra), psram_code(f[u][e], sb, rb));
                h[u][e] = __fmul_rn(psram_adc(p, a), sab);
            }
        }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) m[u] = amax(h[u]);                     // CP 2
    group_max_rows<U>(m, g);
#pragma unroll
    for (int u = 0; u < U; ++u) {
        const float sv = psram_scale(fabsf(v[u]));
        const float qv = psram_code(v[u], sv, __frcp_rn(sv));
        const float sh = psram_scale(m[u]), rh = __frcp_rn(sh);
        const float svh = __fmul_rn(sv, sh);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            h[u][e] = __fmul_rn(psram_adc(__fmul_rn(qv, psram_code(h[u][e], sh, rh)), a), svh);
        }
        if (live[u]) *reinterpret_cast<float4*>(at[u]) = make_float4(h[u][0], h[u][1], h[u][2], h[u][3]);
    }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Asynchronous copies from device into shared memory (cp.async): 16 bytes
// through L2 only (cp_async16) or through L1 too (cp_async16_ca, for rows
// a CTA may gather again), 8 and 4 bytes through L1; a thread's copies are
// grouped by commit_group, and wait_group<N> waits until at most N of its
// groups are in flight.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(smem_u32(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async16_ca(void* dst, const void* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n"
                 :: "r"(smem_u32(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n"
                 :: "r"(smem_u32(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(smem_u32(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void commit_group() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wait_group() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// one arrival on the mbarrier `bar` once every cp.async this thread issued
// so far has landed (the barrier's expected count already includes it)
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
    asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

// The opt-in dynamic shared memory of one CTA on sm_90 (227 KB).
constexpr int MAX_DYNAMIC_SMEM = 232448;

// Lets Kernel launch with up to MAX_DYNAMIC_SMEM bytes of dynamic shared
// memory: once per kernel instance and device, since the attribute holds for
// every later launch there.
template <auto Kernel>
cudaError_t opt_in_max_smem() {
    constexpr int MAX_DEVICES = 64;
    static bool done[MAX_DEVICES] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev < MAX_DEVICES && done[dev]) return cudaSuccess;
    err = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               MAX_DYNAMIC_SMEM);
    if (err == cudaSuccess && dev < MAX_DEVICES) done[dev] = true;
    return err;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// make the initialised barriers visible to the TMA unit (call before the
// CTA-wide barrier that follows the inits)
__device__ __forceinline__ void mbar_init_fence() {
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// arrive and announce `bytes` of TMA traffic for the barrier's current phase
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
                 : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// spin until the phase of parity `parity` of the barrier has completed; a
// wait that lasts ~2^34 cycles (seconds) traps, so a lost arrival ends the
// launch with an error instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    uint32_t done;
    long long start = 0;
    for (;;) {
        asm volatile(
            "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done)
            : "r"(bar), "r"(parity)
            : "memory");
        if (done) return;
        if (start == 0) {
            start = clock64();
        } else if (clock64() - start > (1ll << 34)) {
            __trap();
        }
    }
}

// one try: 1 where the phase of parity `parity` has completed, else 0 (a
// wait may follow; the try's latency overlaps what comes between)
__device__ __forceinline__ uint32_t mbar_try(uint32_t bar, uint32_t parity) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    return done;
}

// Thread-block clusters: distributed shared memory and its barriers.

// this CTA's rank in its cluster
__device__ __forceinline__ uint32_t cluster_ctarank() {
    uint32_t r;
    asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
    return r;
}

// every thread of the cluster meets here (a warp all at once): what any
// thread wrote before, barrier inits included, is visible to all after
__device__ __forceinline__ void cluster_sync() {
    asm volatile("barrier.cluster.arrive.release.aligned;\n"
                 "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// the cluster address of what lies at shared-memory address `addr` in the
// CTA of rank `rank` (every CTA of a launch lays its shared memory out alike)
__device__ __forceinline__ uint32_t cluster_addr(uint32_t addr, uint32_t rank) {
    uint32_t r;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
    return r;
}

// one arrival on a barrier at cluster address `bar` (another CTA's), with
// mbarrier.arrive's own release semantics, as a pipeline's consumer frees a
// stage of a producer in another CTA (.release.cluster made the ordered
// fold's head row ~2x slower on an H100: a fence a batch)
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar) {
    asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// the same arrival, announcing `bytes` of bulk-copy traffic for the phase
__device__ __forceinline__ void mbar_expect_tx_cluster(uint32_t bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cluster.b64 _, [%0], %1;\n"
                 ::"r"(bar), "r"(bytes)
                 : "memory");
}

// copy `bytes` (a multiple of 16, both ends 16-byte aligned) from this
// CTA's shared memory at `src` to cluster address `dst`, counted on the
// barrier at cluster address `bar` (the destination CTA's)
__device__ __forceinline__ void bulk_copy_to_cluster(uint32_t dst, uint32_t src, uint32_t bytes,
                                                     uint32_t bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
        ::"r"(dst), "r"(src), "r"(bytes), "r"(bar)
        : "memory");
}

// this thread's shared-memory writes, made visible to the bulk copies
// issued after it (by any thread of the CTA, after a barrier)
__device__ __forceinline__ void fence_proxy_async_shared() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// an L2 policy for data read once: evicted first, so what is reused stays
__device__ __forceinline__ uint64_t evict_first_policy() {
    uint64_t policy;
    asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(policy));
    return policy;
}

// an L2 policy for data that other CTAs read again: normal eviction
__device__ __forceinline__ uint64_t evict_normal_policy() {
    uint64_t policy;
    asm volatile("createpolicy.fractional.L2::evict_normal.b64 %0, 1.0;\n" : "=l"(policy));
    return policy;
}

// one TMA box of a 2-D map (column, row) into shared memory, its bytes
// counted on `bar`, under the L2 `policy`
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, uint64_t policy) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint "
        "[%0], [%1, {%3, %4}], [%2], %5;\n" ::"r"(dst),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "l"(policy)
        : "memory");
}

// one TMA box of a 3-D map (column, row, head) into shared memory, its
// bytes counted on `bar`
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
        : "memory");
}

// the same under the L2 `policy` (evict-first for data read once)
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, uint64_t policy) {
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint "
        "[%0], [%1, {%3, %4, %5}], [%2], %6;\n" ::"r"(dst),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "l"(policy)
        : "memory");
}

// wgmma descriptor of a shared-memory operand in the 128-byte swizzle:
// start address, leading and stride byte offsets (16-byte units), layout 1
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
    return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
           (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Pin registers at this point of the program: an in-flight wgmma writes its
// accumulator and reads its A fragment behind the compiler's back, so every
// use after the wait must stay after it, and the A registers must not be
// reused before it.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void pin(int (&r)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N][4]) {
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// cuTensorMapEncodeTiled, reached through the runtime (no link to libcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encoder() {
    static EncodeTiled fn = nullptr;
    if (fn == nullptr) {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult found;
        const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                                 cudaEnableDefault, &found);
        if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) {
            fn = reinterpret_cast<EncodeTiled>(p);
        }
    }
    return fn;
}

// A row-major tensor of `rank` (2 or 3) dims, innermost first, as a TMA map
// with boxes `box` in the 128-byte swizzle (box[0] * element bytes == 128)
// or, where `swizzle` says so, another (CU_TENSOR_MAP_SWIZZLE_NONE: a box
// lands as a dense row-major array, box[0] * element bytes a multiple of 16);
// boxes reaching past the tensor fill with zeros. False if the driver
// refuses it (alignment: the base and every row stride a multiple of 16
// bytes).
inline bool encode_map(CUtensorMap* map, CUtensorMapDataType type, int elem_bytes, int rank,
                       const void* ptr, const cuuint64_t* dims, const cuuint32_t* box,
                       CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
    const EncodeTiled encode = encoder();
    if (encode == nullptr || rank < 2 || rank > 3) return false;
    cuuint64_t strides[2];
    cuuint64_t stride = static_cast<cuuint64_t>(elem_bytes);
    for (int d = 0; d + 1 < rank; ++d) strides[d] = stride *= dims[d];
    const cuuint32_t elem[3] = {1, 1, 1};
    return encode(map, type, static_cast<cuuint32_t>(rank), const_cast<void*>(ptr), dims, strides,
                  box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace hopper
