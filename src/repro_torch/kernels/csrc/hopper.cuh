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
// core.mttkrp.psram_chain, bit for bit. Every division is __fdiv_rn (a
// true division, never a reciprocal multiply), every rounding rintf (half
// to even, as torch.round), every product __fmul_rn (no FMA). The integer
// products of two codes are formed in int, so a zero product is +0.0 as
// the plain version's int32 product is; the ADC's code stays a float, so a
// product that rounds to code -0 keeps its sign as adc_transfer's does.
struct PsramAdc {
    float lsb;        // the products' LSB, 2 * 127^2 / 2^adc_bits rounded once to f32
    float code_max;   // the largest code, 2^adc_bits / 2 - 1: the clamp fires at a
                      // full-scale product (127 * 127 is code 2^(adc_bits - 1))
};

// symmetric_scale: max(amax, 1e-12) / 127
__device__ __forceinline__ float psram_scale(float amax) {
    return __fdiv_rn(fmaxf(amax, 1e-12f), 127.0f);
}

// quantize_symmetric's code of x: round(x / scale) clamped to +-127
__device__ __forceinline__ int psram_code(float x, float scale) {
    return static_cast<int>(fminf(fmaxf(rintf(__fdiv_rn(x, scale)), -127.0f), 127.0f));
}

// adc_transfer of an integer accumulation: round(acc / lsb) clamped to the
// codes, times lsb
__device__ __forceinline__ float psram_adc(int acc, const PsramAdc& a) {
    const float code = rintf(__fdiv_rn(static_cast<float>(acc), a.lsb));
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

// The quantized chain of one nonzero of value v, formed in place of its
// first non-target row: its K non-target factors' rows of R columns lie in
// shared memory at row + k * kstride (mode order). CP1 folds them pairwise
// through the ADC (the running Hadamard requantized, the next row quantized,
// the integer product digitized, times both scales); CP2 drives v through
// it once more. Each quantization's scale reduces |.| over the whole row.
// A group of G lanes (an aligned sub-warp; every lane of the warp calls
// this at once, each group on its own row) takes the row: lane l of the
// group owns the pieces p = l, l + G, ... of PIECE columns each (R a
// multiple of PIECE), and every value stays with its lane between the
// steps, so only the row's maxima cross lanes.
template <int G, int PIECE>
__device__ __forceinline__ void psram_chain_row(float* row, int kstride, int K, int R, float v,
                                                const PsramAdc& a) {
    const int gl = static_cast<int>(threadIdx.x) & (G - 1);
    auto each = [&](auto&& f) {
        for (int p = gl; p * PIECE < R; p += G) {
#pragma unroll
            for (int e = 0; e < PIECE; ++e) f(p * PIECE + e);
        }
    };
    float m = 0.0f;
    each([&](int c) { m = fmaxf(m, fabsf(row[c])); });
    const float s0 = psram_scale(group_max<G>(m));
    each([&](int c) { row[c] = __fmul_rn(static_cast<float>(psram_code(row[c], s0)), s0); });
    for (int k = 1; k < K; ++k) {                                      // CP 1
        const float* f = row + k * kstride;
        float mh = 0.0f, mf = 0.0f;
        each([&](int c) {
            mh = fmaxf(mh, fabsf(row[c]));
            mf = fmaxf(mf, fabsf(f[c]));
        });
        const float sa = psram_scale(group_max<G>(mh));
        const float sb = psram_scale(group_max<G>(mf));
        const float sab = __fmul_rn(sa, sb);
        each([&](int c) {
            row[c] = __fmul_rn(psram_adc(psram_code(row[c], sa) * psram_code(f[c], sb), a), sab);
        });
    }
    const float sv = psram_scale(fabsf(v));                            // CP 2
    const int qv = psram_code(v, sv);
    float mh = 0.0f;
    each([&](int c) { mh = fmaxf(mh, fabsf(row[c])); });
    const float sh = psram_scale(group_max<G>(mh));
    const float svh = __fmul_rn(sv, sh);
    each([&](int c) { row[c] = __fmul_rn(psram_adc(qv * psram_code(row[c], sh), a), svh); });
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
