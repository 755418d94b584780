// Fused streaming sparse MTTKRP for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/stream_mttkrp.py:_stream_kernel
// (body _chunk_partials, launched by stream_mttkrp_fused_pallas, pallas_call at
// :188). It computes what that kernel computes, per chunk of E blocks x `rows`
// nonzeros of the sorted stream:
//   partial[seg, r] = sum over the segment's nonzeros p of
//                     (value_p * prod_d s_d[idx_pd]) * float(prod_d q_d[idx_pd, r])
//   full_scale      = max(max |partial| over the whole chunk, 1e-30)
//   out[row(seg)]  += ADC(partial; levels = 2^adc_bits, full_scale)
// but none of the TPU kernel's shape is carried over:
//
// * The (E, S, rows) one-hot mask matmul is an MXU idiom. The stream is
//   sorted, so a block's segment ids are non-decreasing and the same sums are
//   a segmented reduction: one warp per block (per 32-column tile of the
//   rank), lane = rank column, a running sum flushed when the segment id
//   changes. The partials go to a COMPACT scratch — one row per segment that
//   exists, addressed through seg_ptr — not to the (nb, E, n_seg, R) stack
//   padded to the widest block, which reaches gigabytes on short-fiber
//   tensors.
// * Factors are gathered from global memory / L2 (they do not fit shared
//   memory in general). The 32 lanes of a warp read the 32 int8 of a factor
//   row as one 32-byte sector.
// * The chunk-wide ADC full scale must be known before any partial of the
//   chunk is digitized, and the chunking is numerics. Two passes: pass 1
//   writes the partials and folds max|partial| into chunk_max[chunk] with an
//   atomic max on the bits of the non-negative float (order-independent, so
//   deterministic); pass 2 digitizes the partials in place.
// * The TPU grid is sequential and its output ref carries across chunks; CTAs
//   here run concurrently. In stream order the segments of one output row are
//   a contiguous run of the compact scratch (row_ptr), so pass 3 gives every
//   (row, column) to one thread that adds its run IN STREAM ORDER: no
//   atomics on the output, the result is deterministic, and every output
//   element is written exactly once (rows with no nonzero get 0).
//
// What bounds it: bytes. Per nonzero it reads nmodes coordinates, a value and
// a segment id (20 bytes at 3 modes) from device memory once; the factor rows
// (32 bytes each) are re-read from L2. There are 2 multiplies and an add per
// nonzero and column — two orders of magnitude under the card's
// operation/byte balance. The design therefore reads the stream exactly once,
// coalesced (each lane loads the metadata of one nonzero of a 32-batch and
// the warp broadcasts it with shuffles), and keeps every intermediate but
// the per-segment partials out of device memory.
//
// Arithmetic contract: the per-nonzero scale is formed in f32 in mode-
// ascending order starting from the value; the integer Hadamard is exact
// (|q|<=127: products of up to three factors stay below 2^24 in f32, which
// is how the reference forms chains longer than two; two-factor chains are
// the same integers as its int16 path); each contribution is one rounded
// multiply and one rounded add in stream order (no FMA contraction); the ADC
// is rintf of a true division. Built without --use_fast_math.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_MODES = 8;
constexpr int WARPS_PER_CTA = 4;
constexpr int BATCH = 8;        // gathers in flight per lane before the ordered adds
constexpr int FOLD_BATCH = 32;  // partials in flight per lane in the row fold

struct Factors {
    const int8_t* q[MAX_MODES];   // (I_d, R) int8 codes
    const float* s[MAX_MODES];    // (I_d,) f32 per-row scales
};

// Pass 1: per-segment partials of every block + per-chunk max|partial|.
template <int NM>
__global__ void __launch_bounds__(WARPS_PER_CTA * 32)
stream_partials_kernel(const int* __restrict__ ip, const float* __restrict__ vp,
                       const int* __restrict__ lp, Factors f,
                       const int* __restrict__ seg_ptr, float* __restrict__ parts,
                       unsigned int* __restrict__ chunk_max,
                       int n_blocks, int rows, int R, int rtiles, int mode, int E) {
    const long long warp = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
    const int lane = threadIdx.x & 31;
    if (warp >= static_cast<long long>(n_blocks) * rtiles) return;   // whole warps leave together
    const int b = static_cast<int>(warp / rtiles);
    const int r = static_cast<int>(warp % rtiles) * 32 + lane;
    const bool r_ok = r < R;
    const size_t base = static_cast<size_t>(b) * rows;
    float* __restrict__ my_parts = parts + static_cast<size_t>(seg_ptr[b]) * R;

    float acc = 0.0f;      // running sum of the current segment
    float amax = 0.0f;     // max |flushed partial| seen by this lane
    int cur = 0;           // current block-local segment id (a block starts at 0)

    for (int p0 = 0; p0 < rows; p0 += 32) {
        // Each lane loads and pre-multiplies the metadata of one nonzero.
        const int p = p0 + lane;
        int my_idx[NM];
        float my_scale = 0.0f;
        int my_seg = 0;
#pragma unroll
        for (int d = 0; d < NM; ++d) my_idx[d] = 0;
        if (p < rows) {
            my_scale = vp[base + p];
            my_seg = lp[base + p];
#pragma unroll
            for (int d = 0; d < NM; ++d) {
                if (d == mode) continue;
                my_idx[d] = ip[(base + p) * NM + d];
                my_scale = __fmul_rn(my_scale, f.s[d][my_idx[d]]);
            }
        }
        const int count = min(32, rows - p0);
        for (int j0 = 0; j0 < count; j0 += BATCH) {
            float contrib[BATCH];
            int seg[BATCH];
            // Independent gathers first (kept in flight together) ...
#pragma unroll
            for (int u = 0; u < BATCH; ++u) {
                const int j = j0 + u;
                // j < 32 always; lanes at or past `count` hold zero metadata
                // (scale 0, row 0), so their gathers are in range and unused
                const int src = j;
                seg[u] = __shfl_sync(0xffffffffu, my_seg, src);
                const float sc = __shfl_sync(0xffffffffu, my_scale, src);
                float had = 1.0f;
#pragma unroll
                for (int d = 0; d < NM; ++d) {
                    if (d == mode) continue;
                    const int idx = __shfl_sync(0xffffffffu, my_idx[d], src);
                    const int8_t g = r_ok ? f.q[d][static_cast<size_t>(idx) * R + r] : int8_t(0);
                    had = __fmul_rn(had, static_cast<float>(g));
                }
                contrib[u] = __fmul_rn(sc, had);
            }
            // ... then the ordered segmented adds.
#pragma unroll
            for (int u = 0; u < BATCH; ++u) {
                if (j0 + u < count) {
                    if (seg[u] != cur) {                // uniform across the warp
                        if (r_ok) my_parts[static_cast<size_t>(cur) * R + r] = acc;
                        amax = fmaxf(amax, fabsf(acc));
                        acc = 0.0f;
                        cur = seg[u];
                    }
                    acc = __fadd_rn(acc, contrib[u]);
                }
            }
        }
    }
    if (r_ok) my_parts[static_cast<size_t>(cur) * R + r] = acc;
    amax = fmaxf(amax, fabsf(acc));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
    }
    // non-negative floats order like their bit patterns
    if (lane == 0) atomicMax(&chunk_max[b / E], __float_as_uint(amax));
}

// Pass 2: digitize every partial, in place, over its chunk's full scale.
__global__ void __launch_bounds__(256)
stream_digitize_kernel(float* __restrict__ parts, const int* __restrict__ seg_chunk,
                       const unsigned int* __restrict__ chunk_max,
                       long long n_values, int R, float levels, float code_max) {
    const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (i >= n_values) return;
    const float fs = fmaxf(__uint_as_float(chunk_max[seg_chunk[i / R]]), 1e-30f);
    const float lsb = __fdiv_rn(__fmul_rn(2.0f, fs), levels);
    float code = rintf(__fdiv_rn(parts[i], lsb));
    code = fminf(fmaxf(code, -code_max), code_max);
    parts[i] = __fmul_rn(code, lsb);
}

// Pass 3: add the run of segments that belongs to each output row, in stream
// order. The adds of one (row, column) are a serial chain, but an add is a few
// cycles and a load hundreds: FOLD_BATCH independent loads are kept in flight
// ahead of the chain, which is what keeps a fiber of thousands of segments
// from stalling the launch.
__global__ void __launch_bounds__(WARPS_PER_CTA * 32)
stream_fold_kernel(const float* __restrict__ parts, const int* __restrict__ row_ptr,
                   float* __restrict__ out, int out_rows, int R, int rtiles) {
    const long long warp = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
    const int lane = threadIdx.x & 31;
    if (warp >= static_cast<long long>(out_rows) * rtiles) return;
    const int row = static_cast<int>(warp / rtiles);
    const int r = static_cast<int>(warp % rtiles) * 32 + lane;
    if (r >= R) return;
    const int lo = row_ptr[row];
    const int hi = row_ptr[row + 1];
    float sum = 0.0f;
    for (int g0 = lo; g0 < hi; g0 += FOLD_BATCH) {
        float x[FOLD_BATCH];
#pragma unroll
        for (int u = 0; u < FOLD_BATCH; ++u) {
            const int g = g0 + u;
            x[u] = g < hi ? parts[static_cast<size_t>(g) * R + r] : 0.0f;
        }
#pragma unroll
        for (int u = 0; u < FOLD_BATCH; ++u) {
            if (g0 + u < hi) sum = __fadd_rn(sum, x[u]);
        }
    }
    out[static_cast<size_t>(row) * R + r] = sum;
}

template <int NM>
cudaError_t launch_partials(const int* ip, const float* vp, const int* lp, const Factors& f,
                            const int* seg_ptr, float* parts, unsigned int* chunk_max,
                            int n_blocks, int rows, int R, int rtiles, int mode, int E,
                            cudaStream_t stream) {
    const long long warps = static_cast<long long>(n_blocks) * rtiles;
    const unsigned int ctas = static_cast<unsigned int>((warps + WARPS_PER_CTA - 1) / WARPS_PER_CTA);
    stream_partials_kernel<NM><<<ctas, WARPS_PER_CTA * 32, 0, stream>>>(
        ip, vp, lp, f, seg_ptr, parts, chunk_max, n_blocks, rows, R, rtiles, mode, E);
    return cudaGetLastError();
}

}  // namespace

// ip (nb,E,rows,nmodes) i32, vp/lp (nb,E,rows) f32/i32; q_ptrs/s_ptrs host
// arrays of nmodes device pointers (the target mode's entries are never
// read); seg_ptr (nb*E+1,) i32 first compact-scratch row of each block;
// seg_chunk (total_segs,) i32 chunk of each compact segment; row_ptr
// (out_rows+1,) i32 run of compact segments per output row; parts
// (total_segs, R) f32 scratch (left digitized); chunk_max (nb,) u32 scratch (bits of the
// per-chunk max|partial|, readable after the call); out (out_rows, R) f32.
// Returns the first failing cudaError_t as an int (0 = launched).
extern "C" int stream_mttkrp_launch(const void* ip, const void* vp, const void* lp,
                                    const void* const* q_ptrs, const void* const* s_ptrs,
                                    const void* seg_ptr, const void* seg_chunk,
                                    const void* row_ptr, void* parts, void* chunk_max,
                                    void* out, int nb, int E, int rows, int nmodes, int mode,
                                    int R, int out_rows, int total_segs, int adc_bits,
                                    void* stream_ptr) {
    if (nmodes < 2 || nmodes > MAX_MODES || mode < 0 || mode >= nmodes || R < 1) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    Factors f;
    for (int d = 0; d < MAX_MODES; ++d) {
        f.q[d] = d < nmodes ? static_cast<const int8_t*>(q_ptrs[d]) : nullptr;
        f.s[d] = d < nmodes ? static_cast<const float*>(s_ptrs[d]) : nullptr;
    }
    const int n_blocks = nb * E;
    const int rtiles = (R + 31) / 32;
    cudaError_t err = cudaMemsetAsync(chunk_max, 0, sizeof(unsigned int) * static_cast<size_t>(nb), stream);
    if (err != cudaSuccess) return static_cast<int>(err);

#define LAUNCH_PARTIALS(NM)                                                              \
    case NM:                                                                             \
        err = launch_partials<NM>(static_cast<const int*>(ip), static_cast<const float*>(vp), \
                                  static_cast<const int*>(lp), f,                        \
                                  static_cast<const int*>(seg_ptr), static_cast<float*>(parts), \
                                  static_cast<unsigned int*>(chunk_max), n_blocks, rows, R, \
                                  rtiles, mode, E, stream);                              \
        break;
    switch (nmodes) {
        LAUNCH_PARTIALS(2)
        LAUNCH_PARTIALS(3)
        LAUNCH_PARTIALS(4)
        LAUNCH_PARTIALS(5)
        LAUNCH_PARTIALS(6)
        LAUNCH_PARTIALS(7)
        LAUNCH_PARTIALS(8)
        default:
            err = cudaErrorInvalidValue;
    }
#undef LAUNCH_PARTIALS
    if (err != cudaSuccess) return static_cast<int>(err);

    const long long n_values = static_cast<long long>(total_segs) * R;
    if (adc_bits > 0 && n_values > 0) {
        const float levels = static_cast<float>(1ll << adc_bits);
        const float code_max = static_cast<float>((1ll << adc_bits) / 2 - 1);
        const unsigned int ctas = static_cast<unsigned int>((n_values + 255) / 256);
        stream_digitize_kernel<<<ctas, 256, 0, stream>>>(
            static_cast<float*>(parts), static_cast<const int*>(seg_chunk),
            static_cast<const unsigned int*>(chunk_max), n_values, R, levels, code_max);
        err = cudaGetLastError();
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    if (out_rows > 0) {
        const long long warps = static_cast<long long>(out_rows) * rtiles;
        const unsigned int ctas = static_cast<unsigned int>((warps + WARPS_PER_CTA - 1) / WARPS_PER_CTA);
        stream_fold_kernel<<<ctas, WARPS_PER_CTA * 32, 0, stream>>>(
            static_cast<const float*>(parts), static_cast<const int*>(row_ptr),
            static_cast<float*>(out), out_rows, R, rtiles);
        err = cudaGetLastError();
    }
    return static_cast<int>(err);
}

// The runtime's text for an error code returned by the launch entry.
extern "C" const char* stream_mttkrp_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}
