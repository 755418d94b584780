// Ordered fold for Hopper (sm_90a): the exact sparse MTTKRP's CP3 scatter,
// with every output row's adds in stream order.
//
//   out[row] = ((out[row] + d[i0]) + d[i0 + 1]) + ... + d[i1 - 1]
//
// over each row's run [i0, i1) of a stream whose target ids are sorted. The
// fold starts from the row's current value, so chunked calls over one stream
// compose into one in-order fold.
//
// No TPU kernel of the reference is replaced: the reference's exact sparse
// paths fold with one global jax.ops.segment_sum (src/repro/core/mttkrp.py:
// mttkrp_sparse, src/repro/sparse/stream.py's eager executor), which XLA adds
// in stream order, and the reference asserts the eager stream BIT-IDENTICAL
// to that scatter. On the card the port's index_add_ is atomic and adds in no
// fixed order; this kernel gives the order back, so the card's result is
// bit-equal to the CPU's index_add_ (stream order) and repeatable.
//
// What bounds it: bytes (d read once, out read and written once) — and, for a
// long run, the chain itself: each element's adds depend on each other, so a
// run of L rows costs L dependent f32 adds whatever the parallelism. The
// power-law head row of a NELL-2-shaped tensor owns 2.5 M of its 16.8 M
// nonzeros; one warp loading its own rows would keep ~4 KB in flight and
// crawl at a few GB/s. So:
//
// * One CTA per run (segment) of 4 warps. All 128 threads stream the run's
//   rows — one contiguous block of d — into a ring of STAGES shared-memory
//   stages with cp.async (16-byte copies when R % 4 == 0 and d is 16-byte
//   aligned, else 4-byte), STAGES-1 stages (40 KB) in flight ahead of the
//   adds.
// * Warp 0 folds: lane = rank column (lanes loop for R > 32), rows in
//   order, one rounded __fadd_rn a row, the running value kept in shared
//   memory between stages; the other warps only copy.
// * Short runs (the uniform modes: hundreds of rows) cost one CTA each.
//
// Every add is one IEEE f32 add in the order of the stream, starting from the
// row's value in `out` — index_add_'s order on the CPU.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;          // 4 warps: all copy, warp 0 folds
constexpr int STAGES = 6;             // ring depth; STAGES - 1 stages in flight
constexpr int STAGE_FLOATS = 2048;    // 8 KB a stage (whole rows: at least one)

__device__ __forceinline__ unsigned smem_u32(const void* p) {
    return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Copy n contiguous floats from global src into shared dst, asynchronously.
template <bool VEC>
__device__ __forceinline__ void start_copy(float* dst, const float* src, int n, int tid) {
    if constexpr (VEC) {
        for (int i = tid * 4; i < n; i += THREADS * 4) {
            asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                         :: "r"(smem_u32(dst + i)), "l"(src + i) : "memory");
        }
    } else {
        for (int i = tid; i < n; i += THREADS) {
            asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                         :: "r"(smem_u32(dst + i)), "l"(src + i) : "memory");
        }
    }
}

__device__ __forceinline__ void commit_group() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wait_group() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// One CTA per segment s: d rows [seg_ptr[s] - base, seg_ptr[s+1] - base)
// folded into out row seg_rows[s] (row s where seg_rows is null).
template <bool VEC>
__global__ void __launch_bounds__(THREADS)
ordered_fold_kernel(float* __restrict__ out, const float* __restrict__ d,
                    const long long* __restrict__ seg_ptr,
                    const long long* __restrict__ seg_rows,
                    long long base, int R, int rows_per_stage) {
    extern __shared__ __align__(16) float smem[];   // ring, then R running values
    const long long first = seg_ptr[blockIdx.x] - base;
    const long long n_rows = seg_ptr[blockIdx.x + 1] - base - first;
    if (n_rows <= 0) return;
    const long long row = seg_rows ? seg_rows[blockIdx.x] : static_cast<long long>(blockIdx.x);
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const bool folder = tid < 32;
    const int stage_floats = rows_per_stage * R;
    float* ring = smem;
    float* acc = smem + STAGES * stage_floats;
    float* dst = out + row * R;
    const float* src = d + first * R;
    const int n_stages = static_cast<int>((n_rows + rows_per_stage - 1) / rows_per_stage);

    auto rows_of = [&](int st) {
        const long long left = n_rows - static_cast<long long>(st) * rows_per_stage;
        return static_cast<int>(left < rows_per_stage ? left : rows_per_stage);
    };
    auto fetch = [&](int st) {
        start_copy<VEC>(ring + (st % STAGES) * stage_floats,
                        src + static_cast<long long>(st) * stage_floats, rows_of(st) * R, tid);
    };

    if (folder) {
        for (int c = lane; c < R; c += 32) acc[c] = dst[c];
    }
#pragma unroll
    for (int st = 0; st < STAGES - 1; ++st) {
        if (st < n_stages) fetch(st);
        commit_group();
    }
    for (int st = 0; st < n_stages; ++st) {
        // the slot of stage st - 1, freed by the barrier that ended it
        if (st + STAGES - 1 < n_stages) fetch(st + STAGES - 1);
        commit_group();
        wait_group<STAGES - 1>();          // this thread's copies of stage st landed
        __syncthreads();                   // ... and everyone's
        if (folder) {
            const float* slot = ring + (st % STAGES) * stage_floats;
            const int nr = rows_of(st);
            for (int c = lane; c < R; c += 32) {
                float v = acc[c];
#pragma unroll 16
                for (int i = 0; i < nr; ++i) v = __fadd_rn(v, slot[i * R + c]);
                acc[c] = v;
            }
        }
        __syncthreads();                   // the slot may be refilled
    }
    if (folder) {
        for (int c = lane; c < R; c += 32) dst[c] = acc[c];
    }
}

// rows per stage and dynamic shared memory of a launch at rank R
int rows_per_stage(int R) { return R >= STAGE_FLOATS ? 1 : STAGE_FLOATS / R; }
size_t smem_bytes(int R) {
    return sizeof(float) * (static_cast<size_t>(STAGES) * rows_per_stage(R) * R + R);
}

}  // namespace

// The most rank columns a launch takes (the ring of one-row stages and the
// running values fit the 227 KB of opt-in shared memory).
extern "C" int ordered_fold_max_rank() { return 8192; }

// out (rows, R) f32, d (n, R) f32, seg_ptr (n_seg + 1,) int64 stream
// positions, seg_rows (n_seg,) int64 target rows or null (row = segment),
// all contiguous device pointers; segment s folds d rows
// [seg_ptr[s] - base, seg_ptr[s+1] - base) into its row. vec: R % 4 == 0 and
// d 16-byte aligned. Returns the launch's cudaError_t as an int.
extern "C" int ordered_fold_launch(void* out, const void* d, const void* seg_ptr,
                                   const void* seg_rows, long long base, int n_seg, int R,
                                   int vec, void* stream) {
    if (n_seg <= 0 || R <= 0) return static_cast<int>(cudaSuccess);
    if (R > ordered_fold_max_rank()) return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem = smem_bytes(R);
    auto kernel = vec ? ordered_fold_kernel<true> : ordered_fold_kernel<false>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<n_seg, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<float*>(out), static_cast<const float*>(d),
        static_cast<const long long*>(seg_ptr), static_cast<const long long*>(seg_rows),
        base, R, rows_per_stage(R));
    return static_cast<int>(cudaGetLastError());
}

// The runtime's text for an error code returned by the launch entry.
extern "C" const char* ordered_fold_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}
