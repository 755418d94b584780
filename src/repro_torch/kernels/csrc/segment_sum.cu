// Blocked segment sum for Hopper (sm_90a): per-block partial segment sums.
//
// Replaces the TPU kernel src/repro/kernels/segment_sum.py:_kernel (launched by
// blocked_segment_sum, pallas_call at :58). Per block b of `bn` rows it computes
//   out[b, s, r] = sum over the rows p of block b with seg_ids[b, p] == s of data[b, p, r]
// for every s in [0, S), 0 where no row maps to s. No carry between blocks:
// the caller scatters the (B, S, R) partials into its output rows.
//
// The TPU kernel builds an (S, bn) one-hot gather mask in VMEM and retires a
// block's sums in one MXU matmul: S*bn*R multiply-adds for bn*R useful adds.
// On Hopper the same function is a segmented reduction:
//
// * One warp per (block, 32-column tile of R); lane = rank column. The warp
//   walks the block's rows IN ORDER and adds each row into an (S x 32) f32
//   tile in shared memory, in which every lane owns its own column (bank =
//   lane: no conflicts, no atomics, no barriers).
// * A run of rows with the same segment id is added in a register: the run
//   starts from the tile's current value and is written back when the id
//   changes, which is the same sequence of adds as one add per row. Sorted
//   ids (what the streaming schedule hands it) make almost every add a
//   register add; any order of ids in [0, S) is still summed correctly.
// * The block's rows are loaded 32 at a time, all in flight before the adds
//   (each lane loads one row's id; the ids are broadcast with shuffles).
//
// The sum of every (b, s, r) is taken in row order starting from 0.0, one
// rounded add per row — the order of index_add_ over b*S + seg on the CPU,
// so the kernel is BIT-EQUAL to the plain version run there.
//
// What bounds it: bytes (each row of data read once, B*bn*(4R + 4) bytes,
// and the partials written once, B*S*R*4 bytes); one add per element read.
// Shared memory is S*32*4 bytes per warp (32 KB at S = bn = 256).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BATCH = 32;                   // rows in flight per lane
constexpr int MAX_SMEM = 232448;            // opt-in shared memory per block on sm_90

__global__ void __launch_bounds__(32)
segment_sum_kernel(const float* __restrict__ data, const int* __restrict__ seg_ids,
                   float* __restrict__ out, int bn, int R, int S) {
    extern __shared__ float tile[];         // (S, 32): lane owns column `lane`
    const int b = blockIdx.x;
    const int lane = threadIdx.x;
    const int r = blockIdx.y * 32 + lane;
    const bool r_ok = r < R;
    for (int s = 0; s < S; ++s) tile[s * 32 + lane] = 0.0f;

    const float* __restrict__ rows = data + static_cast<size_t>(b) * bn * R;
    const int* __restrict__ ids = seg_ids + static_cast<size_t>(b) * bn;
    int cur = -1;            // segment whose running sum is in `acc`
    float acc = 0.0f;
    for (int p0 = 0; p0 < bn; p0 += BATCH) {
        const int my_id = p0 + lane < bn ? ids[p0 + lane] : -1;
        float v[BATCH];
#pragma unroll
        for (int u = 0; u < BATCH; ++u) {
            v[u] = (r_ok && p0 + u < bn) ? rows[static_cast<size_t>(p0 + u) * R + r] : 0.0f;
        }
#pragma unroll
        for (int u = 0; u < BATCH; ++u) {
            const int s = __shfl_sync(0xffffffffu, my_id, u);   // uniform across the warp
            if (p0 + u >= bn || static_cast<unsigned>(s) >= static_cast<unsigned>(S)) continue;
            if (s != cur) {
                if (cur >= 0) tile[cur * 32 + lane] = acc;
                acc = tile[s * 32 + lane];
                cur = s;
            }
            acc = __fadd_rn(acc, v[u]);
        }
    }
    if (cur >= 0) tile[cur * 32 + lane] = acc;

    if (!r_ok) return;
    float* __restrict__ dst = out + static_cast<size_t>(b) * S * R;
    for (int s = 0; s < S; ++s) dst[static_cast<size_t>(s) * R + r] = tile[s * 32 + lane];
}

}  // namespace

// data (B, bn, R) f32, seg_ids (B, bn) i32 block-local ids in [0, S) (rows
// with an id outside that range are skipped), out (B, S, R) f32. Returns the
// first failing cudaError_t as an int (0 = launched).
extern "C" int segment_sum_launch(const void* data, const void* seg_ids, void* out, int B, int bn,
                                  int R, int S, void* stream_ptr) {
    const size_t smem = static_cast<size_t>(S) * 32 * sizeof(float);
    if (B < 1 || bn < 1 || R < 1 || S < 1 || smem > MAX_SMEM) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaError_t err = cudaSuccess;
    if (smem > 48 * 1024) {
        err = cudaFuncSetAttribute(segment_sum_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   static_cast<int>(smem));
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    const dim3 grid(B, (R + 31) / 32);
    segment_sum_kernel<<<grid, 32, smem, static_cast<cudaStream_t>(stream_ptr)>>>(
        static_cast<const float*>(data), static_cast<const int*>(seg_ids),
        static_cast<float*>(out), bn, R, S);
    return static_cast<int>(cudaGetLastError());
}

// The runtime's text for an error code returned by the launch entry.
extern "C" const char* segment_sum_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}
