// Blocked segment sum for Hopper (sm_90a): per-block partial segment sums.
// Two routes: `rows` takes the chain rows, `chain` forms them (below).
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
//
// Route `chain` (segment_chain_kernel): the same partials of the exact chain
// of a sparse stream, the chain formed inside the kernel, so the (B, bn, R)
// chain is never written to device memory. The stream is nnz nonzeros: the
// non-target coordinates coords (nnz, K) int32 row-major (K = nmodes - 1, in
// mode order), values (nnz,) f32, cut into B blocks of bn positions, whose
// block-local segment ids are seg_ids (B, bn). Nonzero p's chain row is
//   d_p = v_p * (F_a[i_pa] * F_b[i_pb] * ...)   (non-target modes a < b < ...)
// the Hadamard in mode order, then the value, one __fmul_rn each (no FMA),
// as the plain version's cp_chain_exact forms it; positions p >= nnz (the
// padding of the last block) add nothing. Each slot is then summed from 0.0
// in row order with __fadd_rn, as route `rows` sums it, so the two routes
// give the same bits: route `rows` over the padded chain adds +-0.0 rows
// for the padding, and 0.0 plus +-0.0 is 0.0.
//
// * One warp per (block, 32-column tile of R), 4 warps a CTA, each warp on
//   its own; lane = rank column. The warp walks the block's nonzeros in
//   order, a batch at a time (8 at K = 2: the batch's K rows of the tile are
//   2 KB), through a two-level cp.async pipeline like kernel 1's
//   (csrc/stream_mttkrp.cu, the chunk route): a batch's coordinates, ids and
//   values are copied into shared memory 2 AHEAD batches before its sums,
//   and its factor rows gathered AHEAD = 1 batch before, from coordinates
//   that already landed there (a row's 16-byte pieces on neighbouring lanes,
//   so a copy instruction takes whole rows, through L1; 4-byte copies where
//   the rows are not 16-byte aligned). No register waits on a load from
//   device memory. The sums read the batch's rows from shared memory: first
//   every row's h = F_a * F_b * ... and d = v * h (independent), then
//   acc += d in order.
// * What sets its pace is how many warps share an SM more than how many
//   bytes each has in flight: the slots are small (4.4 KB a warp at K = 2,
//   48 registers), so ~40 warps share an SM. The first two versions of this
//   route (rows loaded into registers 32 nonzeros at a time; these slots
//   with 32 nonzeros a batch and AHEAD = 2), 16 and 8 warps an SM, took about
//   twice as long on the main path's streams (PERF.md); in uncommitted
//   probes (no number kept) smaller batches and AHEAD = 1 were each faster,
//   and the rows through L1 helped where the factors are small (mode 2).
// * The ids of a block are non-decreasing where the streaming schedule
//   hands them (a cumsum), so a segment's running sum lives in a register
//   and is stored once, when its run ends; the slots no row maps to are
//   stored as 0.0 on the way. No segment tile, no limit on S. An id that
//   comes back to a slot already stored reloads it (the same thread stored
//   it), so any order of ids in [0, S) still sums correctly; ids outside it
//   are skipped. Coordinates are not range-checked: the callers hold the
//   factors against the stream's coordinate ranges where they keep them.
//
// What bounds it (NVIDIA H100 80GB HBM3): not the bytes it must move (the
// coordinates, values and ids read once, the non-target factors once, the
// partials written once: ~0.09 ms at 16.8 M nonzeros of 3 modes, rank 32),
// but the factor rows it gathers, K * 4R bytes a nonzero (~4.3 GB at that
// size), from L2, and the warps it keeps in flight to cover their latency.
// Its time beside that bound is in PERF.md.
//
// The quantized variant (PSRAM; the psram-stream backend's compiled path):
// the chain rows are the quantized chain of core.mttkrp.psram_chain (8-bit
// operands and the ADC on every product), formed in the warp's slot before
// its sums, which do not change. Each quantization's scale reduces over the
// whole row, so a warp gathers the whole row (all R columns, not its
// tile's); a warp of another column tile forms the same rows again (R > 32
// only) and sums its own columns. Where R / 4 is a power of 2 up to 32 (R =
// 4 .. 128, the main path's 32 among them) a row is R / 4 lanes of 4
// columns, as the ordered fold's producers hold it: a warp forms 32 / (R /
// 4) rows a pass, each lane PSRAM_U rows at once in registers
// (hopper::psram_chain_pieces: each factor row read once from the slot, the
// running Hadamard kept in registers, the rows' shuffles and quotients
// interleaved, the chain row written back once); elsewhere the warp forms a
// row at a time, a column a lane, through the slot (psram_chain_row). No
// quotient is a division: a row's scale and the ADC's LSB are divided by
// through their reciprocals and two fma corrections, the IEEE quotient
// (hopper::psram_div). Bound by its operations (PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int BATCH = 32;                   // rows in flight per lane
constexpr int MAX_SMEM = hopper::MAX_DYNAMIC_SMEM;   // opt-in shared memory of a block

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

// ----------------------------------------------------------- route `chain`

using hopper::commit_group;
using hopper::cp_async16_ca;
using hopper::cp_async4;
using hopper::wait_group;

constexpr int CHAIN_WARPS = 4;              // warps a CTA, one (block, column tile) each
constexpr int TILE = 32;                    // rank columns a warp sums: lane = column
constexpr int AHEAD = 1;                    // batches a warp's gathers run ahead of its sums
constexpr int ROW_SLOTS = AHEAD + 1;        // + the batch in hand
constexpr int META_SLOTS = 2 * AHEAD + 1;
constexpr int SLOT_BUDGET = 2048;           // bytes of a batch's factor rows (one tile)
constexpr int PSRAM_U = 2;                  // quantized chain: rows a lane forms at once

__host__ __device__ constexpr int align16(int bytes) { return (bytes + 15) / 16 * 16; }

// Nonzeros a batch with K non-target modes: their K rows of one column tile
// fit SLOT_BUDGET (8 at K = 2, 2 at K = 7), at most 32 (lane = nonzero for
// the metadata copies).
__host__ __device__ constexpr int chain_nb(int K) {
    return SLOT_BUDGET / (4 * TILE * K) < 32 ? SLOT_BUDGET / (4 * TILE * K) : 32;
}
static_assert(chain_nb(hopper::CHAIN_MAX_MODES - 1) >= 1, "a batch holds a nonzero");

// A warp's row slot: the batch's rows of the K non-target factors, one
// column tile of each, row (k, j) at [(k * nb + j) * TILE]; the quantized
// variant's holds whole rows, row (k, j) at [(k * nb + j) * R].
__host__ __device__ constexpr int chain_row_slot(int K) { return 4 * K * chain_nb(K) * TILE; }
__host__ __device__ constexpr int chain_row_slot(int K, int R, bool psram) {
    return psram ? align16(4 * K * chain_nb(K) * R) : chain_row_slot(K);
}

// A warp's metadata slot: the batch's coordinates [j][k] i32, then its
// segment ids [j] i32, then its values [j] f32.
__host__ __device__ constexpr int chain_meta_slot(int K) {
    return align16(4 * chain_nb(K) * (K + 2));
}

__host__ __device__ constexpr int chain_warp_bytes(int K, int R = TILE, bool psram = false) {
    return ROW_SLOTS * chain_row_slot(K, R, psram) + META_SLOTS * chain_meta_slot(K);
}

// One warp per (block b, column tile): b = blockIdx.x * CHAIN_WARPS + warp,
// columns [blockIdx.y * TILE, + TILE) of R, lane = column. KT = K, the
// non-target modes; VEC: R % 4 == 0 and every factor 16-byte aligned
// (16-byte row copies, else 4-byte); PSRAM: the quantized chain at the ADC
// `adc` (whole rows gathered and formed in the slot, then this tile summed).
template <int KT, bool VEC, bool PSRAM>
__global__ void __launch_bounds__(32 * CHAIN_WARPS)
segment_chain_kernel(const int* __restrict__ coords, const float* __restrict__ val,
                     const int* __restrict__ seg_ids, hopper::ChainFactors fac,
                     float* __restrict__ out, long long nnz, int B, int bn, int R, int S,
                     hopper::PsramAdc adc) {
    constexpr int NB = chain_nb(KT);
    extern __shared__ __align__(16) unsigned char chain_buf[];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int b = blockIdx.x * CHAIN_WARPS + warp;
    if (b >= B) return;                             // the whole warp
    const int c0 = blockIdx.y * TILE;               // the tile's first column ...
    const int tw = R - c0 < TILE ? R - c0 : TILE;   // ... and its width
    const bool r_ok = lane < tw;
    // what a warp gathers of a row: its tile's columns, or the whole row
    // for the quantized chain; RS the floats of a row in the slot
    const int gc0 = PSRAM ? 0 : c0;
    const int gw = PSRAM ? R : tw;
    const int RS = PSRAM ? R : TILE;
    const int row_slot = chain_row_slot(KT, R, PSRAM);
    // the quantized chain's row layout: R / 4 lanes a row where that is a
    // power of 2 up to 32 (psram_chain_pieces), else the warp on a row
    const bool pieces = PSRAM && R % 4 == 0 && R <= 128 && ((R >> 2) & ((R >> 2) - 1)) == 0;
    const long long first = static_cast<long long>(b) * bn;
    const long long left = nnz - first;             // the block's nonzeros: positions < nnz
    const int n = left <= 0 ? 0 : left < bn ? static_cast<int>(left) : bn;
    const int L = (n + NB - 1) / NB;                // its batches
    float* __restrict__ dst = out + static_cast<size_t>(b) * S * R + c0;

    unsigned char* mine = chain_buf + warp * chain_warp_bytes(KT, R, PSRAM);
    auto rows_of = [&](int i) {
        return reinterpret_cast<float*>(mine + (i % ROW_SLOTS) * row_slot);
    };
    auto meta_of = [&](int i) {
        return reinterpret_cast<int*>(mine + ROW_SLOTS * row_slot
                                      + (i % META_SLOTS) * chain_meta_slot(KT));
    };
    auto count = [&](int i) { return n - i * NB < NB ? n - i * NB : NB; };
    // batch i's coordinates, ids and values into its metadata slot
    auto copy_meta = [&](int i) {
        const int cnt = count(i);
        const long long p0 = first + static_cast<long long>(i) * NB;
        int* m = meta_of(i);
        for (int e = lane; e < cnt * KT; e += 32) cp_async4(m + e, coords + p0 * KT + e);
        if (lane < cnt) {
            cp_async4(m + NB * KT + lane, seg_ids + p0 + lane);
            cp_async4(m + NB * (KT + 1) + lane, val + p0 + lane);
        }
    };
    // batch i's factor rows (this tile's columns) into its row slot, from the
    // coordinates already in its metadata slot: a row's 16-byte pieces go to
    // neighbouring lanes, so one copy instruction takes whole rows
    auto gather = [&](int i) {
        const int cnt = count(i);
        const int* m = meta_of(i);
        float* st = rows_of(i);
#pragma unroll
        for (int k = 0; k < KT; ++k) {
            const float* F = fac.f[k] + gc0;
            float* to = st + k * NB * RS;
            if constexpr (VEC) {
                if (!PSRAM && tw == TILE) {
                    for (int p = lane; p < cnt * (TILE / 4); p += 32) {
                        const int j = p / (TILE / 4);
                        const int q = 4 * (p % (TILE / 4));
                        cp_async16_ca(to + j * TILE + q,
                                   F + static_cast<long long>(m[j * KT + k]) * R + q);
                    }
                } else {
                    const int ppr = gw / 4;
                    for (int p = lane; p < cnt * ppr; p += 32) {
                        const int j = p / ppr;
                        const int q = 4 * (p - j * ppr);
                        cp_async16_ca(to + j * RS + q,
                                   F + static_cast<long long>(m[j * KT + k]) * R + q);
                    }
                }
            } else {
                for (int e = lane; e < cnt * gw; e += 32) {
                    const int j = e / gw;
                    const int c = e - j * gw;
                    cp_async4(to + j * RS + c, F + static_cast<long long>(m[j * KT + k]) * R + c);
                }
            }
        }
    };

    int cur = -1;            // the slot whose running sum is in `acc`
    int next = 0;            // slots [0, next) have been stored
    float acc = 0.0f;
    auto store = [&](int s, float x) {
        if (r_ok) dst[static_cast<size_t>(s) * R + lane] = x;
    };
    // batch i's chain rows: first every row's product (independent, so the
    // reads of the slot overlap), then the adds in order (the slot past the
    // batch's cnt rows holds stale rows, formed and never added). The
    // quantized chain is formed in the slot first, a row at a time by the
    // whole warp, and read from there.
    auto sum = [&](int i) {
        const int cnt = count(i);
        float* st = rows_of(i);
        const int* m = meta_of(i);
        const int* ids = m + NB * KT;
        const float* v = reinterpret_cast<const float*>(m + NB * (KT + 1));
        float d[NB];
        if constexpr (PSRAM) {
            if (pieces) {
                // R / 4 lanes a row, 4 columns a lane: piece p of the batch's
                // passes is row p / g's piece p % g, so a warp forms 32 / g
                // rows a pass and a lane PSRAM_U rows at once (the slot's
                // rows past cnt hold stale values: formed, never added)
                const int g = R >> 2;
                for (int p0 = 0; p0 * (32 / g) < NB; p0 += PSRAM_U) {
                    float* at[PSRAM_U];
                    bool live[PSRAM_U];
                    float vu[PSRAM_U];
#pragma unroll
                    for (int u = 0; u < PSRAM_U; ++u) {
                        const int p = lane + 32 * (p0 + u);
                        const int j = p / g;
                        live[u] = j < NB;
                        const int jj = live[u] ? j : 0;
                        at[u] = st + jj * R + 4 * (p - j * g);
                        vu[u] = v[jj];
                    }
                    hopper::psram_chain_pieces<PSRAM_U>(at, live, vu, NB * R, KT, g, adc);
                }
            } else {
                for (int j = 0; j < cnt; ++j) {
                    hopper::psram_chain_row(st + j * R, NB * R, KT, R, v[j], adc);
                }
            }
            __syncwarp();
#pragma unroll
            for (int j = 0; j < NB; ++j) d[j] = r_ok ? st[j * R + c0 + lane] : 0.0f;
        } else {
#pragma unroll
            for (int j = 0; j < NB; ++j) {
                float h = st[j * TILE + lane];
#pragma unroll
                for (int k = 1; k < KT; ++k) h = __fmul_rn(h, st[(k * NB + j) * TILE + lane]);
                d[j] = __fmul_rn(v[j], h);
            }
        }
#pragma unroll
        for (int j = 0; j < NB; ++j) {
            const int s = ids[j];                   // uniform across the warp
            if (j >= cnt || static_cast<unsigned>(s) >= static_cast<unsigned>(S)) continue;
            if (s != cur) {
                if (cur >= 0) store(cur, acc);
                if (s < next) {                     // back to a stored slot: unsorted ids
                    acc = r_ok ? dst[static_cast<size_t>(s) * R + lane] : 0.0f;
                } else {
                    for (; next < s; ++next) store(next, 0.0f);   // slots no row maps to
                    next = s + 1;
                    acc = 0.0f;
                }
                cur = s;
            }
            acc = __fadd_rn(acc, d[j]);
        }
    };

    if (L > 0) {
        // batches it + AHEAD (rows) and it + 2 AHEAD (metadata) ride ahead of it
        for (int i = 0; i < AHEAD; ++i) {
            if (i < L) copy_meta(i);
        }
        commit_group();
        wait_group<0>();
        __syncwarp();
        for (int i = 0; i < AHEAD; ++i) {
            if (i < L) gather(i);
            if (AHEAD + i < L) copy_meta(AHEAD + i);
            commit_group();
        }
        for (int it = 0; it < L; ++it) {
            wait_group<AHEAD - 1>();                // the group of it - AHEAD: rows of it,
            __syncwarp();                           // metadata of it + AHEAD (every lane's)
            if (it + AHEAD < L) gather(it + AHEAD);         // into the slot of it - 1
            if (it + 2 * AHEAD < L) copy_meta(it + 2 * AHEAD);
            commit_group();
            sum(it);
        }
        wait_group<0>();
    }
    if (cur >= 0) store(cur, acc);
    for (; next < S; ++next) store(next, 0.0f);
}

// Dynamic shared memory of a chain-route CTA with K non-target modes (at
// rank R, for the quantized variant's whole rows).
constexpr long long chain_smem(int K, int R = TILE, bool psram = false) {
    return static_cast<long long>(CHAIN_WARPS) * chain_warp_bytes(K, R, psram);
}
constexpr bool chain_fits() {
    for (int k = 1; k < hopper::CHAIN_MAX_MODES; ++k) {
        if (chain_smem(k) > hopper::MAX_DYNAMIC_SMEM) return false;
    }
    return true;
}
static_assert(chain_fits(), "a chain-route CTA's slots fit the opt-in shared memory");

template <int KT, bool VEC, bool PSRAM>
cudaError_t launch_chain_as(const int* coords, const float* val, const int* seg_ids,
                            const hopper::ChainFactors& fac, float* out, long long nnz, int B,
                            int bn, int R, int S, hopper::PsramAdc adc, cudaStream_t stream) {
    cudaError_t err = hopper::opt_in_max_smem<segment_chain_kernel<KT, VEC, PSRAM>>();
    if (err != cudaSuccess) return err;
    const dim3 grid((B + CHAIN_WARPS - 1) / CHAIN_WARPS, (R + TILE - 1) / TILE);
    segment_chain_kernel<KT, VEC, PSRAM><<<grid, 32 * CHAIN_WARPS,
                                           static_cast<size_t>(chain_smem(KT, R, PSRAM)),
                                           stream>>>(coords, val, seg_ids, fac, out, nnz, B, bn,
                                                     R, S, adc);
    return cudaGetLastError();
}

template <int KT>
cudaError_t launch_chain(const int* coords, const float* val, const int* seg_ids,
                         const hopper::ChainFactors& fac, float* out, long long nnz, int B,
                         int bn, int R, int S, int vec, int psram, hopper::PsramAdc adc,
                         cudaStream_t stream) {
    if (psram) {
        return vec ? launch_chain_as<KT, true, true>(coords, val, seg_ids, fac, out, nnz, B, bn,
                                                     R, S, adc, stream)
                   : launch_chain_as<KT, false, true>(coords, val, seg_ids, fac, out, nnz, B,
                                                      bn, R, S, adc, stream);
    }
    return vec ? launch_chain_as<KT, true, false>(coords, val, seg_ids, fac, out, nnz, B, bn, R,
                                                  S, adc, stream)
               : launch_chain_as<KT, false, false>(coords, val, seg_ids, fac, out, nnz, B, bn, R,
                                                   S, adc, stream);
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

// Route `chain`. coords (nnz, nmodes - 1) int32 row-major: the stream's
// non-target coordinates, nonzero p's k-th one (mode order) at
// coords[p * (nmodes - 1) + k]; val (nnz,) f32; seg_ids (B, bn) int32
// block-local ids (non-decreasing within a block where the caller can: the
// fast case; ids outside [0, S) are skipped); factors: a host array of the
// nmodes - 1 non-target factors' device pointers, in mode order, each
// (I_d, R) f32 row-major; out (B, S, R) f32; all contiguous. Block b sums
// the chain rows of positions [b * bn, min((b + 1) * bn, nnz)); nnz <= B * bn.
// vec: R % 4 == 0 and every factor 16-byte aligned. psram: the quantized
// chain (core.mttkrp.psram_chain) in place of the exact one, its products'
// ADC LSB lsb, largest code code_max and RN(1 / lsb) rlsb; refused where
// its whole rows do not fit shared memory (segment_chain_smem_bytes).
// Coordinates are not range-checked. Returns the launch's cudaError_t as an
// int.
extern "C" int segment_chain_launch(const void* coords, const void* val, const void* seg_ids,
                                    const void* const* factors, void* out, long long nnz, int B,
                                    int bn, int nmodes, int R, int S, int vec, int psram,
                                    float lsb, float code_max, float rlsb, void* stream_ptr) {
    if (B < 1 || bn < 1 || R < 1 || S < 1 || nnz < 0 || nnz > static_cast<long long>(B) * bn
        || nmodes < 2 || nmodes > hopper::CHAIN_MAX_MODES || (vec && R % 4 != 0)
        || (psram && (!(lsb > 0.0f && code_max >= 0.0f && rlsb > 0.0f)
                      || chain_smem(nmodes - 1, R, true) > MAX_SMEM))) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    hopper::ChainFactors fac;
    for (int k = 0; k < hopper::CHAIN_MAX_MODES - 1; ++k) {
        fac.f[k] = k < nmodes - 1 ? static_cast<const float*>(factors[k]) : nullptr;
    }
    const int* c = static_cast<const int*>(coords);
    const float* v = static_cast<const float*>(val);
    const int* ids = static_cast<const int*>(seg_ids);
    float* o = static_cast<float*>(out);
    cudaStream_t st = static_cast<cudaStream_t>(stream_ptr);
    const hopper::PsramAdc adc{lsb, code_max, rlsb};
    cudaError_t err;
    switch (nmodes - 1) {
        case 1: err = launch_chain<1>(c, v, ids, fac, o, nnz, B, bn, R, S, vec, psram, adc, st); break;
        case 2: err = launch_chain<2>(c, v, ids, fac, o, nnz, B, bn, R, S, vec, psram, adc, st); break;
        case 3: err = launch_chain<3>(c, v, ids, fac, o, nnz, B, bn, R, S, vec, psram, adc, st); break;
        case 4: err = launch_chain<4>(c, v, ids, fac, o, nnz, B, bn, R, S, vec, psram, adc, st); break;
        case 5: err = launch_chain<5>(c, v, ids, fac, o, nnz, B, bn, R, S, vec, psram, adc, st); break;
        case 6: err = launch_chain<6>(c, v, ids, fac, o, nnz, B, bn, R, S, vec, psram, adc, st); break;
        default: err = launch_chain<7>(c, v, ids, fac, o, nnz, B, bn, R, S, vec, psram, adc, st); break;
    }
    return static_cast<int>(err);
}

// Dynamic shared memory of a chain-route CTA for a stream of nmodes modes at
// rank R, of the quantized variant where psram (its slots hold whole rows);
// -1 where it does not fit the opt-in shared memory.
extern "C" long long segment_chain_smem_bytes(int nmodes, int R, int psram) {
    if (nmodes < 2 || nmodes > hopper::CHAIN_MAX_MODES || R < 1) return -1;
    const long long bytes = chain_smem(nmodes - 1, R, psram != 0);
    return bytes > MAX_SMEM ? -1 : bytes;
}

// The runtime's text for an error code returned by a launch entry.
extern "C" const char* segment_sum_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}
