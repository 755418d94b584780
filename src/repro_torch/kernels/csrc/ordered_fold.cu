// Ordered fold for Hopper (sm_90a): the exact sparse MTTKRP's CP3 scatter,
// with every output row's adds in stream order.
//
//   out[row] = ((out[row] + d[i0]) + d[i0 + 1]) + ... + d[i1 - 1]
//
// over each row's run [i0, i1) of a stream whose target ids are sorted. The
// fold starts from the row's current value, so calls over consecutive cuts of
// one stream compose into one in-order fold.
//
// No TPU kernel of the reference is replaced: the reference's exact sparse
// paths fold with one global jax.ops.segment_sum (src/repro/core/mttkrp.py:
// mttkrp_sparse, src/repro/sparse/stream.py's eager executor), which XLA adds
// in stream order, and the reference asserts the eager stream BIT-IDENTICAL
// to that scatter. On the card the port's index_add_ is atomic and adds in no
// fixed order; this kernel gives the order back, so the card's result is
// bit-equal to the CPU's index_add_ (stream order) and repeatable.
//
// Two routes, one contract: every add is one IEEE f32 add (__fadd_rn) in the
// order of the stream, starting from the row's value in `out` — index_add_'s
// order on the CPU.
//
// Route `fold` (ordered_fold_kernel): the contributions are given, as rows
// of d (n_d, R), the fold's stream row i being d[order[i]] where an order
// (P,) int64 is given (the blocked path's partials, read in place in their
// cached fold order) and d[i] where not. The runs longer than long_run come
// as a list, longest first (found on the host from the runs; the blocked
// path keeps it with them); each has a CTA of its own, scheduled first.
// The other CTAs take CTA_RUNS consecutive runs each, RUNS_PER_WARP a warp
// (an empty run costs no CTA, and no load beyond its bounds):
// * The runs of at most long_run rows (nearly every run: the blocked path's
//   rows hold 1 to a few dozen partials) are their warp's, lane = rank
//   column, folded in one pass over their rows as consecutive positions:
//   a batch of 32 positions has its 32 rows' loads all in flight before
//   their chain of adds, whichever runs they belong to, and the next
//   batch's gather indices load beside this batch's rows. So a warp waits
//   on memory about twice for 32 rows, not twice a run. No shared memory,
//   no CTA-wide barrier.
// * A longer run (the power-law head rows: ~9.8 k partials for mode 0 of
//   the main path) has a ring of STAGES shared-memory stages, each behind a
//   full and an empty mbarrier. Warp 0 adds, lane = rank column, loading
//   the next 16 rows of a stage beside the adds of these (at R = 32 with
//   immediate offsets). The other warps fill the ring with 16-byte cp.async
//   copies, each copying thread arriving on the stage's full barrier once
//   its copies landed; gathered rows' indices are copied STAGES - 1 stages
//   ahead into index slots of their own. R % 4 != 0 or a d off 16 bytes:
//   warp 1's own loads and stores. No CTA-wide barrier a stage.
// What paces it (NVIDIA H100 80GB HBM3, 700 W, chip_smoke.py): the short
// runs' CTAs take ~0.013 ms for modes 1-2 of the main path (75-94 k
// partials); mode 0's head row, ~0.045 ms, paced by its one chain of adds
// (~7 cycles a row against the ~4 of a dependent add). Measured on the way
// (one 9,770-row run): a ring that every thread filled through cp.async
// behind a CTA barrier a stage, ~15 cycles a row; a bulk copy a gathered
// row, ~30; the producers loading the indices themselves, even four stages
// ahead, ~2x the index slots; a CTA that folded its long runs one after
// another lost 25x on streams of runs of a few hundred rows. Only the long
// runs' CTAs take the ring's shared memory; a launch without one takes none.
// Bound by bytes: d's P rows read once, out read and written once, the
// order and the runs read once.
//
// Route `chain` (ordered_chain_kernel): the contributions are formed inside
// the CTA from the stream itself, so a whole exact sparse MTTKRP is one
// launch and no (n, R) temporary exists. For nonzero p of run s:
//   d_p = v_p * (F_a[i_pa] * F_b[i_pb] * ...)   (non-target modes a < b < ...)
// the Hadamard in mode order, then the value, each one __fmul_rn (no FMA), as
// the plain version's cp_chain_exact computes it; then one __fadd_rn into
// out[seg_rows[s]]. The run's row is the target coordinate, so the kernel
// reads only the non-target ones: coords (n, K) row-major, K = nmodes - 1,
// a batch's coordinates one contiguous block beside its values (two streams
// a batch; a column apiece was measured slower on a long run, its batch then
// waiting on K + 1 separate HBM fetches). One CTA per run (segment), 1 + P
// warps:
// * P producer warps take the run's batches (32 nonzeros at R = 16 / 32, 16
//   at 64, 8 at 128) in turn: batch g is warp g % P's. Each runs kernel 1's
//   two-level cp.async pipeline (csrc/stream_mttkrp.cu, the chunk route): a
//   batch's coordinates and values are copied into shared memory 2 AHEAD
//   batches before its products, and its factor rows gathered AHEAD batches
//   before (R / 4 lanes a row, 16 bytes each; 4-byte copies where the rows
//   are not 16-byte aligned), with coordinates that already landed there:
//   no register ever waits on a load from device memory. The producer then
//   forms d in place of the batch's first factor rows.
// * Hand-off: a full and an empty mbarrier a slot, one arrival a phase (a
//   warp's lane 0 after its __syncwarp), waited in try_wait, so a waiting
//   warp sleeps instead of taking instruction slots from the other CTAs on
//   its SM. No CTA-wide barrier after the barriers' initialisation.
// * Warp 0 owns the chain: lane = rank column (two or four neighbouring
//   columns a lane at R = 64 / 128; the running sums in shared memory for an
//   R that is not a template). It loads batch g + 1 in the same unrolled
//   pass as batch g's adds, so its dependent adds never wait on shared
//   memory.
// What bounds it (NVIDIA H100 80GB HBM3, 700 W, chip_smoke.py): not bytes.
// At mode 2 of the NELL-2-shaped tensor (16.8 M nonzeros, runs of at most
// 684) one launch takes ~1.3 ms against a 0.062 ms byte bound (the stream's
// non-target coordinates and values, the runs and the non-target factors
// read once, out read and written once); the ~4.3 GB of factor rows it
// gathers come from L2. The producers' instructions pace it: per nonzero and
// non-target mode the address arithmetic of R / 4 copies, and per 16 bytes
// of d two shared-memory reads, the products and a write.
// A long run is paced by its own CTA: its chain of dependent adds costs
// ~4 cycles a nonzero (the 2.5 M-nonzero head row of mode 0: ~5 ms), and
// the order is the contract, so that chain is never split into partial
// chains. Its producers and the consumer's per-batch hand-off set its pace
// above that floor (~19 ms for that row), so a launch whose longest run
// has LONG_RUN nonzeros or more gets LONG_PRODUCERS producer warps a CTA
// (chain_layout); the short runs keep DEFAULT_PRODUCERS, whose smaller
// rings let more CTAs share an SM.
//
// The chain route's quantized variant (the psram-stream backend's eager
// path, the reference's mttkrp_sparse_psram, src/repro/core/mttkrp.py:161,
// whose CP3 is XLA's segment_sum again): the producers form the quantized
// chain of core.mttkrp.psram_chain (8-bit operands and the ADC on every
// product) in place of the exact d; the consumer's adds in stream order do
// not change, so no (n, R) chain exists and the bits are the plain
// version's. At a template rank it is ordered_psram_kernel:
// * A producer forms a batch in registers (hopper::psram_chain_pieces): a
//   row is R / 4 lanes of 4 columns, so a scale's max over the row is a
//   sub-warp shuffle, and each lane carries 4 rows at once through the K +
//   1 steps, their shuffles and quotients interleaved; each factor row is
//   read once from shared memory and only the chain row written back. No
//   quotient is a division: x / scale and acc / lsb are formed from the
//   divisor's reciprocal (once a row, and the LSB's once a launch, from the
//   host) and two fma corrections, the IEEE quotient (hopper::psram_div,
//   held to __fdiv_rn by psram_division_probe_kernel). Batches of 2 KB of
//   chain rows (16 nonzeros at R = 32), 4 producer warps a CTA.
// * A run of LONG_RUN nonzeros or more is not one SM's: forming its chain
//   costs ~60 instructions a nonzero and column, ~4x its chain of adds. It
//   takes a thread-block cluster of CLUSTER CTAs: rank 0's one warp adds in
//   stream order from a ring in its shared memory, and the producer warps
//   of the other 7 SMs form its batches and push each into rank 0's ring
//   with one bulk copy (cp.async.bulk shared::cta -> shared::cluster,
//   complete_tx on the slot's full barrier); rank 0 frees a slot by a
//   remote arrival on the producer's own empty barrier. Batch g is still
//   the stream's positions g * nb ..., so the bits do not change. The long
//   runs' clusters and the short runs' CTAs (8 a cluster, each on its own)
//   are one launch, the clusters first, so the short runs do not wait
//   behind the head row; a launch without a long run is a plain launch.
// At another rank the warp forms a row at a time through shared memory
// (ordered_chain_kernel<0, true>, hopper::psram_chain_row, the same
// quotients). What bounds it: its producers' instructions (PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int FOLD_WARPS = 8;         // fold route: warps a CTA ...
constexpr int RUNS_PER_WARP = 8;      // ... consecutive runs a warp ...
constexpr int CTA_RUNS = FOLD_WARPS * RUNS_PER_WARP;   // ... and runs a CTA
constexpr int THREADS = 32 * FOLD_WARPS;
constexpr int STAGES = 6;             // fold route, a long run: ring depth
constexpr int STAGE_FLOATS = 4096;    // fold route: 16 KB a stage (whole rows: at least one) ...
constexpr int STAGE_ROWS = 128;       // ... and at most 128 rows (the adds' unrolled whole stage)
constexpr int FOLD_BATCH = 16;        // fold route: rows of a stage a long run's adds hold at once
constexpr int PRODUCERS = THREADS - 32;   // fold route: threads that copy a long run's gathered rows
constexpr int INDEX_SLOTS = 2 * STAGES;   // fold route: a long run's stages of gather indices
constexpr int MAX_SMEM = hopper::MAX_DYNAMIC_SMEM;   // opt-in dynamic shared memory of a CTA

constexpr int MAX_MODES = hopper::CHAIN_MAX_MODES;   // chain route: modes of the stream
constexpr int DEFAULT_PRODUCERS = 2;  // chain route: producer warps a CTA ...
constexpr int LONG_PRODUCERS = 6;     // ... and where a run is LONG_RUN nonzeros or more
constexpr long long LONG_RUN = 32768;
constexpr int AHEAD = 2;              // batches a producer's gathers run ahead of its products
constexpr int ROW_SLOTS = AHEAD + 2;  // + the batch in hand + one the consumer may still hold
constexpr int META_SLOTS = 2 * AHEAD + 1;
constexpr int MAX_NB = 32;            // nonzeros a batch (lane = nonzero for the metadata)
constexpr int SLOT_BUDGET = 4096;     // default bytes of a batch's factor rows

using hopper::commit_group;
using hopper::cp_async16;
using hopper::cp_async4;
using hopper::cp_async8;
using hopper::opt_in_max_smem;
using hopper::smem_u32;
using hopper::wait_group;

// ------------------------------------------------------------ route `fold`

constexpr unsigned FULL = 0xffffffffu;

__host__ __device__ constexpr long long align16(long long bytes) { return (bytes + 15) / 16 * 16; }

// rows a ring stage holds at rank R, and the byte offsets of a long-run CTA's
// dynamic shared memory: the ring of STAGES stages, R running sums, a full
// and an empty mbarrier a stage and one an index slot, then INDEX_SLOTS
// slots of gather indices
__host__ __device__ constexpr int rows_per_stage(int R) {
    return R >= STAGE_FLOATS ? 1 : STAGE_FLOATS / R < STAGE_ROWS ? STAGE_FLOATS / R : STAGE_ROWS;
}
__host__ __device__ constexpr long long fold_acc_offset(int R) {
    return align16(4ll * STAGES * rows_per_stage(R) * R);
}
__host__ __device__ constexpr long long fold_bar_offset(int R) {
    return fold_acc_offset(R) + align16(4ll * R);
}
__host__ __device__ constexpr long long fold_smem_bytes(int R) {
    return fold_bar_offset(R) + 8ll * (2 * STAGES + INDEX_SLOTS)
           + 8ll * INDEX_SLOTS * rows_per_stage(R);
}

// d's row for the fold's stream row i: order[i] (GATHER) or i
template <bool GATHER>
__device__ __forceinline__ long long source_row(const long long* __restrict__ order, long long i) {
    if constexpr (GATHER) {
        return order[i];
    } else {
        return i;
    }
}

// A warp's RUNS_PER_WARP consecutive runs s_first + r, lane r holding run
// r's first stream row `start` and row count `cnt` (0 for a run the CTA
// folds, or past the last run) — all the short ones folded in one pass, lane
// = rank column (32 columns at a time). The runs' rows are consecutive
// positions of the warp: a batch of 32 positions has lane j load the d row
// of position j (its gather index loaded a batch ahead), then the 32 rows'
// loads are all in flight before their chain of adds; a run that begins in
// the batch starts from its out row (loaded once, before the batches), and
// one that ends there is stored.
template <bool GATHER>
__device__ __forceinline__ void fold_runs_warp(float* __restrict__ out, const float* __restrict__ d,
                                               const long long* __restrict__ order,
                                               const long long* __restrict__ seg_rows,
                                               long long s_first, long long start, int cnt,
                                               int R, int lane) {
    constexpr int RPW = RUNS_PER_WARP;
    int pre = cnt;                                     // inclusive prefix of cnt over lanes < RPW
#pragma unroll
    for (int off = 1; off < RPW; off <<= 1) {
        const int t = __shfl_up_sync(FULL, pre, off);
        if (lane >= off) pre += t;
    }
    const int total = __shfl_sync(FULL, pre, RPW - 1);
    if (total == 0) return;
    pre -= cnt;                                        // exclusive
    const long long row = lane < RPW && cnt > 0
                              ? (seg_rows ? seg_rows[s_first + lane] : s_first + lane) : 0;
    // the position p0 + lane: its run, its d row, and which positions of the
    // batch begin or end a run (the same in every lane)
    struct Batch { long long idx; int run; unsigned firsts, lasts; };
    auto locate = [&](int p0) {
        const int p = p0 + lane;
        int run = 0;
        long long srow = 0;
        bool first = false, last = false;
#pragma unroll
        for (int q = 0; q < RPW; ++q) {
            const int pq = __shfl_sync(FULL, pre, q);
            const int cq = __shfl_sync(FULL, cnt, q);
            const long long sq = __shfl_sync(FULL, start, q);
            if (p >= pq && p < pq + cq) {
                run = q;
                srow = sq + (p - pq);
                first = p == pq;
                last = p == pq + cq - 1;
            }
        }
        const bool in = p < total;
        Batch bt;
        bt.idx = in ? source_row<GATHER>(order, srow) : 0ll;
        bt.run = run;
        bt.firsts = __ballot_sync(FULL, in && first);
        bt.lasts = __ballot_sync(FULL, in && last);
        return bt;
    };
    for (int c0 = 0; c0 < R; c0 += 32) {
        const int c = c0 + lane;
        const bool has = c < R;
        float init[RPW];                               // each run's starting value
#pragma unroll
        for (int q = 0; q < RPW; ++q) {                // every lane shuffles
            const long long rq = __shfl_sync(FULL, row, q);
            const int cq = __shfl_sync(FULL, cnt, q);
            init[q] = has && cq > 0 ? out[rq * R + c] : 0.0f;
        }
        float acc = 0.0f;
        Batch cur = locate(0);
        for (int p0 = 0; p0 < total; p0 += 32) {
            float x[32];
#pragma unroll
            for (int u = 0; u < 32; ++u) {
                const long long r = __shfl_sync(FULL, cur.idx, u);
                x[u] = has && p0 + u < total ? d[r * R + c] : 0.0f;
            }
            const Batch nxt = locate(p0 + 32);        // its gather indices load beside x
#pragma unroll
            for (int u = 0; u < 32; ++u) {
                if (p0 + u < total) {
                    if ((cur.firsts >> u) & 1u) {
                        const int q = __shfl_sync(FULL, cur.run, u);
                        acc = init[0];
#pragma unroll
                        for (int k = 1; k < RPW; ++k) acc = q == k ? init[k] : acc;
                    }
                    acc = __fadd_rn(acc, x[u]);
                    if ((cur.lasts >> u) & 1u) {
                        const long long rq = __shfl_sync(FULL, row, __shfl_sync(FULL, cur.run, u));
                        if (has) out[rq * R + c] = acc;
                    }
                }
            }
            cur = nxt;
        }
    }
}

// A long run, its CTA's only work: stream rows [first, first + n) folded
// into dst through the ring by warp 0 (the adds) and the producers (the
// copies: every other warp where rows are 16-byte pieces, warp 1
// otherwise). Stage st is in slot st % STAGES, its mbarriers' phase st /
// STAGES. RT: R where it
// is 32 (the adds' loads then take immediate offsets instead of a chain of
// address adds beside the chain of float adds), else 0.
template <bool VEC, bool GATHER, int RT>
__device__ __forceinline__ void fold_run_ring(float* __restrict__ dst, const float* __restrict__ d,
                                              const long long* __restrict__ order, long long first,
                                              long long n, int R, unsigned char* smem) {
    const int lane = threadIdx.x & 31;
    const int rps = rows_per_stage(R);
    const int stage_floats = rps * R;
    float* ring = reinterpret_cast<float*>(smem);
    float* acc = reinterpret_cast<float*>(smem + fold_acc_offset(R));
    unsigned long long* bars = reinterpret_cast<unsigned long long*>(smem + fold_bar_offset(R));
    long long* ords = reinterpret_cast<long long*>(bars + 2 * STAGES + INDEX_SLOTS);
    auto full = [&](int st) { return smem_u32(bars + st % STAGES); };
    auto empty = [&](int st) { return smem_u32(bars + STAGES + st % STAGES); };
    auto idx_full = [&](int st) { return smem_u32(bars + 2 * STAGES + st % INDEX_SLOTS); };
    const int n_stages = static_cast<int>((n + rps - 1) / rps);
    auto rows_of = [&](int st) {
        const long long left = n - static_cast<long long>(st) * rps;
        return static_cast<int>(left < rps ? left : rps);
    };

    if (threadIdx.x >= 32) {
        // ---- the producers (warps 1 to FOLD_WARPS - 1): 16-byte cp.async
        // copies, piece p of the stage (row p / (R / 4), its 16 bytes p % (R
        // / 4), so a row's pieces are neighbouring lanes') producer thread p
        // % NP's, each thread arriving on the full barrier once its copies
        // landed (cp.async.mbarrier.arrive); gathered rows' source offsets
        // are loaded a stage ahead. Elsewhere (R % 4 != 0, d off 16 bytes)
        // warp 1 copies the rows itself.
        const int pt = threadIdx.x - 32;               // producer thread
        const int ppr = R / 4;
        // gathered rows: stage st's indices in index slot st % INDEX_SLOTS,
        // copied STAGES - 1 stages ahead by the producers (index j of the
        // stage by thread j) and counted on the slot's index barrier
        auto fetch_indices = [&](int st) {
            if (st >= n_stages) return;
            long long* to = ords + (st % INDEX_SLOTS) * rps;
            const long long* from = order + first + static_cast<long long>(st) * rps;
            for (int j = pt; j < rows_of(st); j += PRODUCERS) cp_async8(to + j, from + j);
            hopper::cp_async_arrive(idx_full(st));
        };
        if constexpr (VEC && GATHER) {
            for (int st = 0; st < STAGES - 1; ++st) fetch_indices(st);
        }
        for (int st = 0; st < n_stages; ++st) {
            hopper::mbar_wait(empty(st), ((st / STAGES) & 1u) ^ 1u);   // the first pass is free
            const int nr = rows_of(st);
            float* to = ring + (st % STAGES) * stage_floats;
            if constexpr (VEC) {
                const long long* idx = nullptr;
                if constexpr (GATHER) {
                    // the index slot of stage st + STAGES - 1 held stage st
                    // - STAGES - 1's, whose rows every producer issued before
                    // the consumer freed stage st - STAGES (this slot's empty
                    // wait)
                    fetch_indices(st + STAGES - 1);
                    hopper::mbar_wait(idx_full(st), (st / INDEX_SLOTS) & 1u);
                    idx = ords + (st % INDEX_SLOTS) * rps;
                }
                const long long row0 = first + static_cast<long long>(st) * rps;
                for (int p = pt; p < nr * ppr; p += PRODUCERS) {   // row p / ppr's piece
                    const int j = p / ppr;
                    const long long r = GATHER ? idx[j] : row0 + j;
                    cp_async16(to + 4 * p, d + r * R + 4 * (p - j * ppr));
                }
                hopper::cp_async_arrive(full(st));
            } else {
                for (int e = lane; e < nr * R; e += 32) {
                    const int j = e / R;
                    to[e] = d[source_row<GATHER>(order, first + static_cast<long long>(st) * rps + j) * R
                              + (e - j * R)];
                }
                __syncwarp();
                if (lane == 0) hopper::mbar_arrive(full(st));
            }
        }
    } else {
        // ---- the adds, warp 0: lane = rank column
        for (int c = lane; c < R; c += 32) acc[c] = dst[c];
        for (int st = 0; st < n_stages; ++st) {
            hopper::mbar_wait(full(st), (st / STAGES) & 1u);
            const float* slot = ring + (st % STAGES) * stage_floats;
            const int nr = rows_of(st);
            if (nr == STAGE_ROWS) {                    // a whole stage (R <= 32): fully unrolled
                const int stride = RT ? RT : R;
                for (int c = lane; c < R; c += 32) {
                    float v = acc[c];
                    float x[2][FOLD_BATCH];
                    auto load = [&](float (&y)[FOLD_BATCH], int i) {
#pragma unroll
                        for (int u = 0; u < FOLD_BATCH; ++u) y[u] = slot[(i + u) * stride + c];
                    };
                    load(x[0], 0);
#pragma unroll
                    for (int b = 0; b < STAGE_ROWS / FOLD_BATCH; ++b) {
                        if (b + 1 < STAGE_ROWS / FOLD_BATCH) load(x[(b + 1) & 1], (b + 1) * FOLD_BATCH);
#pragma unroll
                        for (int u = 0; u < FOLD_BATCH; ++u) v = __fadd_rn(v, x[b & 1][u]);
                    }
                    acc[c] = v;
                }
                __syncwarp();
                if (lane == 0) hopper::mbar_arrive(empty(st));
                continue;
            }
            const int full_rows = nr & ~(FOLD_BATCH - 1);
            for (int c = lane; c < R; c += 32) {
                // rows i .. i + FOLD_BATCH - 1 in xa, the next batch loaded
                // into xb beside their adds: the chain never waits on a load
                float v = acc[c];
                float xa[FOLD_BATCH], xb[FOLD_BATCH];
                auto load = [&](float (&x)[FOLD_BATCH], int i) {
#pragma unroll
                    for (int u = 0; u < FOLD_BATCH; ++u) x[u] = slot[(i + u) * R + c];
                };
                auto add = [&](const float (&x)[FOLD_BATCH]) {
#pragma unroll
                    for (int u = 0; u < FOLD_BATCH; ++u) v = __fadd_rn(v, x[u]);
                };
                int i = 0;
                if (full_rows > 0) load(xa, 0);
                for (; i + 2 * FOLD_BATCH <= full_rows; i += 2 * FOLD_BATCH) {
                    load(xb, i + FOLD_BATCH);
                    add(xa);
                    if (i + 2 * FOLD_BATCH < full_rows) load(xa, i + 2 * FOLD_BATCH);
                    add(xb);
                }
                if (i < full_rows) {
                    add(xa);
                    i += FOLD_BATCH;
                }
                for (; i < nr; ++i) v = __fadd_rn(v, slot[i * R + c]);
                acc[c] = v;
            }
            __syncwarp();                              // every lane's reads of the slot are done
            if (lane == 0) hopper::mbar_arrive(empty(st));
        }
        for (int c = lane; c < R; c += 32) dst[c] = acc[c];
    }
}

// Run s folds stream rows [seg_ptr[s] - base, seg_ptr[s+1] - base) into out
// row seg_rows[s] (row s where seg_rows is null). The first n_long CTAs
// take the runs long_runs[0..n_long) (each more than long_run rows), one a
// CTA through the ring; the others CTA_RUNS consecutive runs each,
// RUNS_PER_WARP a warp, skipping the long ones.
template <bool VEC, bool GATHER>
__global__ void __launch_bounds__(THREADS, 2)
ordered_fold_kernel(float* __restrict__ out, const float* __restrict__ d,
                    const long long* __restrict__ order, const long long* __restrict__ seg_ptr,
                    const long long* __restrict__ seg_rows, long long base, long long n_seg,
                    const long long* __restrict__ long_runs, int n_long, int R,
                    long long long_run) {
    static_assert(CTA_RUNS == 64 && 32 % RUNS_PER_WARP == 0, "two runs a lane, whole warps");
    extern __shared__ __align__(16) unsigned char fold_smem[];
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    if (static_cast<int>(blockIdx.x) < n_long) {
        const long long s = long_runs[blockIdx.x];
        const long long lo = seg_ptr[s] - base;
        if (threadIdx.x == 0) {
            // full: each producer thread's once its cp.async copies landed,
            // or warp 1's one arrival; empty: warp 0's
            unsigned long long* bars =
                reinterpret_cast<unsigned long long*>(fold_smem + fold_bar_offset(R));
            for (int i = 0; i < STAGES; ++i) {
                hopper::mbar_init(smem_u32(bars + i), VEC ? PRODUCERS : 1);
                hopper::mbar_init(smem_u32(bars + STAGES + i), 1);
            }
            for (int i = 0; i < INDEX_SLOTS; ++i) {
                hopper::mbar_init(smem_u32(bars + 2 * STAGES + i), PRODUCERS);
            }
            hopper::mbar_init_fence();
        }
        __syncthreads();                               // the one CTA-wide barrier
        if (warp >= (VEC ? FOLD_WARPS : 2)) return;   // warps with no part in the ring
        float* dst = out + (seg_rows ? seg_rows[s] : s) * R;
        const long long n = seg_ptr[s + 1] - base - lo;
        if (R == 32) {
            fold_run_ring<VEC, GATHER, 32>(dst, d, order, lo, n, R, fold_smem);
        } else {
            fold_run_ring<VEC, GATHER, 0>(dst, d, order, lo, n, R, fold_smem);
        }
        return;
    }
    const long long s0 = static_cast<long long>(blockIdx.x - n_long) * CTA_RUNS;
    long long lo[2] = {0, 0}, len[2] = {0, 0};        // lane j: runs s0 + j and s0 + 32 + j
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const long long s = s0 + 32 * h + lane;
        if (s < n_seg) {
            lo[h] = seg_ptr[s] - base;
            len[h] = seg_ptr[s + 1] - base - lo[h];
        }
    }
    // this warp's runs: lanes l0.. of half h; lane r < RUNS_PER_WARP takes run r's
    const int first = warp * RUNS_PER_WARP;
    const int h = first >> 5;
    const int src = (first & 31) + (lane & (RUNS_PER_WARP - 1));
    const long long start = __shfl_sync(FULL, h ? lo[1] : lo[0], src);
    const long long n = __shfl_sync(FULL, h ? len[1] : len[0], src);
    const bool mine = lane < RUNS_PER_WARP && n <= long_run;    // a long run has a CTA of its own
    fold_runs_warp<GATHER>(out, d, order, seg_rows, s0 + first, start,
                           mine ? static_cast<int>(n) : 0, R, lane);
}

template <bool VEC, bool GATHER>
cudaError_t launch_fold(float* out, const float* d, const long long* order,
                        const long long* seg_ptr, const long long* seg_rows, long long base,
                        long long n_seg, const long long* long_runs, int n_long, int R,
                        long long long_run, cudaStream_t stream) {
    cudaError_t err = opt_in_max_smem<ordered_fold_kernel<VEC, GATHER>>();
    if (err != cudaSuccess) return err;
    const long long ctas = n_long + (n_seg + CTA_RUNS - 1) / CTA_RUNS;
    // the ring's shared memory only where a long run needs it
    const size_t smem = n_long > 0 ? static_cast<size_t>(fold_smem_bytes(R)) : 0;
    ordered_fold_kernel<VEC, GATHER><<<static_cast<unsigned>(ctas), THREADS, smem, stream>>>(
        out, d, order, seg_ptr, seg_rows, base, n_seg, long_runs, n_long, R, long_run);
    return cudaGetLastError();
}

// ----------------------------------------------------------- route `chain`

using Factors = hopper::ChainFactors;   // the non-target factors, in mode order

// Columns a consumer lane owns at a template rank (0: an R that is not one).
__host__ __device__ constexpr int lane_cols(int RT) { return RT >= 128 ? 4 : RT == 64 ? 2 : 1; }

// Nonzeros a batch at a template rank: the consumer keeps a batch in 32
// registers a lane.
__host__ __device__ constexpr int template_nb(int RT) { return 32 / lane_cols(RT); }

// A producer's row slot: the batch's rows of the K non-target factors,
// [k][j][R] floats; d is formed in place of k = 0.
__host__ __device__ constexpr int chain_row_slot(int K, int R, int nb) {
    return align16(4ll * K * nb * R);
}

// A producer's metadata slot: the batch's non-target coordinates [j][k]
// i32, then its values [j] f32.
__host__ __device__ constexpr int chain_meta_slot(int K, int nb) {
    return align16(4ll * nb * (K + 1));
}

__host__ __device__ constexpr int chain_warp_bytes(int K, int R, int nb) {
    return ROW_SLOTS * chain_row_slot(K, R, nb) + META_SLOTS * chain_meta_slot(K, nb);
}

// Bytes before the rings: the full and empty barriers of every producer's
// row slots.
__host__ __device__ constexpr int chain_head_bytes(int producers) {
    return align16(16ll * producers * ROW_SLOTS);
}

// The CTA's dynamic shared memory: the head, the producers' rings, R
// running sums (used where R is not a template rank).
__host__ __device__ constexpr long long chain_smem(int K, int R, int nb, int producers) {
    return chain_head_bytes(producers)
           + static_cast<long long>(producers) * chain_warp_bytes(K, R, nb) + align16(4ll * R);
}

// One CTA per run s: stream positions [seg_ptr[s], seg_ptr[s+1]) folded into
// out row seg_rows[s] (row s where seg_rows is null); coords holds the K
// non-target coordinates of the stream's nonzero p at coords[p * K + k]. RT
// is R where it is 16, 32, 64 or 128 (batches of template_nb(RT) nonzeros;
// the consumer's running sums and batches in registers), else 0 (the same
// kernel with runtime loops over R, batches of nb nonzeros, the running sums
// in shared memory). PSRAM (RT = 0 only): the producers form the quantized
// chain (hopper::psram_chain_row, at the ADC `adc`) in place of the exact one.
template <int RT, bool PSRAM>
__global__ void __launch_bounds__(32 * (1 + LONG_PRODUCERS))
ordered_chain_kernel(float* __restrict__ out, const int* __restrict__ coords,
                     const float* __restrict__ val, Factors fac,
                     const long long* __restrict__ seg_ptr,
                     const long long* __restrict__ seg_rows,
                     int K, int r_runtime, int nb_runtime, int vec_copy, hopper::PsramAdc adc) {
    extern __shared__ __align__(16) unsigned char chain_smem_buf[];
    unsigned char* smem = chain_smem_buf;
    constexpr int NBT = RT ? template_nb(RT) : 0;
    const int R = RT ? RT : r_runtime;
    const int nb = RT ? NBT : nb_runtime;
    const long long lo = seg_ptr[blockIdx.x];
    const long long n = seg_ptr[blockIdx.x + 1] - lo;
    if (n <= 0) return;                                // the whole CTA leaves: an empty row
    const long long row = seg_rows ? seg_rows[blockIdx.x] : static_cast<long long>(blockIdx.x);
    const int P = static_cast<int>(blockDim.x >> 5) - 1;
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int row_slot = chain_row_slot(K, R, nb);
    const int meta_slot = chain_meta_slot(K, nb);
    const int warp_bytes = chain_warp_bytes(K, R, nb);
    // a slot's full barrier: its producer formed d there; empty: the
    // consumer is done with it. One arrival a phase: a warp's lane 0, after
    // its __syncwarp. A waiting warp sleeps in try_wait instead of taking
    // instruction slots from the other CTAs on its SM.
    unsigned long long* bars = reinterpret_cast<unsigned long long*>(smem);
    auto full_bar = [&](int w, int s) { return smem_u32(bars + w * ROW_SLOTS + s); };
    auto empty_bar = [&](int w, int s) { return smem_u32(bars + (P + w) * ROW_SLOTS + s); };
    unsigned char* rings = smem + chain_head_bytes(P);
    float* acc_smem = reinterpret_cast<float*>(rings + static_cast<long long>(P) * warp_bytes);
    auto slot_of = [&](int w, int s) {
        return reinterpret_cast<float*>(rings + static_cast<long long>(w) * warp_bytes
                                        + s * row_slot);
    };
    const int n_batches = static_cast<int>((n + nb - 1) / nb);
    auto batch_count = [&](int g) {
        const long long left = n - static_cast<long long>(g) * nb;
        return static_cast<int>(left < nb ? left : nb);
    };

    if (threadIdx.x == 0) {
        for (int i = 0; i < 2 * P * ROW_SLOTS; ++i) hopper::mbar_init(smem_u32(bars + i), 1);
    }
    __syncthreads();                                   // the only CTA-wide barrier

    if (warp > 0) {
        // ---- producer w: its local batches i = 0, 1, ... are the run's
        // batches w + i * P
        const int w = warp - 1;
        unsigned char* meta_ring = rings + static_cast<long long>(w) * warp_bytes
                                   + ROW_SLOTS * row_slot;
        const int L = w < n_batches ? (n_batches - 1 - w) / P + 1 : 0;
        // a metadata slot: coordinate k of the batch's nonzero j at [j * K + k]
        auto meta_idx = [&](int ms) { return reinterpret_cast<int*>(meta_ring + ms * meta_slot); };
        auto meta_val = [&](int ms) { return reinterpret_cast<float*>(meta_idx(ms) + nb * K); };
        auto copy_meta = [&](int i, int ms) {
            const int g = w + i * P;
            const int cnt = batch_count(g);
            const long long p0 = lo + static_cast<long long>(g) * nb;
            int* mi = meta_idx(ms);
            float* mv = meta_val(ms);
            const int* src = coords + p0 * K;
            for (int e = lane; e < cnt * K; e += 32) cp_async4(mi + e, src + e);
            for (int e = lane; e < cnt; e += 32) cp_async4(mv + e, val + p0 + e);
        };
        // the batch's rows of every non-target factor, the k-th one's row j
        // at st + (k * nb + j) * R: a row is copied by R / 4 neighbouring
        // lanes, 16 bytes each, so a copy instruction touches each row's
        // sectors once (4-byte copies where the rows are not 16-byte aligned)
        auto gather = [&](int i, int ms, int rs) {
            const int cnt = batch_count(w + i * P);
            const int* mi = meta_idx(ms);
            float* st = slot_of(w, rs);
            for (int k = 0; k < K; ++k) {
                const float* F = fac.f[k];
                const int* rk = mi + k;                    // nonzero j's at rk[j * K]
                float* dst = st + k * nb * R;
                if constexpr (RT != 0) {
                    constexpr int PPR = RT / 4;            // 16-byte pieces a row
                    constexpr int U = NBT * PPR / 32;      // pieces a lane
                    if (vec_copy && cnt == NBT) {          // a full batch: every lane's rows first
                        int r[U];
#pragma unroll
                        for (int u = 0; u < U; ++u) r[u] = rk[((lane + 32 * u) / PPR) * K];
#pragma unroll
                        for (int u = 0; u < U; ++u) {
                            const int j = (lane + 32 * u) / PPR;
                            const int q = 4 * ((lane + 32 * u) % PPR);
                            cp_async16(dst + j * RT + q,
                                       F + static_cast<long long>(r[u]) * RT + q);
                        }
                        continue;
                    }
                }
                if (vec_copy) {
                    const int ppr = R / 4;
                    for (int p = lane; p < cnt * ppr; p += 32) {
                        const int j = p / ppr;
                        const int q = 4 * (p - j * ppr);
                        cp_async16(dst + j * R + q, F + static_cast<long long>(rk[j * K]) * R + q);
                    }
                } else {
                    for (int e = lane; e < cnt * R; e += 32) {
                        const int j = e / R;
                        const int c = e - j * R;
                        cp_async4(dst + j * R + c, F + static_cast<long long>(rk[j * K]) * R + c);
                    }
                }
            }
        };
        // d = v * (F_a * F_b * ...) in place of the first factor's rows, a
        // 16-byte piece at a time: piece p of the batch is row p / (R / 4)'s
        // piece p % (R / 4), so a warp's 32 pieces are whole rows
        auto form = [&](int i, int ms, int rs) {
            const int cnt = batch_count(w + i * P);
            const float* mv = meta_val(ms);
            float* st = slot_of(w, rs);
            const int stride = nb * R;
            if constexpr (PSRAM) {
                // the quantized chain at a rank that is not a template one
                // (ordered_psram_kernel takes those): the whole warp takes
                // one row at a time, a column a lane
                static_assert(RT == 0, "the quantized chain at a template rank is ordered_psram_kernel's");
                for (int j = 0; j < cnt; ++j) {
                    hopper::psram_chain_row(st + j * R, stride, K, R, mv[j], adc);
                }
                return;
            }
            auto mul4 = [](float4 a, float4 b) {
                return make_float4(__fmul_rn(a.x, b.x), __fmul_rn(a.y, b.y), __fmul_rn(a.z, b.z),
                                   __fmul_rn(a.w, b.w));
            };
            if constexpr (RT != 0) {
                constexpr int PPR = RT / 4;
                constexpr int U = NBT * PPR / 32;
                if (cnt == NBT) {                      // a full batch: every lane's pieces at once
                    float4 h[U];
#pragma unroll
                    for (int u = 0; u < U; ++u) {
                        const int p = lane + 32 * u;
                        h[u] = reinterpret_cast<const float4*>(st + (p / PPR) * RT)[p % PPR];
                    }
                    for (int k = 1; k < K; ++k) {
#pragma unroll
                        for (int u = 0; u < U; ++u) {
                            const int p = lane + 32 * u;
                            h[u] = mul4(h[u], reinterpret_cast<const float4*>(
                                                  st + k * stride + (p / PPR) * RT)[p % PPR]);
                        }
                    }
#pragma unroll
                    for (int u = 0; u < U; ++u) {
                        const int p = lane + 32 * u;
                        const float v = mv[p / PPR];
                        reinterpret_cast<float4*>(st + (p / PPR) * RT)[p % PPR] =
                            mul4(make_float4(v, v, v, v), h[u]);
                    }
                    return;
                }
            }
            if (R % 4 == 0) {
                const int ppr = R / 4;
                for (int p = lane; p < cnt * ppr; p += 32) {
                    const int j = p / ppr;
                    float4* at = reinterpret_cast<float4*>(st + j * R) + (p - j * ppr);
                    float4 h = *at;
                    for (int k = 1; k < K; ++k) {
                        h = mul4(h, *reinterpret_cast<const float4*>(reinterpret_cast<const float*>(at) + k * stride));
                    }
                    const float v = mv[j];
                    *at = mul4(make_float4(v, v, v, v), h);
                }
            } else {
                for (int e = lane; e < cnt * R; e += 32) {
                    const int j = e / R;
                    const int at = j * R + (e - j * R);
                    float h = st[at];
                    for (int k = 1; k < K; ++k) h = __fmul_rn(h, st[at + k * stride]);
                    st[at] = __fmul_rn(mv[j], h);
                }
            }
        };

        // iterations it + AHEAD (rows) and it + 2 AHEAD (metadata) ride ahead of it
        for (int i = 0; i < AHEAD; ++i) {
            if (i < L) copy_meta(i, i);
        }
        commit_group();
        wait_group<0>();
        __syncwarp();
        for (int i = 0; i < AHEAD; ++i) {              // the first row slots are free
            if (i < L) gather(i, i, i);
            if (AHEAD + i < L) copy_meta(AHEAD + i, AHEAD + i);
            commit_group();
        }
        for (int it = 0; it < L; ++it) {
            wait_group<AHEAD - 1>();                   // the group of it - AHEAD: rows of it,
            __syncwarp();                              // metadata of it + AHEAD (every lane's)
            const int ahead = it + AHEAD;
            if (ahead < L) {
                const int rs = ahead % ROW_SLOTS;
                if (ahead >= ROW_SLOTS) {          // the consumer is done with its previous batch
                    hopper::mbar_wait(empty_bar(w, rs),
                                      static_cast<uint32_t>((ahead / ROW_SLOTS - 1) & 1));
                }
                gather(ahead, ahead % META_SLOTS, rs);
            }
            if (it + 2 * AHEAD < L) copy_meta(it + 2 * AHEAD, (it + 2 * AHEAD) % META_SLOTS);
            commit_group();
            const int rs = it % ROW_SLOTS;
            form(it, it % META_SLOTS, rs);
            __syncwarp();                              // every lane's d is in the slot
            if (lane == 0) hopper::mbar_arrive(full_bar(w, rs));   // release
        }
        wait_group<0>();
        return;
    }

    // ---- the consumer, warp 0: batch g of the run is producer w = g % P's
    // local batch i = g / P, in its row slot i % ROW_SLOTS; a cursor (w, i)
    // walks them without a division
    float* dst = out + row * R;
    struct Cursor { int w, i; };
    auto next = [&](Cursor c) {
        if (++c.w == P) {
            c.w = 0;
            ++c.i;
        }
        return c;
    };
    auto wait_formed = [&](Cursor c) {                 // the batch's d is in its slot
        hopper::mbar_wait(full_bar(c.w, c.i % ROW_SLOTS), static_cast<uint32_t>((c.i / ROW_SLOTS) & 1));
        return slot_of(c.w, c.i % ROW_SLOTS);
    };
    auto release = [&](Cursor c) {                     // after every lane's reads of the batch
        __syncwarp();
        if (lane == 0) hopper::mbar_arrive(empty_bar(c.w, c.i % ROW_SLOTS));
    };
    if constexpr (RT == 0) {
        for (int c = lane; c < R; c += 32) acc_smem[c] = dst[c];
        Cursor cur{0, 0};
        for (int g = 0; g < n_batches; ++g, cur = next(cur)) {
            const float* st = wait_formed(cur);
            const int cnt = batch_count(g);
            for (int c = lane; c < R; c += 32) {
                float a = acc_smem[c];
                for (int j = 0; j < cnt; ++j) a = __fadd_rn(a, st[j * R + c]);
                acc_smem[c] = a;
            }
            release(cur);
        }
        for (int c = lane; c < R; c += 32) dst[c] = acc_smem[c];
    } else {
        constexpr int V = lane_cols(RT);
        const int c0 = lane * V;
        const bool has = c0 < RT;                      // R = 16: lanes 16..31 add nothing
        float acc[V];
        float buf[2][NBT][V];
#pragma unroll
        for (int v = 0; v < V; ++v) acc[v] = has ? dst[c0 + v] : 0.0f;
        auto get = [&](const float* st, int j, float (&x)[NBT][V]) {
            const float* at = st + j * RT + c0;
            if constexpr (V == 4) {
                const float4 t = *reinterpret_cast<const float4*>(at);
                x[j][0] = t.x; x[j][1] = t.y; x[j][2] = t.z; x[j][3] = t.w;
            } else if constexpr (V == 2) {
                const float2 t = *reinterpret_cast<const float2*>(at);
                x[j][0] = t.x; x[j][1] = t.y;
            } else {
                x[j][0] = *at;
            }
        };
        auto add = [&](int j, const float (&x)[NBT][V]) {
#pragma unroll
            for (int v = 0; v < V; ++v) acc[v] = __fadd_rn(acc[v], x[j][v]);
        };
        // batch g + 1 is loaded in the same unrolled pass as batch g's adds
        // (a load of row j beside the add of row j), so the chain never waits
        // on shared memory; batch g's slot is freed once its adds are done
        Cursor at{0, 0};                               // batch g's
        auto step = [&](int g, float (&cur)[NBT][V], float (&nxt)[NBT][V]) {
            const int cnt = batch_count(g);
            const Cursor ahead = next(at);
            if (g + 1 < n_batches) {
                const float* st = wait_formed(ahead);
                const int cnt1 = batch_count(g + 1);
                if (has && cnt == NBT && cnt1 == NBT) {
#pragma unroll
                    for (int j = 0; j < NBT; ++j) {
                        get(st, j, nxt);
                        add(j, cur);
                    }
                } else {
#pragma unroll
                    for (int j = 0; j < NBT; ++j) {
                        if (has && j < cnt1) get(st, j, nxt);
                        if (j < cnt) add(j, cur);
                    }
                }
            } else {
#pragma unroll
                for (int j = 0; j < NBT; ++j) {
                    if (j < cnt) add(j, cur);
                }
            }
            release(at);
            at = ahead;
        };
        {
            const float* st = wait_formed(at);
            const int cnt = batch_count(0);
#pragma unroll
            for (int j = 0; j < NBT; ++j) {
                if (has && j < cnt) get(st, j, buf[0]);
            }
        }
        for (int g = 0; g < n_batches; g += 2) {
            step(g, buf[0], buf[1]);
            if (g + 1 < n_batches) step(g + 1, buf[1], buf[0]);
        }
        if (has) {
#pragma unroll
            for (int v = 0; v < V; ++v) dst[c0 + v] = acc[v];
        }
    }
}

int template_rank(int R) { return (R == 16 || R == 32 || R == 64 || R == 128) ? R : 0; }

// A chain-route launch's layout: nonzeros a batch, producer warps a CTA, and
// the CTA's dynamic shared memory (-1 where it cannot launch).
struct ChainLayout {
    int nb, producers;
    long long smem;
};

// The layout for a stream of K + 1 modes at rank R whose longest run has
// longest_run nonzeros (0: unknown). The batch: at a template rank its fixed
// one (template_nb), else the most nonzeros, up to MAX_NB, whose factor rows
// fit SLOT_BUDGET (1 at least). The producers: DEFAULT_PRODUCERS, or
// LONG_PRODUCERS where a run of LONG_RUN nonzeros or more is paced by its
// producers (their per-batch work, not the chain: measured on an H100), in
// either case fewer where their rings would not fit (many modes, a large R).
// More producers cost the short runs occupancy, so they are not the default.
ChainLayout chain_layout(int K, int R, long long longest_run) {
    ChainLayout c{};
    const long long fit = SLOT_BUDGET / (4ll * K * R);
    c.nb = template_rank(R) ? template_nb(R)
                            : static_cast<int>(fit < 1 ? 1 : fit > MAX_NB ? MAX_NB : fit);
    c.producers = longest_run >= LONG_RUN ? LONG_PRODUCERS : DEFAULT_PRODUCERS;
    while (c.producers > 1 && chain_smem(K, R, c.nb, c.producers) > MAX_SMEM) --c.producers;
    c.smem = chain_smem(K, R, c.nb, c.producers);
    if (c.smem > MAX_SMEM) c.smem = -1;
    return c;
}

template <int RT, bool PSRAM>
cudaError_t launch_chain_as(float* out, const int* coords, const float* val,
                            const Factors& fac, const long long* seg_ptr,
                            const long long* seg_rows, int n_seg, int K, int R,
                            const ChainLayout& c, int vec, hopper::PsramAdc adc,
                            cudaStream_t stream) {
    cudaError_t err = opt_in_max_smem<ordered_chain_kernel<RT, PSRAM>>();
    if (err != cudaSuccess) return err;
    ordered_chain_kernel<RT, PSRAM><<<n_seg, 32 * (1 + c.producers), static_cast<size_t>(c.smem),
                                      stream>>>(out, coords, val, fac, seg_ptr, seg_rows, K, R,
                                                c.nb, vec, adc);
    return cudaGetLastError();
}

// ------------------------------------ route `chain`, the quantized chain at a template rank

constexpr int PSRAM_PRODUCERS = 4;    // producer warps a CTA (fewer where their slots do not fit)
constexpr int CLUSTER = 8;            // CTAs of a long run's cluster: the portable size
constexpr int RING_DEPTH = ROW_SLOTS - AHEAD;   // a long run's producer's slots in rank 0's ring
constexpr int PSRAM_BATCH = 2048;     // bytes of a batch's chain rows: 512 / R nonzeros ...
constexpr int CLUSTER_BATCH = 4096;   // ... and in a launch with clusters, at R >= 32

// Bytes of a batch's chain rows at template rank RT, where the launch gives
// long runs clusters or not: a cluster's one consumer pays its hand-off
// (a wait, a release) once a batch, which set the head row's pace on an
// H100, so its batches are as large as rank 0's ring allows; at R = 16 they
// stay 2 KB, 32 nonzeros, what the consumer keeps in registers.
__host__ __device__ constexpr int psram_batch(int RT, bool cluster) {
    return cluster && RT >= 32 ? CLUSTER_BATCH : PSRAM_BATCH;
}

// A full barrier (its shared-memory address) and the parity of the phase a
// consumer waits for.
struct BarPhase {
    uint32_t bar, parity;
};

// Nonzeros a batch of the quantized route at template rank RT.
__host__ __device__ constexpr int psram_nb(int RT, bool cluster) {
    return psram_batch(RT, cluster) / (4 * RT);
}

// The barriers' bytes: a short run's CTA has a full and an empty barrier a
// producer's row slot; in a long run's cluster rank 0 has a full and a
// consumed barrier a ring slot ((CLUSTER - 1) * P producers, RING_DEPTH
// each), the other ranks an empty one a ring slot of their own producers.
__host__ __device__ constexpr long long psram_bar_bytes(int P, bool cluster) {
    const int own = 2 * P * ROW_SLOTS;                     // a short run's CTA
    const int ring = 2 * (CLUSTER - 1) * P * RING_DEPTH;   // rank 0 of a long run's cluster
    return align16(8ll * (cluster && ring > own ? ring : own));
}

// The dynamic shared memory of a CTA: the barriers, then either its
// producers' rings (chain_warp_bytes at psram_nb) or, in rank 0 of a long
// run's cluster, the ring its producers' batches land in; one launch lays
// every CTA out alike.
__host__ __device__ constexpr long long psram_smem(int K, int R, int P, bool cluster) {
    const long long rings = 1ll * P * chain_warp_bytes(K, R, psram_nb(R, cluster));
    const long long ring = cluster ? 1ll * (CLUSTER - 1) * P * RING_DEPTH * psram_batch(R, true)
                                   : 0;
    return psram_bar_bytes(P, cluster) + (rings > ring ? rings : ring);
}

// A quantized launch's layout at a template rank: producer warps a CTA and
// the CTA's dynamic shared memory (-1 where one producer does not fit).
ChainLayout psram_layout(int K, int R, bool cluster) {
    ChainLayout c{psram_nb(R, cluster), PSRAM_PRODUCERS, 0};
    while (c.producers > 1 && psram_smem(K, R, c.producers, cluster) > MAX_SMEM) --c.producers;
    c.smem = psram_smem(K, R, c.producers, cluster);
    if (c.smem > MAX_SMEM) c.smem = -1;
    return c;
}

// The chain route's quantized variant at a template rank RT (16, 32, 64,
// 128): run s adds, for each nonzero p of [seg_ptr[s], seg_ptr[s+1]) in
// order, the quantized chain of core.mttkrp.psram_chain into out row
// seg_rows[s] (row s where seg_rows is null), one __fadd_rn each, starting
// from the row's value. A batch is BATCH bytes of chain rows, NB = BATCH /
// (4 RT) nonzeros (psram_batch); a CTA is a consumer warp and P producer
// warps (blockDim).
// * A run of fewer than LONG_RUN nonzeros (or any run, where the launch
//   lists no long run) is one CTA's: the exact route's pipeline
//   (ordered_chain_kernel, above) with the producers' form in registers.
//   Its CTA is blockIdx.x - n_long * CLUSTER.
// * The n_long runs of long_runs (every run of LONG_RUN nonzeros or more,
//   longest first) are each a cluster of CLUSTER CTAs, the grid's first:
//   rank 0's warp 0 adds, in stream order, from a ring in its shared memory;
//   the W = (CLUSTER - 1) * P producer warps of ranks 1.. form batch g =
//   q + i W (producer q, its i-th) in their own shared memory and copy it
//   into rank 0's ring slot (q, i % RING_DEPTH) with one bulk copy counted
//   on that slot's full barrier. The consumer marks the slot consumed on a
//   barrier of its own CTA, and rank 0's other warps (batch g is warp 1 +
//   g % P's) pass that on to the producer, a remote arrival on its own
//   empty barrier, which the chain of adds then does not wait for. Batch g
//   is the stream's positions g * nb .. whoever forms it, so the bits do
//   not change.
// Each producer forms its batch as NB * (RT / 4) / 32 rows a lane (4 or 8),
// 4 at once: RT / 4 lanes a row, 4 columns a lane (hopper::psram_chain_pieces).
template <int RT, int BATCH>
__global__ void __launch_bounds__(32 * (1 + PSRAM_PRODUCERS))
ordered_psram_kernel(float* __restrict__ out, const int* __restrict__ coords,
                     const float* __restrict__ val, Factors fac,
                     const long long* __restrict__ seg_ptr,
                     const long long* __restrict__ seg_rows, long long n_seg,
                     const long long* __restrict__ long_runs, int n_long, int K, int vec_copy,
                     hopper::PsramAdc adc) {
    extern __shared__ __align__(16) unsigned char psram_smem_buf[];
    unsigned char* smem = psram_smem_buf;
    constexpr int NB = BATCH / (4 * RT);
    constexpr int PPR = RT / 4;                    // lanes a row, a 16-byte piece each
    constexpr int UF = NB * PPR / 32;              // rows of a batch a lane forms ...
    constexpr int UG = 4;                          // ... UG at once
    static_assert(UF * 32 == NB * PPR && UF % UG == 0, "a batch's pieces fill whole passes of the warp");
    const int P = static_cast<int>(blockDim.x >> 5) - 1;
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const bool clustered = n_long > 0;
    const bool is_long = blockIdx.x < static_cast<unsigned>(n_long) * CLUSTER;
    long long s;
    if (is_long) {
        s = long_runs[blockIdx.x / CLUSTER];
    } else {
        s = static_cast<long long>(blockIdx.x) - static_cast<long long>(n_long) * CLUSTER;
        if (s >= n_seg) return;                    // a short cluster's padding
    }
    const long long lo = seg_ptr[s];
    const long long n = seg_ptr[s + 1] - lo;
    // a short CTA leaves whole where its run is empty or a cluster's
    if (!is_long && (n <= 0 || (clustered && n >= LONG_RUN))) return;
    const long long row = seg_rows ? seg_rows[s] : s;
    const int row_slot = chain_row_slot(K, RT, NB);
    const int meta_slot = chain_meta_slot(K, NB);
    const int warp_bytes = chain_warp_bytes(K, RT, NB);
    unsigned long long* bars = reinterpret_cast<unsigned long long*>(smem);
    unsigned char* body = smem + psram_bar_bytes(P, clustered);
    auto slot_of = [&](int w, int rs) {
        return reinterpret_cast<float*>(body + static_cast<long long>(w) * warp_bytes
                                        + rs * row_slot);
    };
    const int n_batches = static_cast<int>((n + NB - 1) / NB);
    auto batch_count = [&](int g) {
        const long long left = n - static_cast<long long>(g) * NB;
        return static_cast<int>(left < NB ? left : NB);
    };

    // ---- a producer: staging warp w of this CTA, its local batches i = 0,
    // 1, ... the run's batches first + i * step. wait_slot(it) comes before
    // the gather of it + AHEAD into its row slot; publish(it, slot) hands
    // batch it's formed chain rows on.
    auto produce = [&](int w, int first, int step, auto&& wait_slot, auto&& publish) {
        unsigned char* meta_ring = body + static_cast<long long>(w) * warp_bytes
                                   + ROW_SLOTS * row_slot;
        const int L = first < n_batches ? (n_batches - 1 - first) / step + 1 : 0;
        auto meta_idx = [&](int ms) { return reinterpret_cast<int*>(meta_ring + ms * meta_slot); };
        auto meta_val = [&](int ms) { return reinterpret_cast<float*>(meta_idx(ms) + NB * K); };
        auto copy_meta = [&](int i, int ms) {
            const int cnt = batch_count(first + i * step);
            const long long p0 = lo + static_cast<long long>(first + i * step) * NB;
            int* mi = meta_idx(ms);
            float* mv = meta_val(ms);
            const int* src = coords + p0 * K;
            for (int e = lane; e < cnt * K; e += 32) cp_async4(mi + e, src + e);
            for (int e = lane; e < cnt; e += 32) cp_async4(mv + e, val + p0 + e);
        };
        // the batch's rows of every non-target factor, the k-th one's row j
        // at slot + (k * NB + j) * RT, a row copied by RT / 4 lanes
        auto gather = [&](int i, int ms, int rs) {
            const int cnt = batch_count(first + i * step);
            const int* mi = meta_idx(ms);
            float* st = slot_of(w, rs);
            for (int k = 0; k < K; ++k) {
                const float* F = fac.f[k];
                const int* rk = mi + k;
                float* dst = st + k * NB * RT;
                if (vec_copy && cnt == NB) {               // a full batch: every lane's rows first
                    int r[UF];
#pragma unroll
                    for (int u = 0; u < UF; ++u) r[u] = rk[((lane + 32 * u) / PPR) * K];
#pragma unroll
                    for (int u = 0; u < UF; ++u) {
                        const int j = (lane + 32 * u) / PPR;
                        const int q = 4 * ((lane + 32 * u) % PPR);
                        cp_async16(dst + j * RT + q, F + static_cast<long long>(r[u]) * RT + q);
                    }
                } else if (vec_copy) {
                    for (int p = lane; p < cnt * PPR; p += 32) {
                        const int j = p / PPR;
                        const int q = 4 * (p - j * PPR);
                        cp_async16(dst + j * RT + q, F + static_cast<long long>(rk[j * K]) * RT + q);
                    }
                } else {
                    for (int e = lane; e < cnt * RT; e += 32) {
                        const int j = e / RT;
                        const int c = e - j * RT;
                        cp_async4(dst + j * RT + c, F + static_cast<long long>(rk[j * K]) * RT + c);
                    }
                }
            }
        };
        // the quantized chain of the batch's NB rows in place of the first
        // factor's: piece p = lane + 32 u of the batch is row p / PPR's piece
        // p % PPR, so each lane forms UF rows, UG at once in registers (the
        // rows past the batch's count hold stale values: formed, never added)
        auto form = [&](int ms, int rs) {
            const float* mv = meta_val(ms);
            float* st = slot_of(w, rs);
#pragma unroll
            for (int u0 = 0; u0 < UF; u0 += UG) {
                float* at[UG];
                bool live[UG];
                float v[UG];
#pragma unroll
                for (int u = 0; u < UG; ++u) {
                    const int p = lane + 32 * (u0 + u);
                    at[u] = st + (p / PPR) * RT + 4 * (p % PPR);
                    live[u] = true;
                    v[u] = mv[p / PPR];
                }
                hopper::psram_chain_pieces<UG>(at, live, v, NB * RT, K, PPR, adc);
            }
        };
        // iterations it + AHEAD (rows) and it + 2 AHEAD (metadata) ride ahead of it
        for (int i = 0; i < AHEAD; ++i) {
            if (i < L) copy_meta(i, i);
        }
        commit_group();
        wait_group<0>();
        __syncwarp();
        for (int i = 0; i < AHEAD; ++i) {                  // the first row slots are free
            if (i < L) gather(i, i, i);
            if (AHEAD + i < L) copy_meta(AHEAD + i, AHEAD + i);
            commit_group();
        }
        for (int it = 0; it < L; ++it) {
            wait_group<AHEAD - 1>();                       // the group of it - AHEAD: rows of it,
            __syncwarp();                                  // metadata of it + AHEAD (every lane's)
            const int ahead = it + AHEAD;
            wait_slot(it);
            if (ahead < L) gather(ahead, ahead % META_SLOTS, ahead % ROW_SLOTS);
            if (it + 2 * AHEAD < L) copy_meta(it + 2 * AHEAD, (it + 2 * AHEAD) % META_SLOTS);
            commit_group();
            const int rs = it % ROW_SLOTS;
            form(it % META_SLOTS, rs);
            publish(it, rs);
        }
        wait_group<0>();
    };

    // ---- the consumer, warp 0: batch g is producer w = g % span's local
    // batch i = g / span. bar(w, i) is its full barrier and parity, slot(w,
    // i) its chain rows; release(w, i) frees them (after every lane's reads)
    auto consume = [&](int span, auto&& bar, auto&& slot, auto&& release) {
        float* dst = out + row * RT;
        constexpr int V = lane_cols(RT);
        constexpr int H = NB / 2;                      // adds of a batch before the next one's wait
        const int c0 = lane * V;
        const bool has = c0 < RT;                      // R = 16: lanes 16..31 add nothing
        float acc[V];
        float buf[2][NB][V];
#pragma unroll
        for (int v = 0; v < V; ++v) acc[v] = has ? dst[c0 + v] : 0.0f;
        auto get = [&](const float* st, int j, float (&x)[NB][V]) {
            const float* at = st + j * RT + c0;
            if constexpr (V == 4) {
                const float4 t = *reinterpret_cast<const float4*>(at);
                x[j][0] = t.x; x[j][1] = t.y; x[j][2] = t.z; x[j][3] = t.w;
            } else if constexpr (V == 2) {
                const float2 t = *reinterpret_cast<const float2*>(at);
                x[j][0] = t.x; x[j][1] = t.y;
            } else {
                x[j][0] = *at;
            }
        };
        auto add = [&](int j, const float (&x)[NB][V]) {
#pragma unroll
            for (int v = 0; v < V; ++v) acc[v] = __fadd_rn(acc[v], x[j][v]);
        };
        auto wait = [&](int w, int i, uint32_t done) {  // spin unless a try found it formed
            if (!done) {
                const auto [b, parity] = bar(w, i);
                hopper::mbar_wait(b, parity);
            }
        };
        int w = 0, i = 0;                              // batch g's producer and local index
        // batch g's rows are in registers (loaded in step g - 1), so its slot
        // is freed first; the next batch's barrier is tried before the first
        // H adds and waited on after them, and its rows load beside the last
        // NB - H adds, so the chain of adds waits on neither
        auto step = [&](int g, float (&cur)[NB][V], float (&nxt)[NB][V]) {
            const int cnt = batch_count(g);
            release(w, i);
            int w1 = w + 1, i1 = i;
            if (w1 == span) {
                w1 = 0;
                ++i1;
            }
            if (g + 1 < n_batches) {
                const auto [b, parity] = bar(w1, i1);
                const uint32_t done = hopper::mbar_try(b, parity);
                const int cnt1 = batch_count(g + 1);
                if (has && cnt == NB && cnt1 == NB) {
#pragma unroll
                    for (int j = 0; j < H; ++j) add(j, cur);
                    wait(w1, i1, done);
                    const float* st = slot(w1, i1);
#pragma unroll
                    for (int j = H; j < NB; ++j) {
                        get(st, 2 * (j - H), nxt);
                        get(st, 2 * (j - H) + 1, nxt);
                        add(j, cur);
                    }
                } else {
#pragma unroll
                    for (int j = 0; j < H; ++j) {
                        if (j < cnt) add(j, cur);
                    }
                    wait(w1, i1, done);
                    const float* st = slot(w1, i1);
#pragma unroll
                    for (int j = H; j < NB; ++j) {
                        if (has && 2 * (j - H) < cnt1) get(st, 2 * (j - H), nxt);
                        if (has && 2 * (j - H) + 1 < cnt1) get(st, 2 * (j - H) + 1, nxt);
                        if (j < cnt) add(j, cur);
                    }
                }
            } else {
#pragma unroll
                for (int j = 0; j < NB; ++j) {
                    if (j < cnt) add(j, cur);
                }
            }
            w = w1;
            i = i1;
        };
        {
            wait(0, 0, 0);
            const float* st = slot(0, 0);
            const int cnt = batch_count(0);
#pragma unroll
            for (int j = 0; j < NB; ++j) {
                if (has && j < cnt) get(st, j, buf[0]);
            }
        }
        for (int g = 0; g < n_batches; g += 2) {
            step(g, buf[0], buf[1]);
            if (g + 1 < n_batches) step(g + 1, buf[1], buf[0]);
        }
        if (has) {
#pragma unroll
            for (int v = 0; v < V; ++v) dst[c0 + v] = acc[v];
        }
    };

    if (!is_long) {
        // ---- a short run: the producers' row slots are the consumer's; a
        // slot's full barrier: its producer formed the batch there; empty:
        // the consumer is done with it (one arrival a phase each)
        auto full_bar = [&](int w, int rs) { return smem_u32(bars + w * ROW_SLOTS + rs); };
        auto empty_bar = [&](int w, int rs) { return smem_u32(bars + (P + w) * ROW_SLOTS + rs); };
        if (threadIdx.x == 0) {
            for (int b = 0; b < 2 * P * ROW_SLOTS; ++b) hopper::mbar_init(smem_u32(bars + b), 1);
        }
        __syncthreads();                               // the only CTA-wide barrier
        if (warp > 0) {
            const int w = warp - 1;
            produce(w, w, P,
                    [&](int it) {                      // the consumer is done with the slot's last batch
                        const int ahead = it + AHEAD;
                        if (ahead >= ROW_SLOTS) {
                            hopper::mbar_wait(empty_bar(w, ahead % ROW_SLOTS),
                                              static_cast<uint32_t>((ahead / ROW_SLOTS - 1) & 1));
                        }
                    },
                    [&](int, int rs) {
                        __syncwarp();                  // every lane's rows are in the slot
                        if (lane == 0) hopper::mbar_arrive(full_bar(w, rs));
                    });
            return;
        }
        consume(P,
                [&](int w, int i) {
                    return BarPhase{
                        full_bar(w, i % ROW_SLOTS), static_cast<uint32_t>((i / ROW_SLOTS) & 1)};
                },
                [&](int w, int i) { return static_cast<const float*>(slot_of(w, i % ROW_SLOTS)); },
                [&](int w, int i) {
                    __syncwarp();
                    if (lane == 0) hopper::mbar_arrive(empty_bar(w, i % ROW_SLOTS));
                });
        return;
    }

    // ---- a long run's cluster. No CTA of it leaves before the last
    // cluster_sync: the others arrive on its barriers and copy into its ring.
    const uint32_t crank = hopper::cluster_ctarank();
    const int W = (CLUSTER - 1) * P;
    auto ring_slot = [&](int q, int i) {               // in rank 0
        return body + static_cast<long long>(q * RING_DEPTH + i % RING_DEPTH) * BATCH;
    };
    // rank 0: a full barrier a ring slot, then a consumed one; the other
    // ranks: an empty barrier a ring slot of their producers
    auto consumed_bar = [&](int q, int i) {
        return smem_u32(bars + W * RING_DEPTH + q * RING_DEPTH + i % RING_DEPTH);
    };
    if (threadIdx.x == 0) {
        const int nbar = crank == 0 ? 2 * W * RING_DEPTH : P * RING_DEPTH;
        for (int b = 0; b < nbar; ++b) hopper::mbar_init(smem_u32(bars + b), 1);
        hopper::mbar_init_fence();
    }
    hopper::cluster_sync();                            // every rank's barriers are initialised
    if (crank == 0 && warp == 0) {
        consume(W,
                [&](int q, int i) {
                    return BarPhase{
                        smem_u32(bars + q * RING_DEPTH + i % RING_DEPTH),
                        static_cast<uint32_t>((i / RING_DEPTH) & 1)};
                },
                [&](int q, int i) { return reinterpret_cast<const float*>(ring_slot(q, i)); },
                [&](int q, int i) {                    // after every lane's reads of the slot
                    __syncwarp();
                    if (lane == 0) hopper::mbar_arrive(consumed_bar(q, i));
                });
    } else if (crank == 0) {
        // warp 1 + h passes batches g = h, h + P, ... on, in order: the slot
        // is consumed, so producer q = g % W may fill it again
        for (int g = warp - 1; g < n_batches; g += P) {
            const int q = g % W, i = g / W;
            hopper::mbar_wait(consumed_bar(q, i), static_cast<uint32_t>((i / RING_DEPTH) & 1));
            if (lane == 0) {
                hopper::mbar_arrive_cluster(hopper::cluster_addr(
                    smem_u32(bars + (q % P) * RING_DEPTH + i % RING_DEPTH), 1 + q / P));
            }
        }
    } else if (warp > 0) {
        const int w = warp - 1;
        const int q = (static_cast<int>(crank) - 1) * P + w;
        // batch it goes to ring slot (q, it % RING_DEPTH), formed in row slot
        // it % ROW_SLOTS; the gather of it + AHEAD reuses the row slot of
        // it - RING_DEPTH (RING_DEPTH = ROW_SLOTS - AHEAD), so one wait for
        // that batch's consumption frees both the row slot and the ring slot
        produce(w, q, W,
                [&](int it) {
                    if (it >= RING_DEPTH) {
                        hopper::mbar_wait(smem_u32(bars + w * RING_DEPTH + it % RING_DEPTH),
                                          static_cast<uint32_t>((it / RING_DEPTH - 1) & 1));
                    }
                },
                [&](int it, int rs) {
                    hopper::fence_proxy_async_shared();   // the rows, visible to the bulk copy
                    __syncwarp();
                    if (lane == 0) {
                        const uint32_t full = hopper::cluster_addr(
                            smem_u32(bars + q * RING_DEPTH + it % RING_DEPTH), 0);
                        hopper::mbar_expect_tx_cluster(full, BATCH);
                        hopper::bulk_copy_to_cluster(
                            hopper::cluster_addr(smem_u32(ring_slot(q, it)), 0),
                            smem_u32(slot_of(w, rs)), BATCH, full);
                    }
                });
    }
    hopper::cluster_sync();
}

template <int RT, int BATCH>
cudaError_t launch_psram_as(float* out, const int* coords, const float* val, const Factors& fac,
                            const long long* seg_ptr, const long long* seg_rows, int n_seg,
                            const long long* long_runs, int n_long, int K, int vec,
                            hopper::PsramAdc adc, cudaStream_t stream) {
    const ChainLayout c = psram_layout(K, RT, n_long > 0);
    if (c.smem < 0) return cudaErrorInvalidValue;
    cudaError_t err = opt_in_max_smem<ordered_psram_kernel<RT, BATCH>>();
    if (err != cudaSuccess) return err;
    cudaLaunchConfig_t cfg = {};
    const long long ctas = n_long > 0
        ? static_cast<long long>(n_long) * CLUSTER + (n_seg + CLUSTER - 1) / CLUSTER * CLUSTER
        : n_seg;
    cfg.gridDim = dim3(static_cast<unsigned>(ctas));
    cfg.blockDim = dim3(32 * (1 + c.producers));
    cfg.dynamicSmemBytes = static_cast<size_t>(c.smem);
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = CLUSTER;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = n_long > 0 ? 1 : 0;                 // a cluster only where a long run needs one
    err = cudaLaunchKernelEx(&cfg, ordered_psram_kernel<RT, BATCH>, out, coords, val, fac,
                             seg_ptr, seg_rows, static_cast<long long>(n_seg), long_runs, n_long,
                             K, vec, adc);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
}

template <int RT>
cudaError_t launch_psram(float* out, const int* coords, const float* val, const Factors& fac,
                         const long long* seg_ptr, const long long* seg_rows, int n_seg,
                         const long long* long_runs, int n_long, int K, int vec,
                         hopper::PsramAdc adc, cudaStream_t stream) {
    constexpr int B = psram_batch(RT, true);
    return n_long > 0
        ? launch_psram_as<RT, B>(out, coords, val, fac, seg_ptr, seg_rows, n_seg, long_runs,
                                 n_long, K, vec, adc, stream)
        : launch_psram_as<RT, PSRAM_BATCH>(out, coords, val, fac, seg_ptr, seg_rows, n_seg,
                                           long_runs, n_long, K, vec, adc, stream);
}

// ------------------------------------------------------ the division probe

// Holds hopper::psram_div (the quantized chains' quotients by a row's scale
// and by the ADC's LSB) to __fdiv_rn on the card, exhaustively. kind 0, the
// ADC at LSB lsb (rlsb its reciprocal): every integer product p in [-127^2,
// 127^2] and -0.0, index p + 127^2 (-0.0 last): the quotient's bits and
// psram_adc's against __fdiv_rn's and the true-division ADC's (whose
// product, formed in int, is +0.0 where zero). kind 1, a value's code: every
// finite f32 v, its bit pattern the index: psram_code(v, sv, RN(1 / sv)),
// sv = psram_scale(|v|), against rint(__fdiv_rn(v, sv)) clamped to +-127.
// bad[0] counts the indices that differ, bad[1] keeps the least.
__global__ void __launch_bounds__(256)
psram_division_probe_kernel(int kind, hopper::PsramAdc a, unsigned long long* bad) {
    constexpr long long PMAX = 127 * 127;
    const unsigned long long n = kind == 0 ? 2ull * PMAX + 2 : 1ull << 32;
    for (unsigned long long e = static_cast<unsigned long long>(blockIdx.x) * blockDim.x + threadIdx.x;
         e < n; e += static_cast<unsigned long long>(gridDim.x) * blockDim.x) {
        bool differs;
        if (kind == 0) {
            const float p = e + 1 == n ? -0.0f : static_cast<float>(static_cast<long long>(e) - PMAX);
            const float want_q = __fdiv_rn(p == 0.0f ? 0.0f : p, a.lsb);
            const float want = __fmul_rn(fminf(fmaxf(rintf(want_q), -a.code_max), a.code_max), a.lsb);
            differs = __float_as_uint(hopper::psram_div(p, a.lsb, a.rlsb)) != __float_as_uint(want_q)
                      || __float_as_uint(hopper::psram_adc(p, a)) != __float_as_uint(want);
        } else {
            const unsigned bits = static_cast<unsigned>(e);
            if ((bits & 0x7f800000u) == 0x7f800000u) continue;   // inf and NaN
            const float v = __uint_as_float(bits);
            const float sv = hopper::psram_scale(fabsf(v));
            const float want = fminf(fmaxf(rintf(__fdiv_rn(v, sv)), -127.0f), 127.0f);
            differs = static_cast<int>(hopper::psram_code(v, sv, __frcp_rn(sv)))
                      != static_cast<int>(want);
        }
        if (differs) {
            atomicAdd(bad, 1ull);
            atomicMin(bad + 1, e);
        }
    }
}

// The row codes: row r of x (n, R) f32 quantized as the chains quantize a
// row (psram_scale of its max |.|, psram_code through the scale's
// reciprocal) into codes, and through __fdiv_rn into codes_div, as floats.
__global__ void __launch_bounds__(256)
psram_division_rows_kernel(const float* __restrict__ x, long long n, int R,
                           float* __restrict__ codes, float* __restrict__ codes_div) {
    const long long r = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (r >= n) return;
    const float* xr = x + r * R;
    float m = 0.0f;
    for (int c = 0; c < R; ++c) m = fmaxf(m, fabsf(xr[c]));
    const float s = hopper::psram_scale(m);
    const float rs = __frcp_rn(s);
    for (int c = 0; c < R; ++c) {
        codes[r * R + c] = hopper::psram_code(xr[c], s, rs);
        codes_div[r * R + c] = fminf(fmaxf(rintf(__fdiv_rn(xr[c], s)), -127.0f), 127.0f);
    }
}

}  // namespace

// The most rank columns a fold-route launch takes (a long run's ring of
// one-row stages, the running sums and the gather indices fit the 227 KB of
// opt-in shared memory).
extern "C" int ordered_fold_max_rank() { return 8192; }

// out (rows, R) f32, d (n_d, R) f32, order (P,) int64 or null, seg_ptr
// (n_seg + 1,) int64 stream positions, seg_rows (n_seg,) int64 target rows
// or null (row = segment), long_runs (n_long,) int64: the segments of more
// than long_run rows, each exactly once (longest first runs soonest), all
// contiguous device pointers; segment s folds the stream rows [seg_ptr[s] -
// base, seg_ptr[s+1] - base) into its row, stream row i being d row
// order[i] (i where order is null). Neither the runs, the long runs nor the
// order are range-checked. vec: R % 4 == 0 and d 16-byte aligned. Returns
// the launch's cudaError_t as an int.
extern "C" int ordered_fold_launch(void* out, const void* d, const void* order,
                                   const void* seg_ptr, const void* seg_rows, long long base,
                                   long long n_seg, const void* long_runs, int n_long, int R,
                                   int vec, long long long_run, void* stream) {
    if (n_seg <= 0 || R <= 0) return static_cast<int>(cudaSuccess);
    if (R > ordered_fold_max_rank() || fold_smem_bytes(R) > MAX_SMEM || long_run < 0
        || n_long < 0 || (vec && R % 4 != 0)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    float* out_ = static_cast<float*>(out);
    const float* d_ = static_cast<const float*>(d);
    const long long* order_ = static_cast<const long long*>(order);
    const long long* ptr_ = static_cast<const long long*>(seg_ptr);
    const long long* rows_ = static_cast<const long long*>(seg_rows);
    const long long* long_ = static_cast<const long long*>(long_runs);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    cudaError_t err;
    if (order_) {
        err = vec ? launch_fold<true, true>(out_, d_, order_, ptr_, rows_, base, n_seg, long_, n_long, R, long_run, st)
                  : launch_fold<false, true>(out_, d_, order_, ptr_, rows_, base, n_seg, long_, n_long, R, long_run, st);
    } else {
        err = vec ? launch_fold<true, false>(out_, d_, order_, ptr_, rows_, base, n_seg, long_, n_long, R, long_run, st)
                  : launch_fold<false, false>(out_, d_, order_, ptr_, rows_, base, n_seg, long_, n_long, R, long_run, st);
    }
    return static_cast<int>(err);
}

// The most modes a chain-route stream may have.
extern "C" int ordered_chain_max_modes() { return MAX_MODES; }

// Dynamic shared memory of a chain-route CTA for a stream of nmodes modes at
// rank R whose longest run has longest_run nonzeros (chain_layout); -1 where
// it cannot launch (fewer than 2 or more than MAX_MODES modes, or more than
// 227 KB with one producer).
extern "C" long long ordered_chain_smem_bytes(int nmodes, int R, long long longest_run) {
    if (nmodes < 2 || nmodes > MAX_MODES || R <= 0) return -1;
    return chain_layout(nmodes - 1, R, longest_run).smem;
}

// Dynamic shared memory of a CTA of the quantized chain route at a template
// rank R (16, 32, 64, 128) for a stream of nmodes modes, where the launch
// gives long runs clusters (cluster) or not, and its producer warps
// (psram_layout); -1 where it cannot launch.
extern "C" long long ordered_psram_smem_bytes(int nmodes, int R, int cluster) {
    if (nmodes < 2 || nmodes > MAX_MODES || template_rank(R) == 0) return -1;
    return psram_layout(nmodes - 1, R, cluster != 0).smem;
}

extern "C" int ordered_psram_producers(int nmodes, int R, int cluster) {
    if (nmodes < 2 || nmodes > MAX_MODES || template_rank(R) == 0) return -1;
    return psram_layout(nmodes - 1, R, cluster != 0).producers;
}

// The runs a quantized launch at a template rank gives a cluster: those of
// this many nonzeros or more; and the cluster's CTAs.
extern "C" long long ordered_psram_long_run() { return LONG_RUN; }
extern "C" int ordered_psram_cluster() { return CLUSTER; }

// out (rows, R) f32; coords (n, nmodes - 1) int32 row-major: the stream's
// non-target coordinates, nonzero p's k-th one (mode order) at
// coords[p * (nmodes - 1) + k]; val (n,) f32
// values; factors: a host array of the nmodes - 1 non-target factors' device
// pointers, in mode order, each (I_d, R) f32 row-major; seg_ptr (n_seg + 1,)
// int64 stream positions, seg_rows (n_seg,) int64 target rows or null (row =
// segment); all contiguous. Run s adds, for each nonzero p of
// [seg_ptr[s], seg_ptr[s+1]) in order, v_p times the Hadamard of the
// non-target factors' rows into its row. Coordinates are not range-checked.
// longest_run: the most nonzeros a run has (0 if the caller does not know).
// vec: R % 4 == 0 and every factor 16-byte aligned. psram: the quantized
// chain (core.mttkrp.psram_chain) in place of the exact one, its products'
// ADC LSB lsb, largest code code_max and rlsb = RN(1 / lsb) (> 0); at a
// template rank ordered_psram_kernel takes it, and the n_long runs of
// long_runs (int64 run indices, longest first: exactly the runs of LONG_RUN
// nonzeros or more, or none) each take a cluster of CLUSTER CTAs, in one
// cluster launch with the short runs (a CTA each); without long runs the
// launch is a plain one. A refused launch is returned, never replaced.
// Returns the launch's cudaError_t as an int.
extern "C" int ordered_chain_launch(void* out, const void* coords, const void* val,
                                    const void* const* factors, const void* seg_ptr,
                                    const void* seg_rows, int n_seg, int nmodes, int R,
                                    long long longest_run, int vec, int psram, float lsb,
                                    float code_max, float rlsb, const void* long_runs,
                                    int n_long, void* stream) {
    if (n_seg <= 0 || R <= 0) return static_cast<int>(cudaSuccess);
    if (nmodes < 2 || nmodes > MAX_MODES || (vec && R % 4 != 0) || n_long < 0
        || (psram && !(lsb > 0.0f && code_max >= 0.0f && rlsb > 0.0f))) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const int K = nmodes - 1;
    const int RT = template_rank(R);
    Factors fac;
    for (int k = 0; k < MAX_MODES - 1; ++k) {
        fac.f[k] = k < K ? static_cast<const float*>(factors[k]) : nullptr;
    }
    float* out_ = static_cast<float*>(out);
    const int* coords_ = static_cast<const int*>(coords);
    const float* val_ = static_cast<const float*>(val);
    const long long* ptr_ = static_cast<const long long*>(seg_ptr);
    const long long* rows_ = static_cast<const long long*>(seg_rows);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const hopper::PsramAdc adc{lsb, code_max, rlsb};
    if (psram && RT != 0) {
        const long long* long_ = static_cast<const long long*>(long_runs);
        cudaError_t err;
        switch (RT) {
            case 16: err = launch_psram<16>(out_, coords_, val_, fac, ptr_, rows_, n_seg, long_,
                                            n_long, K, vec, adc, st); break;
            case 32: err = launch_psram<32>(out_, coords_, val_, fac, ptr_, rows_, n_seg, long_,
                                            n_long, K, vec, adc, st); break;
            case 64: err = launch_psram<64>(out_, coords_, val_, fac, ptr_, rows_, n_seg, long_,
                                            n_long, K, vec, adc, st); break;
            default: err = launch_psram<128>(out_, coords_, val_, fac, ptr_, rows_, n_seg, long_,
                                             n_long, K, vec, adc, st); break;
        }
        return static_cast<int>(err);
    }
    const ChainLayout c = chain_layout(K, R, longest_run);
    if (c.smem < 0) return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err;
    switch (RT) {
        case 16: err = launch_chain_as<16, false>(out_, coords_, val_, fac, ptr_, rows_, n_seg,
                                                  K, R, c, vec, adc, st); break;
        case 32: err = launch_chain_as<32, false>(out_, coords_, val_, fac, ptr_, rows_, n_seg,
                                                  K, R, c, vec, adc, st); break;
        case 64: err = launch_chain_as<64, false>(out_, coords_, val_, fac, ptr_, rows_, n_seg,
                                                  K, R, c, vec, adc, st); break;
        case 128: err = launch_chain_as<128, false>(out_, coords_, val_, fac, ptr_, rows_, n_seg,
                                                    K, R, c, vec, adc, st); break;
        default:
            err = psram ? launch_chain_as<0, true>(out_, coords_, val_, fac, ptr_, rows_, n_seg,
                                                   K, R, c, vec, adc, st)
                        : launch_chain_as<0, false>(out_, coords_, val_, fac, ptr_, rows_, n_seg,
                                                    K, R, c, vec, adc, st);
            break;
    }
    return static_cast<int>(err);
}

// The division probe (psram_division_probe_kernel): kind 0 the ADC at lsb,
// code_max, rlsb, kind 1 every finite f32 value's code; bad (2,) uint64
// zeroed by the caller: the count of indices that differ and the least.
extern "C" int psram_division_probe_launch(int kind, float lsb, float code_max, float rlsb,
                                           void* bad, void* stream) {
    if (kind < 0 || kind > 1) return static_cast<int>(cudaErrorInvalidValue);
    psram_division_probe_kernel<<<kind == 0 ? 128 : 2048, 256, 0, static_cast<cudaStream_t>(stream)>>>(
        kind, hopper::PsramAdc{lsb, code_max, rlsb}, static_cast<unsigned long long*>(bad));
    return static_cast<int>(cudaGetLastError());
}

// The row codes (psram_division_rows_kernel): x (n, R) f32, codes and
// codes_div (n, R) f32, all contiguous.
extern "C" int psram_division_rows_launch(const void* x, long long n, int R, void* codes,
                                          void* codes_div, void* stream) {
    if (n <= 0 || R <= 0) return static_cast<int>(cudaSuccess);
    psram_division_rows_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), n, R, static_cast<float*>(codes),
        static_cast<float*>(codes_div));
    return static_cast<int>(cudaGetLastError());
}

// The runtime's text for an error code returned by a launch entry.
extern "C" const char* ordered_fold_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}
