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
// Route `fold` (ordered_fold_kernel): the contributions d (n, R) are given.
// One CTA per run of 4 warps; all 128 threads stream the run's rows into a
// ring of STAGES shared-memory stages with cp.async (16-byte copies when
// R % 4 == 0 and d is 16-byte aligned, else 4-byte), STAGES - 1 ahead of warp
// 0, which adds them, lane = rank column. Bound by bytes (d read once, out
// read and written once). The blocked path's partials fold through it.
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

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int THREADS = 128;          // fold route: 4 warps, all copy, warp 0 folds
constexpr int STAGES = 6;             // fold route: ring depth; STAGES - 1 stages in flight
constexpr int STAGE_FLOATS = 2048;    // fold route: 8 KB a stage (whole rows: at least one)
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
using hopper::opt_in_max_smem;
using hopper::smem_u32;
using hopper::wait_group;

// ------------------------------------------------------------ route `fold`

// Copy n contiguous floats from global src into shared dst, asynchronously.
template <bool VEC>
__device__ __forceinline__ void start_copy(float* dst, const float* src, int n, int tid) {
    if constexpr (VEC) {
        for (int i = tid * 4; i < n; i += THREADS * 4) cp_async16(dst + i, src + i);
    } else {
        for (int i = tid; i < n; i += THREADS) cp_async4(dst + i, src + i);
    }
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

// rows per stage and dynamic shared memory of a fold-route launch at rank R
int rows_per_stage(int R) { return R >= STAGE_FLOATS ? 1 : STAGE_FLOATS / R; }
size_t fold_smem_bytes(int R) {
    return sizeof(float) * (static_cast<size_t>(STAGES) * rows_per_stage(R) * R + R);
}

// ----------------------------------------------------------- route `chain`

using Factors = hopper::ChainFactors;   // the non-target factors, in mode order

__host__ __device__ constexpr int align16(long long bytes) {
    return static_cast<int>((bytes + 15) / 16 * 16);
}

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
// in shared memory).
template <int RT>
__global__ void __launch_bounds__(32 * (1 + LONG_PRODUCERS))
ordered_chain_kernel(float* __restrict__ out, const int* __restrict__ coords,
                     const float* __restrict__ val, Factors fac,
                     const long long* __restrict__ seg_ptr,
                     const long long* __restrict__ seg_rows,
                     int K, int r_runtime, int nb_runtime, int vec_copy) {
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

template <int RT>
cudaError_t launch_chain(float* out, const int* coords, const float* val,
                         const Factors& fac, const long long* seg_ptr, const long long* seg_rows,
                         int n_seg, int K, int R, const ChainLayout& c, int vec,
                         cudaStream_t stream) {
    cudaError_t err = opt_in_max_smem<ordered_chain_kernel<RT>>();
    if (err != cudaSuccess) return err;
    ordered_chain_kernel<RT><<<n_seg, 32 * (1 + c.producers), static_cast<size_t>(c.smem),
                               stream>>>(out, coords, val, fac, seg_ptr, seg_rows, K, R, c.nb,
                                         vec);
    return cudaGetLastError();
}

}  // namespace

// The most rank columns a fold-route launch takes (the ring of one-row stages
// and the running values fit the 227 KB of opt-in shared memory).
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
    cudaError_t err = vec ? opt_in_max_smem<ordered_fold_kernel<true>>()
                          : opt_in_max_smem<ordered_fold_kernel<false>>();
    if (err != cudaSuccess) return static_cast<int>(err);
    auto kernel = vec ? ordered_fold_kernel<true> : ordered_fold_kernel<false>;
    kernel<<<n_seg, THREADS, fold_smem_bytes(R), static_cast<cudaStream_t>(stream)>>>(
        static_cast<float*>(out), static_cast<const float*>(d),
        static_cast<const long long*>(seg_ptr), static_cast<const long long*>(seg_rows),
        base, R, rows_per_stage(R));
    return static_cast<int>(cudaGetLastError());
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
// vec: R % 4 == 0 and every factor 16-byte aligned. Returns the launch's
// cudaError_t as an int.
extern "C" int ordered_chain_launch(void* out, const void* coords, const void* val,
                                    const void* const* factors, const void* seg_ptr,
                                    const void* seg_rows, int n_seg, int nmodes, int R,
                                    long long longest_run, int vec, void* stream) {
    if (n_seg <= 0 || R <= 0) return static_cast<int>(cudaSuccess);
    if (nmodes < 2 || nmodes > MAX_MODES || (vec && R % 4 != 0)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const int K = nmodes - 1;
    const ChainLayout c = chain_layout(K, R, longest_run);
    if (c.smem < 0) return static_cast<int>(cudaErrorInvalidValue);
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
    cudaError_t err;
    switch (template_rank(R)) {
        case 16: err = launch_chain<16>(out_, coords_, val_, fac, ptr_, rows_, n_seg, K, R, c,
                                        vec, st); break;
        case 32: err = launch_chain<32>(out_, coords_, val_, fac, ptr_, rows_, n_seg, K, R, c,
                                        vec, st); break;
        case 64: err = launch_chain<64>(out_, coords_, val_, fac, ptr_, rows_, n_seg, K, R, c,
                                        vec, st); break;
        case 128: err = launch_chain<128>(out_, coords_, val_, fac, ptr_, rows_, n_seg, K, R,
                                          c, vec, st); break;
        default: err = launch_chain<0>(out_, coords_, val_, fac, ptr_, rows_, n_seg, K, R, c,
                                       vec, st); break;
    }
    return static_cast<int>(err);
}

// The runtime's text for an error code returned by a launch entry.
extern "C" const char* ordered_fold_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}
