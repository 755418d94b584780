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
// but none of the TPU kernel's shape is carried over. The (E, S, rows)
// one-hot mask matmul is an MXU idiom; the stream is sorted, so a block's
// segment ids are non-decreasing and the same sums are a segmented reduction.
// The partials live in a COMPACT scratch — one row per segment that exists,
// addressed through seg_ptr — not in the (nb, E, n_seg, R) stack padded to
// the widest block. The TPU grid is sequential and carries the output across
// chunks; CTAs here run concurrently, so the segments of one output row (a
// contiguous run of the compact scratch, row_ptr) are added by the row fold,
// IN STREAM ORDER, from 0: no atomics on the output, deterministic, every
// output element written once (rows with no nonzero get 0).
//
// What bounds it is not measured; the working hypothesis is the gathers'
// L2 traffic. The stream is 20 bytes a nonzero at 3 modes (0.101 ms of HBM
// for the 16.76 M nonzeros of the main path), but every nonzero also
// gathers one 32-byte sector of each non-target factor's codes and one of
// its scales: ~128 bytes of L2 -> SM traffic at rank 32, about six times the
// stream. The arithmetic (a byte -> f32 conversion per factor, two
// multiplies and one ordered add per nonzero and column) should hide under
// those copies. A profiler's L2 -> SM sector count and L2 throughput per
// pass would confirm or refute it; without one, a run whose factors are
// narrow enough to sit in L1 (a few hundred rows a mode) at the same stream
// length would show how much of the time the gathers take. The first
// design (the `three_pass`
// route) put lane = rank column and paid, per nonzero, the whole warp for
// four shuffles, two one-byte gathers, two quarter-rate int8 -> f32
// conversions and an L2 round trip every 8 nonzeros: 1.31-1.36 ms for its
// partials pass on an H100 (80GB HBM3, 700 W), against 0.47-0.53 for the
// chunk pass.
//
// Route `chunk` (stream_chunk_kernel<NM, R>, R = 16, 32, 64 or 128, its
// rings and the chunk's partials within a CTA's shared memory) — one CTA
// per chunk, 8 warps:
// * Loads: a two-level cp.async pipeline a warp, lane = nonzero. The
//   metadata of a batch of 32 nonzeros (coordinates, values, segment ids)
//   is copied 2A batches ahead of its adds; A batches ahead, the factor
//   rows (R / 16 lanes a row, 16 bytes each, so a copy instruction touches
//   each row's sectors once) and scales are gathered with the coordinates
//   that landed. No register waits on device memory: a coordinate loaded
//   into a register a batch ahead stalls the warp where the next copy
//   reads it, and the HBM latency then paces every batch.
// * Adds: lane = four rank columns of one of G = 128 / R blocks (a warp
//   walks G blocks at once). A lane reads a 32-bit word of each factor row,
//   turns its four codes into exact floats with a byte permute and one add
//   each (no I2F), multiplies them in f32 in mode-ascending order (the plain
//   version's chain: exact up to three factors, rounded at the last multiply
//   with four, the f32 chain beyond) and adds scale * hadamard into the
//   segment's running sum in stream order (__fmul_rn, __fadd_rn). A batch
//   that stays inside every lane's segment (one warp vote) runs without the
//   flush test.
// * The chunk's compact partials stay in shared memory; a CTA reduction
//   gives max|partial|, the CTA digitizes in place and writes each digitized
//   partial once, and the chunk max once. No memset, no atomics, no
//   digitize launch.
// Route `three_pass` (every other layout): pass 1 one warp per block, lane =
// rank column, partials written to the scratch and max|partial| folded into
// chunk_max with an atomic max on the bits of the non-negative float
// (order-independent); pass 2 digitizes in place.
//
// The row fold (both routes): one warp per (row, 32 columns) for a run of
// up to long_run segments (the caller's threshold, the same one that picked
// long_rows); a longer run (the power-law head rows: up to
// ~9.8 k segments on the main path) gets a CTA whose threads stream it
// through a cp.async ring ahead of warp 0's chain of adds, so it costs its
// chain and not one memory round trip per 32 segments (0.378 ms for mode 0
// with a warp a row on an H100, 0.055 with the ring).
//
// Arithmetic contract: the per-nonzero scale is formed in f32 in mode-
// ascending order starting from the value; the Hadamard is the f32 chain of
// exact integer codes in mode-ascending order (equal to the reference's
// int16 product for two factors); each contribution is one rounded multiply
// and one rounded add in stream order (no FMA contraction); the ADC is rintf
// of a true division. Built without --use_fast_math.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_MODES = 8;
constexpr int WARPS_PER_CTA = 4;
constexpr int BATCH = 8;          // three_pass: gathers in flight per lane before the adds
constexpr int FOLD_WARPS = 4;     // row fold: warps of a CTA
constexpr int FOLD_BATCH = 32;    // row fold: loads in flight on a short run's warp
constexpr int LONG_STAGES = 6;    // long-run ring depth; LONG_STAGES - 1 stages in flight
constexpr int LONG_STAGE_FLOATS = 8192;   // 32 KB a stage (whole rows: at least one)
constexpr int CHUNK_WARPS = 8;    // chunk route: warps of a CTA
constexpr int MAX_SMEM = 232448;  // opt-in dynamic shared memory of one CTA (227 KB)

enum Route { ROUTE_THREE_PASS = 0, ROUTE_CHUNK = 1 };

struct Factors {
    const int8_t* q[MAX_MODES];   // (I_d, R) int8 codes
    const float* s[MAX_MODES];    // (I_d,) f32 per-row scales
};

// A chunk-route row slot of a warp: the 32 gathered nonzeros' factor rows
// ([k][slot][R] bytes, k the k-th non-target mode) and factor scales
// ([k][slot] f32).
__host__ __device__ constexpr int chunk_row_slot_bytes(int n_other, int R) {
    return n_other * 32 * R + n_other * 32 * 4;
}

// A chunk-route metadata slot of a warp, block-major (u = g * NB + j for
// nonzero j of the warp's block g): coordinates ([u][nmodes] i32, the
// target mode's left unwritten), values ([u] f32), segment ids ([u] i32);
// then the nonzeros' scales, slot-major ([slot] f32).
__host__ __device__ constexpr int chunk_meta_slot_bytes(int nmodes) {
    return 32 * nmodes * 4 + 3 * 32 * 4;
}

// Iterations a warp's row gathers run ahead of its adds (its metadata runs
// twice as far): 2, or 1 at rank 128, where two would not fit.
__host__ __device__ constexpr int chunk_ahead(int R) { return R >= 128 ? 1 : 2; }

// A warp's rings: chunk_ahead + 1 row slots, 2 chunk_ahead + 1 metadata slots.
__host__ __device__ constexpr int chunk_warp_bytes(int n_other, int R) {
    return (chunk_ahead(R) + 1) * chunk_row_slot_bytes(n_other, R)
           + (2 * chunk_ahead(R) + 1) * chunk_meta_slot_bytes(n_other + 1);
}

// Dynamic shared memory of a chunk-route CTA: the warps' rings, 16 floats of
// warp maxima, the chunk's compact partials.
__host__ __device__ constexpr long long chunk_smem_bytes(int nmodes, int R, int chunk_segs) {
    return static_cast<long long>(CHUNK_WARPS) * chunk_warp_bytes(nmodes - 1, R)
           + 16 * 4 + 4ll * chunk_segs * R;
}

// The ADC transfer of one partial: rintf of a true division by the LSB,
// clamped to the codes, back to the partial's scale.
__device__ __forceinline__ float adc_value(float x, float lsb, float code_max) {
    float code = rintf(__fdiv_rn(x, lsb));
    code = fminf(fmaxf(code, -code_max), code_max);
    return __fmul_rn(code, lsb);
}

__device__ __forceinline__ float chunk_lsb(float chunk_max, float levels) {
    return __fdiv_rn(__fmul_rn(2.0f, fmaxf(chunk_max, 1e-30f)), levels);
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
    return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n"
                 :: "r"(smem_u32(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(smem_u32(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// The four int8 codes of a 32-bit word as exact floats, without I2F: each
// byte biased by 128 (q + 128 in 1..255) becomes the low mantissa byte of
// 2^23, and 2^23 + 128 is subtracted (every operand an integer below 2^24).
__device__ __forceinline__ void codes4(unsigned w, float (&x)[4]) {
    const unsigned u = w ^ 0x80808080u;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        x[i] = __fsub_rn(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650 | i)), 8388736.0f);
    }
}

// Pass 1 of the three_pass route: per-segment partials of every block +
// per-chunk max|partial|.
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

// Pass 2 of the three_pass route: digitize every partial, in place, over its
// chunk's full scale.
__global__ void __launch_bounds__(256)
stream_digitize_kernel(float* __restrict__ parts, const int* __restrict__ seg_chunk,
                       const unsigned int* __restrict__ chunk_max,
                       long long n_values, int R, float levels, float code_max) {
    const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (i >= n_values) return;
    const float lsb = chunk_lsb(__uint_as_float(chunk_max[seg_chunk[i / R]]), levels);
    parts[i] = adc_value(parts[i], lsb, code_max);
}

// The chunk route: one CTA per chunk of E blocks (see the note at the top).
// NM modes, R rank columns (16, 32, 64 or 128): a warp walks G = 128 / R
// blocks at once, R / 4 lanes on each.
template <int NM, int R>
__global__ void __launch_bounds__(CHUNK_WARPS * 32)
stream_chunk_kernel(const int* __restrict__ ip, const float* __restrict__ vp,
                    const int* __restrict__ lp, Factors f,
                    const int* __restrict__ seg_ptr, float* __restrict__ parts,
                    unsigned int* __restrict__ chunk_max,
                    int rows, int mode, int E, float levels, float code_max, int adc) {
    constexpr int K = NM - 1;            // non-target modes
    constexpr int G = 128 / R;           // blocks a warp walks at once
    constexpr int NB = 32 / G;           // nonzeros of one block in a warp's batch
    constexpr int LPR = R / 16;          // lanes that copy one factor row, 16 bytes each
    constexpr int LPB = R / 4;           // lanes that add one block, four columns each
    constexpr int A = chunk_ahead(R);
    constexpr int ROW_SLOTS = A + 1;
    constexpr int META_SLOTS = 2 * A + 1;
    constexpr int ROWS_BYTES = K * 32 * R;
    constexpr int ROW_SLOT = chunk_row_slot_bytes(K, R);
    constexpr int META_SLOT = chunk_meta_slot_bytes(NM);
    extern __shared__ __align__(16) unsigned char smem[];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int b0 = blockIdx.x * E;                     // the chunk's first block
    const int seg0 = seg_ptr[b0];
    const int n_local = seg_ptr[b0 + E] - seg0;        // the chunk's segments
    unsigned char* ring = smem + warp * chunk_warp_bytes(K, R);
    unsigned char* meta_ring = ring + ROW_SLOTS * ROW_SLOT;
    float* warp_max = reinterpret_cast<float*>(smem + CHUNK_WARPS * chunk_warp_bytes(K, R));
    float* part = warp_max + 16;                       // (n_local, R) compact partials

    // A warp's work: tasks of G blocks (task t: blocks t*G .., t = warp,
    // warp + CHUNK_WARPS, ...), each walked in batches bb of NB nonzeros a
    // block. Slot s of a batch is nonzero bb * NB + s / G of block
    // t * G + s % G. An iteration is one (t, bb); counters advance without
    // division. In a full iteration (every block and position exists, the
    // common case) no slot is checked.
    const int tasks = (E + G - 1) / G;
    const int batches = (rows + NB - 1) / NB;
    auto advance = [&](int& t, int& bb) {
        if (++bb == batches) {
            bb = 0;
            t += CHUNK_WARPS;
        }
    };
    auto full = [&](int t, int bb) { return t * G + G <= E && bb * NB + NB <= rows; };
    auto slot_ok = [&](int t, int bb, int s) {
        return t < tasks && t * G + s % G < E && bb * NB + s / G < rows;
    };

    // ---- load side: a two-level cp.async pipeline of A iterations, lane =
    // nonzero (slot). The group a warp commits in iteration i holds the
    // metadata (coordinates, value, segment id) of iteration i + 2A and the
    // factor rows and scales of iteration i + A, gathered with coordinates
    // that landed in shared memory A iterations before: no register waits
    // on a load from device memory.
    auto meta_at = [&](int mslot) { return meta_ring + mslot * META_SLOT; };
    auto copy_meta = [&](int t, int bb, int mslot) {
        if (!slot_ok(t, bb, lane)) return;
        int* mip = reinterpret_cast<int*>(meta_at(mslot));
        float* mv = reinterpret_cast<float*>(mip + 32 * NM);
        int* ml = reinterpret_cast<int*>(mv + 32);
        const int g = lane % G, j = lane / G, u = g * NB + j;
        const size_t n = static_cast<size_t>(b0 + t * G + g) * rows + bb * NB + j;
#pragma unroll
        for (int d = 0; d < NM; ++d) {
            if (d != mode) cp_async4(mip + u * NM + d, ip + n * NM + d);
        }
        cp_async4(mv + u, vp + n);
        cp_async4(ml + u, lp + n);
    };
    // A factor row is copied by LPR neighbouring lanes, so one copy
    // instruction touches 32 / LPR rows and each row's sectors once. Rows
    // and scales are slot-major (slot s = j * G + g).
    auto gather_rows = [&](int t, int bb, int mslot, int rslot) {
        const int* mip = reinterpret_cast<const int*>(meta_at(mslot));
        unsigned char* st = ring + rslot * ROW_SLOT;
        float* sc = reinterpret_cast<float*>(st + ROWS_BYTES);
        const bool all = full(t, bb);
        const int u_lane = (lane % G) * NB + lane / G;
        int k = 0;
#pragma unroll
        for (int d = 0; d < NM; ++d) {
            if (d == mode) continue;
            if (all || slot_ok(t, bb, lane)) {
                cp_async4(sc + k * 32 + lane, f.s[d] + mip[u_lane * NM + d]);
            }
#pragma unroll
            for (int i = 0; i < LPR; ++i) {
                const int s = i * (32 / LPR) + lane / LPR;
                const int piece = (lane % LPR) * 16;
                if (all || slot_ok(t, bb, s)) {
                    const int row = mip[((s % G) * NB + s / G) * NM + d];
                    cp_async16(st + k * 32 * R + s * R + piece,
                               f.q[d] + static_cast<size_t>(row) * R + piece);
                }
            }
            ++k;
        }
    };

    // ---- add side: lane = four columns (cq) of the block t*G + gq
    const int gq = lane / LPB;
    const int cq = lane % LPB;
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};   // running sums of the current segment
    float amax = 0.0f;                         // max |flushed partial| of this lane
    int cur = 0;                               // current block-local segment id
    int seg_base = 0;                          // the block's first row of `part`
    bool add_ok = false;
    auto flush = [&]() {
        float4 v = make_float4(acc[0], acc[1], acc[2], acc[3]);
        *reinterpret_cast<float4*>(part + static_cast<size_t>(seg_base + cur) * R + cq * 4) = v;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            amax = fmaxf(amax, fabsf(acc[i]));
            acc[i] = 0.0f;
        }
    };
    // nonzero j of this lane's block: scale * hadamard into the running sums
    auto add = [&](const unsigned char* st, float scale, int j) {
        const unsigned char* row = st + (j * G + gq) * R + cq * 4;
        float had[4];
        codes4(*reinterpret_cast<const unsigned*>(row), had);
#pragma unroll
        for (int k = 1; k < K; ++k) {
            float x[4];
            codes4(*reinterpret_cast<const unsigned*>(row + k * 32 * R), x);
#pragma unroll
            for (int i = 0; i < 4; ++i) had[i] = __fmul_rn(had[i], x[i]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i] = __fadd_rn(acc[i], __fmul_rn(scale, had[i]));
    };

    // iterations it + A (rows) and it + 2A (metadata) ride ahead of it
    int r_t = warp, r_bb = 0, m_t = warp, m_bb = 0;
    for (int i = 0; i < A; ++i) {
        copy_meta(m_t, m_bb, i);
        advance(m_t, m_bb);
    }
    cp_commit();
    cp_wait<0>();
    __syncwarp();
    for (int i = 0; i < A; ++i) {
        gather_rows(r_t, r_bb, i, i);
        advance(r_t, r_bb);
        copy_meta(m_t, m_bb, A + i);
        advance(m_t, m_bb);
        cp_commit();
    }
    int it = 0;
    for (int t = warp, bb = 0; t < tasks; advance(t, bb), ++it) {
        cp_wait<A - 1>();                // the group of iteration it - A: rows of it,
        __syncwarp();                    // metadata of it + A (every lane's)
        gather_rows(r_t, r_bb, (it + A) % META_SLOTS, (it + A) % ROW_SLOTS);
        advance(r_t, r_bb);
        copy_meta(m_t, m_bb, (it + 2 * A) % META_SLOTS);
        advance(m_t, m_bb);
        cp_commit();
        const unsigned char* st = ring + (it % ROW_SLOTS) * ROW_SLOT;
        const float* sc = reinterpret_cast<const float*>(st + ROWS_BYTES);
        float* mv = reinterpret_cast<float*>(meta_at(it % META_SLOTS) + 32 * NM * 4);
        const int* ml = reinterpret_cast<const int*>(mv + 32);
        float* scale = mv + 64;          // [slot]
        if (slot_ok(t, bb, lane)) {      // the nonzero's scale, mode-ascending from the value
            float v = mv[(lane % G) * NB + lane / G];
#pragma unroll
            for (int k = 0; k < K; ++k) v = __fmul_rn(v, sc[k * 32 + lane]);
            scale[lane] = v;
        }
        __syncwarp();

        if (bb == 0) {                   // a new task: each lane's block starts at segment 0
            const int blk = t * G + gq;
            add_ok = gq < G && blk < E;
            cur = 0;
            seg_base = add_ok ? seg_ptr[b0 + blk] - seg0 : 0;
        }
        const int nj = min(NB, rows - bb * NB);
        // the whole batch inside each lane's current segment: no flush to test
        const bool steady = !add_ok || (nj == NB && ml[gq * NB + NB - 1] == cur);
        if (__all_sync(0xffffffffu, steady)) {
            if (add_ok) {
#pragma unroll
                for (int j = 0; j < NB; ++j) add(st, scale[j * G + gq], j);
            }
        } else if (add_ok) {
            for (int j = 0; j < nj; ++j) {
                const int seg = ml[gq * NB + j];
                if (seg != cur) {
                    flush();
                    cur = seg;
                }
                add(st, scale[j * G + gq], j);
            }
        }
        if (add_ok && bb == batches - 1) flush();    // the block's last segment
        __syncwarp();                    // the slots may be refilled
    }
    cp_wait<0>();

    // ---- the chunk-wide ADC, in place, then one write of each partial
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
    }
    if (lane == 0) warp_max[warp] = amax;
    __syncthreads();                     // every partial and every warp's max is in
    float cmax = 0.0f;
#pragma unroll
    for (int w = 0; w < CHUNK_WARPS; ++w) cmax = fmaxf(cmax, warp_max[w]);
    if (threadIdx.x == 0) chunk_max[blockIdx.x] = __float_as_uint(cmax);
    const float lsb = chunk_lsb(cmax, levels);
    const float4* src = reinterpret_cast<const float4*>(part);
    float4* dst = reinterpret_cast<float4*>(parts + static_cast<size_t>(seg0) * R);
    const int n4 = n_local * R / 4;
    for (int i = threadIdx.x; i < n4; i += blockDim.x) {
        float4 v = src[i];
        if (adc) {
            v.x = adc_value(v.x, lsb, code_max);
            v.y = adc_value(v.y, lsb, code_max);
            v.z = adc_value(v.z, lsb, code_max);
            v.w = adc_value(v.w, lsb, code_max);
        }
        dst[i] = v;
    }
}

// The row fold: add the run of segments that belongs to each output row, in
// stream order, from 0. The adds of one (row, column) are a serial chain: an
// add takes a few cycles, a load from L2 hundreds.
// * A run of at most long_run segments (every row of the uniform modes) is
//   one warp's, lane = rank column: FOLD_BATCH loads in flight, then their
//   adds. Four warps a CTA, one per (row, 32 columns).
// * A longer run (the power-law head rows of mode 0: up to ~9.8 k segments
//   on the main path) gets a CTA of its own, scheduled first (the first
//   n_long CTAs): all its threads stream the run into a ring of LONG_STAGES
//   shared-memory stages with cp.async, LONG_STAGES - 1 stages ahead, and
//   warp 0 adds them, lane = rank column, so the chain is fed from shared
//   memory instead of waiting one round trip every FOLD_BATCH segments.
template <bool VEC>
__device__ void fold_long_run(const float* __restrict__ parts, const int* __restrict__ row_ptr,
                              int row, float* __restrict__ out, int R, float* smem) {
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int rows_per_stage = R >= LONG_STAGE_FLOATS ? 1 : LONG_STAGE_FLOATS / R;
    const int stage_floats = rows_per_stage * R;
    float* acc = smem + LONG_STAGES * stage_floats;     // the running sums, R floats
    const int lo = row_ptr[row];
    const int n_rows = row_ptr[row + 1] - lo;
    const float* src = parts + static_cast<size_t>(lo) * R;
    const int n_stages = (n_rows + rows_per_stage - 1) / rows_per_stage;
    auto fetch = [&](int st) {
        const int nr = min(rows_per_stage, n_rows - st * rows_per_stage);
        float* dst = smem + (st % LONG_STAGES) * stage_floats;
        const float* from = src + static_cast<size_t>(st) * stage_floats;
        if constexpr (VEC) {
            for (int i = tid * 4; i < nr * R; i += FOLD_WARPS * 32 * 4) cp_async16(dst + i, from + i);
        } else {
            for (int i = tid; i < nr * R; i += FOLD_WARPS * 32) cp_async4(dst + i, from + i);
        }
    };
    if (tid < 32) {
        for (int c = lane; c < R; c += 32) acc[c] = 0.0f;
    }
#pragma unroll
    for (int st = 0; st < LONG_STAGES - 1; ++st) {
        if (st < n_stages) fetch(st);
        cp_commit();
    }
    for (int st = 0; st < n_stages; ++st) {
        if (st + LONG_STAGES - 1 < n_stages) fetch(st + LONG_STAGES - 1);   // the slot freed
        cp_commit();                                                        // by st - 1
        cp_wait<LONG_STAGES - 1>();     // this thread's copies of stage st landed
        __syncthreads();                // ... and everyone's
        if (tid < 32) {
            const float* slot = smem + (st % LONG_STAGES) * stage_floats;
            const int nr = min(rows_per_stage, n_rows - st * rows_per_stage);
            for (int c = lane; c < R; c += 32) {
                float v = acc[c];
#pragma unroll 32
                for (int i = 0; i < nr; ++i) v = __fadd_rn(v, slot[i * R + c]);
                acc[c] = v;
            }
        }
        __syncthreads();                // the slot may be refilled
    }
    if (tid < 32) {
        for (int c = lane; c < R; c += 32) out[static_cast<size_t>(row) * R + c] = acc[c];
    }
}

template <bool VEC>
__global__ void __launch_bounds__(FOLD_WARPS * 32)
stream_fold_kernel(const float* __restrict__ parts, const int* __restrict__ row_ptr,
                   const int* __restrict__ long_rows, int n_long, int long_run,
                   float* __restrict__ out, int out_rows, int R, int rtiles) {
    extern __shared__ __align__(16) float fold_smem[];
    if (static_cast<int>(blockIdx.x) < n_long) {
        fold_long_run<VEC>(parts, row_ptr, long_rows[blockIdx.x], out, R, fold_smem);
        return;
    }
    const long long warp =
        (static_cast<long long>(blockIdx.x - n_long) * blockDim.x + threadIdx.x) >> 5;
    const int lane = threadIdx.x & 31;
    if (warp >= static_cast<long long>(out_rows) * rtiles) return;
    const int row = static_cast<int>(warp / rtiles);
    const int r = static_cast<int>(warp % rtiles) * 32 + lane;
    if (r >= R) return;
    const int lo = row_ptr[row];
    const int hi = row_ptr[row + 1];
    if (n_long > 0 && hi - lo > long_run) return;      // a CTA of its own folds it
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

// Dynamic shared memory of a long-run fold CTA: the ring and the running sums.
__host__ __device__ constexpr long long fold_long_smem_bytes(int R) {
    return 4ll * (static_cast<long long>(LONG_STAGES) * (R >= LONG_STAGE_FLOATS ? R
                  : LONG_STAGE_FLOATS / R * R) + R);
}

// Lets Kernel launch with up to MAX_SMEM bytes of dynamic shared memory:
// once per device, since the attribute holds for every later launch there.
template <auto Kernel>
cudaError_t opt_in_max_smem() {
    constexpr int MAX_DEVICES = 64;
    static bool done[MAX_DEVICES] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev < MAX_DEVICES && done[dev]) return cudaSuccess;
    err = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (err == cudaSuccess && dev < MAX_DEVICES) done[dev] = true;
    return err;
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

template <int NM, int R>
cudaError_t launch_chunk_r(const int* ip, const float* vp, const int* lp, const Factors& f,
                           const int* seg_ptr, float* parts, unsigned int* chunk_max,
                           int nb, int rows, int mode, int E, float levels, float code_max,
                           int adc, size_t smem, cudaStream_t stream) {
    const cudaError_t err = opt_in_max_smem<stream_chunk_kernel<NM, R>>();
    if (err != cudaSuccess) return err;
    stream_chunk_kernel<NM, R><<<nb, CHUNK_WARPS * 32, smem, stream>>>(ip, vp, lp, f, seg_ptr, parts, chunk_max,
                                                   rows, mode, E, levels, code_max, adc);
    return cudaGetLastError();
}

template <int NM>
cudaError_t launch_chunk(const int* ip, const float* vp, const int* lp, const Factors& f,
                         const int* seg_ptr, float* parts, unsigned int* chunk_max,
                         int nb, int rows, int R, int mode, int E, float levels,
                         float code_max, int adc, size_t smem, cudaStream_t stream) {
    switch (R) {
#define LAUNCH_CHUNK_R(RR)                                                                 \
    case RR:                                                                               \
        return launch_chunk_r<NM, RR>(ip, vp, lp, f, seg_ptr, parts, chunk_max, nb, rows,  \
                                      mode, E, levels, code_max, adc, smem, stream);
        LAUNCH_CHUNK_R(16)
        LAUNCH_CHUNK_R(32)
        LAUNCH_CHUNK_R(64)
        LAUNCH_CHUNK_R(128)
#undef LAUNCH_CHUNK_R
        default:
            return cudaErrorInvalidValue;
    }
}

}  // namespace

// The dynamic shared memory a chunk-route CTA needs (the Python route rule
// reads it; a CTA may opt in to MAX_SMEM bytes).
extern "C" long long stream_chunk_smem_bytes(int nmodes, int R, int chunk_segs) {
    return chunk_smem_bytes(nmodes, R, chunk_segs);
}

// ip (nb,E,rows,nmodes) i32, vp/lp (nb,E,rows) f32/i32; q_ptrs/s_ptrs host
// arrays of nmodes device pointers (the target mode's entries are never
// read); seg_ptr (nb*E+1,) i32 first compact-scratch row of each block;
// seg_chunk (total_segs,) i32 chunk of each compact segment; row_ptr
// (out_rows+1,) i32 run of compact segments per output row; parts
// (total_segs, R) f32 scratch (left digitized); chunk_max (nb,) u32 scratch
// (bits of the per-chunk max|partial|, readable after the call); out
// (out_rows, R) f32. route: 0 three_pass, 1 chunk (R = 16, 32, 64 or 128,
// 16-byte aligned factor codes, chunk_segs the most segments one chunk
// holds, and chunk_smem_bytes within MAX_SMEM). long_rows (n_long,) i32:
// the rows whose run holds more than long_run segments, each folded by a CTA
// of its own; the fold's warps skip exactly those runs. Returns the first
// failing cudaError_t as an int (0 = launched).
extern "C" int stream_mttkrp_launch(const void* ip, const void* vp, const void* lp,
                                    const void* const* q_ptrs, const void* const* s_ptrs,
                                    const void* seg_ptr, const void* seg_chunk,
                                    const void* row_ptr, void* parts, void* chunk_max,
                                    void* out, int nb, int E, int rows, int nmodes, int mode,
                                    int R, int out_rows, int total_segs, int adc_bits,
                                    int route, int chunk_segs, const void* long_rows,
                                    int n_long, int long_run, void* stream_ptr) {
    if (nmodes < 2 || nmodes > MAX_MODES || mode < 0 || mode >= nmodes || R < 1
            || (route != ROUTE_THREE_PASS && route != ROUTE_CHUNK)) {
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
    const float levels = static_cast<float>(1ll << adc_bits);
    const float code_max = static_cast<float>((1ll << adc_bits) / 2 - 1);
    const int* ip_ = static_cast<const int*>(ip);
    const float* vp_ = static_cast<const float*>(vp);
    const int* lp_ = static_cast<const int*>(lp);
    const int* seg_ptr_ = static_cast<const int*>(seg_ptr);
    float* parts_ = static_cast<float*>(parts);
    unsigned int* chunk_max_ = static_cast<unsigned int*>(chunk_max);
    cudaError_t err = cudaSuccess;

    if (route == ROUTE_CHUNK) {
        const long long smem = chunk_smem_bytes(nmodes, R, chunk_segs);
        if ((R != 16 && R != 32 && R != 64 && R != 128) || chunk_segs < 1 || smem > MAX_SMEM) {
            return static_cast<int>(cudaErrorInvalidValue);
        }
        for (int d = 0; d < nmodes; ++d) {
            if (d != mode && reinterpret_cast<uintptr_t>(f.q[d]) % 16 != 0) {
                return static_cast<int>(cudaErrorMisalignedAddress);
            }
        }
#define LAUNCH_CHUNK(NM)                                                                   \
    case NM:                                                                               \
        err = launch_chunk<NM>(ip_, vp_, lp_, f, seg_ptr_, parts_, chunk_max_, nb, rows, R, \
                               mode, E, levels, code_max, adc_bits > 0,                    \
                               static_cast<size_t>(smem), stream);                         \
        break;
        switch (nmodes) {
            LAUNCH_CHUNK(2)
            LAUNCH_CHUNK(3)
            LAUNCH_CHUNK(4)
            LAUNCH_CHUNK(5)
            LAUNCH_CHUNK(6)
            LAUNCH_CHUNK(7)
            LAUNCH_CHUNK(8)
            default:
                err = cudaErrorInvalidValue;
        }
#undef LAUNCH_CHUNK
        if (err != cudaSuccess) return static_cast<int>(err);
    } else {
        err = cudaMemsetAsync(chunk_max, 0, sizeof(unsigned int) * static_cast<size_t>(nb), stream);
        if (err != cudaSuccess) return static_cast<int>(err);
#define LAUNCH_PARTIALS(NM)                                                                \
    case NM:                                                                               \
        err = launch_partials<NM>(ip_, vp_, lp_, f, seg_ptr_, parts_, chunk_max_, n_blocks, \
                                  rows, R, rtiles, mode, E, stream);                       \
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
            const unsigned int ctas = static_cast<unsigned int>((n_values + 255) / 256);
            stream_digitize_kernel<<<ctas, 256, 0, stream>>>(
                parts_, static_cast<const int*>(seg_chunk), chunk_max_, n_values, R, levels,
                code_max);
            err = cudaGetLastError();
            if (err != cudaSuccess) return static_cast<int>(err);
        }
    }
    if (out_rows > 0) {
        // a rank too wide for the long-run ring leaves every run to the warps
        const long long fold_smem = fold_long_smem_bytes(R);
        if (fold_smem > MAX_SMEM) n_long = 0;
        const size_t smem = n_long > 0 ? static_cast<size_t>(fold_smem) : 0;
        const long long warps = static_cast<long long>(out_rows) * rtiles;
        const unsigned int ctas = static_cast<unsigned int>(
            n_long + (warps + FOLD_WARPS - 1) / FOLD_WARPS);
        // 16-byte copies where every run starts on 16 bytes (parts is)
        const bool vec = R % 4 == 0 && reinterpret_cast<uintptr_t>(parts) % 16 == 0;
        auto kernel = vec ? stream_fold_kernel<true> : stream_fold_kernel<false>;
        if (smem > 0) {
            err = vec ? opt_in_max_smem<stream_fold_kernel<true>>()
                      : opt_in_max_smem<stream_fold_kernel<false>>();
            if (err != cudaSuccess) return static_cast<int>(err);
        }
        kernel<<<ctas, FOLD_WARPS * 32, smem, stream>>>(
            parts_, static_cast<const int*>(row_ptr), static_cast<const int*>(long_rows),
            n_long, long_run, static_cast<float*>(out), out_rows, R, rtiles);
        err = cudaGetLastError();
    }
    return static_cast<int>(err);
}

// The runtime's text for an error code returned by the launch entry.
extern "C" const char* stream_mttkrp_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}
