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
// the q tiles are handed out heaviest first, every head's heaviest tile
// before any lighter one, so the last wave is short.
//
// Semantics kept from the reference (and its plain version in
// kernels/flash_attention.py): s = dot(q, k) * scale; then
// tanh(s / softcap) * softcap when softcap > 0; then the causal mask
// row >= col applied as -1e30 (not -inf), top-left aligned (row i sees keys
// 0..i, also where Sq != Skv); online max, sum and accumulator in f32;
// out = acc / max(l, 1e-30) rounded once to q's dtype. The kv head of flat
// head bh is (bh / H) * Hkv + (bh % H) / (H / Hkv). expf, tanhf and the
// divisions are the accurate ones (no --use_fast_math).
//
// What bounds it: operations. A causal prefill at 32k tokens and D = 128 does
// 4 * D operations per unmasked (query, key) pair against 4 * D bytes per
// token of q, k, v and out, far above the card's byte/operation balance.
//
// The reference takes any head dim D. Here D = 16, 32, 64, 128 and 256 are
// instantiated (the wrapper zero-pads any other D up to 256 to the next of
// them) and D > 256 runs on the slab kernel (padded to a multiple of 64).
//
// Three kernels:
//
// * bf16 (the serving path's type), built on Hopper's warpgroup MMA (wgmma)
//   and the tensor memory accelerator (TMA). A CTA is three warpgroups over
//   a 128-row q tile: warpgroup 0 is the producer — one thread issues TMA
//   loads of the Q tile (once) and of BN-key K and V tiles (BN = 128 up to
//   D = 128, 64 at D = 256: see Tiles) into a two-stage
//   ring in shared memory, each stage with its own full (bytes landed) and
//   empty (consumers done) mbarrier, K and V apart so that Q K^T can start
//   before V lands; it gives its registers away (setmaxnreg 24). Warpgroups
//   1 and 2 are consumers (setmaxnreg 240), each owning 64 q rows:
//     S = Q K^T   wgmma m64nBNk16, both operands from shared memory, K-major,
//                 in the 128-byte swizzle the TMA writes (descriptors match);
//                 products of two bf16 values are exact in f32, so the
//                 tensor cores compute the same sums as f32 FMAs up to order;
//     softmax     in registers, in the order above; only tiles that cross
//                 the diagonal or Skv evaluate the mask;
//     O += P V    wgmma m64nDk16 with A from registers: the f32 accumulator
//                 layout of S is the A-fragment layout once packed to bf16,
//                 so P never touches shared memory; B is V as it lies (keys x
//                 D, D contiguous), an MN-major operand read through the
//                 descriptor's transpose bit, never copied. The reference
//                 keeps P in f32, where one bf16 P would cost 2^-9 a weight:
//                 P is split into hi = bf16(p) and lo = bf16(p - hi), both
//                 multiplied into the f32 accumulator (2^-17 a weight). That
//                 makes 6 * D operations a pair on the tensor cores where the
//                 function needs 4 * D: the design's own floor is 1.5 times
//                 the operation bound.
//   Schedule: the consumers take turns on the tensor cores (ping-pong over
//   two named barriers), each turn P V of the previous tile then Q K^T of
//   this one, so one consumer's softmax runs while the other's products
//   do. On the H100 at the 32k prefill this beat each consumer running its
//   tiles alone, and issuing the next tile's Q K^T under this tile's P V
//   (with or without ping-pong), in alternating runs of one process. A
//   wgmma under a condition makes ptxas serialise around it, so the loop
//   is peeled.
//   Head dims under 64 are held 64 wide in shared memory: the TMA box is
//   64 columns and fills the columns past D with zeros, Q K^T reads only
//   the first D, and P V runs 64 wide and stores D. Rows past Sq and keys
//   past Skv arrive as zeros; keys past Skv are masked to -1e30.
// * f32: IEEE f32 FMAs on the CUDA cores, no TF32. A CTA is 128 threads
//   over a 32-row q tile, 4 threads per row, each holding a quarter of the
//   row's q and accumulator (dims sub, sub + 4, ...); a score is the
//   quarter-sums added by a butterfly, so the four threads agree bit for bit.
// * slabs (D > 256, f32): the f32 kernel's layout over a third grid axis of
//   256-column output slabs, each CTA forming the whole score itself (see
//   flash_slab_kernel).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr float NEG = -1e30f;

__device__ __forceinline__ float score(float dot, float scale, float softcap, bool masked) {
    float s = __fmul_rn(dot, scale);
    if (softcap > 0.f) s = __fmul_rn(tanhf(__fdiv_rn(s, softcap)), softcap);
    return masked ? NEG : s;
}

// ------------------------------------------------------------------ bf16 ---

constexpr int BQ = 128;           // q rows per CTA: two consumer warpgroups x 64
constexpr int STAGES = 2;         // K/V tiles in the ring
constexpr int WG = 128;           // threads of a warpgroup
constexpr int BF16_THREADS = 3 * WG;
constexpr int ROW_BYTES = 128;    // one row of a 128-byte swizzle atom: 64 bf16

// Keys per K/V tile: 128 up to D = 128; 64 at D = 256, where a 128-key ring
// (1 KB + Q 64 KB + 2 stages x (K + V) x 64 KB = 321 KB) passes the 227 KB a
// CTA can have, and S (64 floats a thread at 128 keys) beside O (128 floats)
// and the two P fragments passes the consumers' 240 registers. At 64 keys
// the CTA holds 193 KB and a consumer thread O 128 + S 32 + P 32 registers:
// the same 192 as at D = 128 with 128 keys.
template <int D>
struct Tiles {
    static constexpr int BN = D > 128 ? 64 : 128;
    static constexpr int DP = D < 64 ? 64 : D;        // columns held in shared memory
    static constexpr int HALVES = DP / 64;            // 128-byte column blocks
    static constexpr int Q_BYTES = HALVES * BQ * ROW_BYTES;
    static constexpr int KV_BYTES = HALVES * BN * ROW_BYTES;
    static constexpr int BARRIERS = 1 + 4 * STAGES;
    // + up to 1023 bytes to align the ring to the swizzle's 1024-byte period
    static constexpr int SMEM = 1024 + Q_BYTES + 2 * STAGES * KV_BYTES + 8 * BARRIERS;
};

// D = A B for a 64 x N tile, A (64 x 16) and B (16 x N) bf16 in shared
// memory, both K-major (N = 128 or 64, the tile's keys): _init overwrites d,
// the other accumulates; the register-A form takes A as a fragment and B
// MN-major (transpose bit), N = 64, 128 or 256 (the held head dim). N is the
// extent of d times 2.
__device__ __forceinline__ void wgmma_ss_init(float (&d)[64], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]), "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]), "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31]), "=f"(d[32]), "=f"(d[33]), "=f"(d[34]), "=f"(d[35]), "=f"(d[36]), "=f"(d[37]), "=f"(d[38]), "=f"(d[39]), "=f"(d[40]), "=f"(d[41]), "=f"(d[42]), "=f"(d[43]), "=f"(d[44]), "=f"(d[45]), "=f"(d[46]), "=f"(d[47]), "=f"(d[48]), "=f"(d[49]), "=f"(d[50]), "=f"(d[51]), "=f"(d[52]), "=f"(d[53]), "=f"(d[54]), "=f"(d[55]), "=f"(d[56]), "=f"(d[57]), "=f"(d[58]), "=f"(d[59]), "=f"(d[60]), "=f"(d[61]), "=f"(d[62]), "=f"(d[63])
        : "l"(a), "l"(b), "r"(0));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_ss_init(float (&d)[32], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]), "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]), "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31])
        : "l"(a), "l"(b), "r"(0));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[128], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ uint32_t bf2_bits(__nv_bfloat162 v) {
    return static_cast<uint32_t>(__bfloat16_as_ushort(v.x)) |
           (static_cast<uint32_t>(__bfloat16_as_ushort(v.y)) << 16);
}

// The tile's scores in place: scale, softcap, then (MASK) the causal and
// past-Skv mask. Element 4j+e of the accumulator is row (e < 2 ? row0 :
// row1), column kv0 + 8j + 2*t4 + (e & 1).
template <bool MASK, bool CAP, int NS>
__device__ __forceinline__ void tile_scores(float (&s)[NS], int kv0, int row0, int row1, int t4,
                                            int Skv, int causal, float scale, float softcap) {
#pragma unroll
    for (int j = 0; j < NS / 4; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            float x = __fmul_rn(s[4 * j + e], scale);
            if (CAP) x = __fmul_rn(tanhf(__fdiv_rn(x, softcap)), softcap);
            if (MASK) {
                const int col = kv0 + 8 * j + 2 * t4 + (e & 1);
                const int row = e < 2 ? row0 : row1;
                if (col >= Skv || (causal && col > row)) x = NEG;
            }
            s[4 * j + e] = x;
        }
    }
}

// S = Q K^T for the warpgroup's 64 rows and one tile of BN = 2 NS keys
template <int D, int NS>
__device__ __forceinline__ void issue_qk(float (&s)[NS], uint32_t q_wg, uint32_t kb) {
    constexpr int BN = 2 * NS;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
        const uint64_t da = sw128_desc(q_wg + (kk / 4) * BQ * ROW_BYTES + (kk % 4) * 32, 16, 1024);
        const uint64_t db = sw128_desc(kb + (kk / 4) * BN * ROW_BYTES + (kk % 4) * 32, 16, 1024);
        if (kk == 0) {
            wgmma_ss_init(s, da, db);
        } else {
            wgmma_ss(s, da, db);
        }
    }
}

// O += P_hi V + P_lo V for one tile of BN keys of V
template <int BN, int NO>
__device__ __forceinline__ void issue_pv(float (&o)[NO], const uint32_t (&ph)[BN / 16][4],
                                         const uint32_t (&pl)[BN / 16][4], uint32_t vb) {
#pragma unroll
    for (int kc = 0; kc < BN / 16; ++kc) {
        const uint64_t db = sw128_desc(vb + kc * 16 * ROW_BYTES, BN * ROW_BYTES, 1024);
        wgmma_rs(o, ph[kc], db);
        wgmma_rs(o, pl[kc], db);
    }
}

// One tile's online softmax for rows row0 and row1: scores, mask, running
// max and sum, O rescaled, and P as hi + lo bf16 A fragments — for 16 keys
// kc, registers (row0, keys 2t4..), (row1, keys 2t4..), (row0, keys
// 8+2t4..), (row1, keys 8+2t4..): accumulator blocks 2kc and 2kc+1 as they
// lie.
template <int NS, int NO>
__device__ __forceinline__ void online_softmax(float (&s)[NS], float (&o)[NO],
                                               uint32_t (&ph)[NS / 8][4],
                                               uint32_t (&pl)[NS / 8][4], float& m0, float& m1,
                                               float& l0, float& l1, bool edge, int kv0, int row0,
                                               int row1, int t4, int Skv, int causal, float scale,
                                               float softcap) {
    if (softcap > 0.f) {
        if (edge) {
            tile_scores<true, true>(s, kv0, row0, row1, t4, Skv, causal, scale, softcap);
        } else {
            tile_scores<false, true>(s, kv0, row0, row1, t4, Skv, causal, scale, softcap);
        }
    } else {
        if (edge) {
            tile_scores<true, false>(s, kv0, row0, row1, t4, Skv, causal, scale, softcap);
        } else {
            tile_scores<false, false>(s, kv0, row0, row1, t4, Skv, causal, scale, softcap);
        }
    }
    float mx0 = NEG, mx1 = NEG;
#pragma unroll
    for (int j = 0; j < NS / 4; ++j) {
        mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
        mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
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
    for (int j = 0; j < NS / 4; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
            s[4 * j + e] = expf(s[4 * j + e] - mn0);
            s[4 * j + 2 + e] = expf(s[4 * j + 2 + e] - mn1);
            sum0 += s[4 * j + e];
            sum1 += s[4 * j + 2 + e];
        }
    }
    l0 = l0 * alpha0 + sum0;          // this thread's share of the row sums
    l1 = l1 * alpha1 + sum1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int j = 0; j < NO / 4; ++j) {
        o[4 * j] *= alpha0;
        o[4 * j + 1] *= alpha0;
        o[4 * j + 2] *= alpha1;
        o[4 * j + 3] *= alpha1;
    }
#pragma unroll
    for (int kc = 0; kc < NS / 8; ++kc) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
            const float x0 = s[4 * (2 * kc + (r >> 1)) + (r & 1) * 2];
            const float x1 = s[4 * (2 * kc + (r >> 1)) + (r & 1) * 2 + 1];
            const __nv_bfloat162 hi = __floats2bfloat162_rn(x0, x1);
            ph[kc][r] = bf2_bits(hi);
            pl[kc][r] = bf2_bits(__floats2bfloat162_rn(x0 - __low2float(hi), x1 - __high2float(hi)));
        }
    }
}

// named barriers 1 and 2 hand the tensor cores from one consumer warpgroup
// to the other (both warpgroups, 256 threads, take part)
__device__ __forceinline__ void named_sync(int id) {
    asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(2 * WG) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
    asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(2 * WG) : "memory");
}

template <int D>
__global__ void __launch_bounds__(BF16_THREADS, 1)
flash_bf16_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                  const __grid_constant__ CUtensorMap vmap, __nv_bfloat16* __restrict__ out, int H,
                  int Hkv, int Sq, int Skv, float scale, float softcap, int causal) {
    using T = Tiles<D>;
    constexpr int BN = T::BN;
    constexpr int NS = BN / 2;        // S accumulator floats per thread
    constexpr int NO = T::DP / 2;     // O accumulator floats per thread
    static_assert(D == 16 || D == 32 || D == 64 || D == 128 || D == 256,
                  "D must be 16, 32, 64, 128 or 256");
    extern __shared__ uint8_t smem_raw[];
    const uint32_t q_s = (smem_u32(smem_raw) + 1023u) & ~1023u;
    const uint32_t k_s = q_s + T::Q_BYTES;                   // stage st at + st * KV_BYTES
    const uint32_t v_s = k_s + STAGES * T::KV_BYTES;
    const uint32_t bars = v_s + STAGES * T::KV_BYTES;
    const uint32_t q_full = bars;
    auto k_full = [&](int st) { return bars + 8u * (1 + st); };
    auto v_full = [&](int st) { return bars + 8u * (1 + STAGES + st); };
    auto k_empty = [&](int st) { return bars + 8u * (1 + 2 * STAGES + st); };
    auto v_empty = [&](int st) { return bars + 8u * (1 + 3 * STAGES + st); };

    const int tid = threadIdx.x;
    const int bh = blockIdx.x;
    const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;       // heaviest q tiles first
    const int kvh = (bh / H) * Hkv + (bh % H) / (H / Hkv);
    int n_tiles = (Skv + BN - 1) / BN;
    if (causal) n_tiles = min(n_tiles, (min(q0 + BQ, Sq) - 1) / BN + 1);

    if (tid == 0) {
        mbar_init(q_full, 1);
        for (int st = 0; st < STAGES; ++st) {
            mbar_init(k_full(st), 1);
            mbar_init(v_full(st), 1);
            mbar_init(k_empty(st), 2 * WG);
            mbar_init(v_empty(st), 2 * WG);
        }
        mbar_init_fence();
    }
    __syncthreads();

    if (tid < WG) {
        // ---- producer: one thread keeps the ring full
        asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
        if (tid == 0) {
            mbar_expect_tx(q_full, T::Q_BYTES);
            for (int h = 0; h < T::HALVES; ++h) {
                tma_load_3d(q_s + h * BQ * ROW_BYTES, &qmap, q_full, 64 * h, q0, bh);
            }
            for (int t = 0; t < n_tiles; ++t) {
                const int st = t % STAGES;
                const uint32_t par = ((t / STAGES) & 1) ^ 1;    // the first wait passes
                mbar_wait(k_empty(st), par);
                mbar_expect_tx(k_full(st), T::KV_BYTES);
                for (int h = 0; h < T::HALVES; ++h) {
                    tma_load_3d(k_s + st * T::KV_BYTES + h * BN * ROW_BYTES, &kmap, k_full(st), 64 * h,
                             t * BN, kvh);
                }
                mbar_wait(v_empty(st), par);
                mbar_expect_tx(v_full(st), T::KV_BYTES);
                for (int h = 0; h < T::HALVES; ++h) {
                    tma_load_3d(v_s + st * T::KV_BYTES + h * BN * ROW_BYTES, &vmap, v_full(st), 64 * h,
                             t * BN, kvh);
                }
            }
        }
    } else {
        // ---- consumers: 64 q rows each
        asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
        const int c = tid / WG - 1;
        const int ltid = tid % WG;
        const int warp = ltid / 32;
        const int lane = ltid % 32;
        const int g = lane / 4;                  // accumulator row group
        const int t4 = lane % 4;                 // thread in group
        const int wrow0 = q0 + 64 * c;           // the warpgroup's first row
        const int row0 = wrow0 + 16 * warp + g;  // rows of elements 4j, 4j+1 and 4j+2, 4j+3
        const int row1 = row0 + 8;
        const uint32_t q_wg = q_s + c * 64 * ROW_BYTES;

        float o[NO];
#pragma unroll
        for (int i = 0; i < NO; ++i) o[i] = 0.f;
        float m0 = NEG, m1 = NEG, l0 = 0.f, l1 = 0.f;
        mbar_wait(q_full, 0);

        uint32_t ph[BN / 16][4], pl[BN / 16][4];
        auto edge_of = [&](int kv0) { return kv0 + BN > Skv || (causal && kv0 + BN - 1 > wrow0); };
        // ping-pong (see the note at the top): warpgroup 0 takes the first turn
        if (c == 1) named_arrive(1);
        {
            float s[NS];
            mbar_wait(k_full(0), 0);
            named_sync(1 + c);
            wgmma_fence();
            issue_qk<D>(s, q_wg, k_s);
            wgmma_commit();
            named_arrive(2 - c);
            wgmma_wait_all();
            pin(s);
            mbar_arrive(k_empty(0));
            online_softmax(s, o, ph, pl, m0, m1, l0, l1, edge_of(0), 0, row0, row1, t4, Skv, causal,
                           scale, softcap);
        }
        for (int t = 1; t < n_tiles; ++t) {
            const int st = t % STAGES, pst = (t - 1) % STAGES;
            float s[NS];
            mbar_wait(k_full(st), (t / STAGES) & 1);
            mbar_wait(v_full(pst), ((t - 1) / STAGES) & 1);
            named_sync(1 + c);
            pin(o);
            wgmma_fence();
            issue_pv<BN>(o, ph, pl, v_s + pst * T::KV_BYTES);
            issue_qk<D>(s, q_wg, k_s + st * T::KV_BYTES);
            wgmma_commit();
            named_arrive(2 - c);
            wgmma_wait_all();
            pin(o);
            pin(s);
            pin(ph);
            pin(pl);
            mbar_arrive(v_empty(pst));
            mbar_arrive(k_empty(st));
            online_softmax(s, o, ph, pl, m0, m1, l0, l1, edge_of(t * BN), t * BN, row0, row1, t4,
                           Skv, causal, scale, softcap);
        }
        {
            const int pst = (n_tiles - 1) % STAGES;
            mbar_wait(v_full(pst), ((n_tiles - 1) / STAGES) & 1);
            named_sync(1 + c);
            pin(o);
            wgmma_fence();
            issue_pv<BN>(o, ph, pl, v_s + pst * T::KV_BYTES);
            wgmma_commit();
            if (c == 0) named_arrive(2);
            wgmma_wait_all();
            pin(o);
            pin(ph);
            pin(pl);
            mbar_arrive(v_empty(pst));
        }

#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
            l0 += __shfl_xor_sync(0xffffffffu, l0, off);
            l1 += __shfl_xor_sync(0xffffffffu, l1, off);
        }
        const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
        __nv_bfloat16* ob = out + static_cast<size_t>(bh) * Sq * D;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
            const int col = 8 * j + 2 * t4;
            if (row0 < Sq) {
                *reinterpret_cast<__nv_bfloat162*>(&ob[static_cast<size_t>(row0) * D + col]) =
                    __floats2bfloat162_rn(__fdiv_rn(o[4 * j], d0), __fdiv_rn(o[4 * j + 1], d0));
            }
            if (row1 < Sq) {
                *reinterpret_cast<__nv_bfloat162*>(&ob[static_cast<size_t>(row1) * D + col]) =
                    __floats2bfloat162_rn(__fdiv_rn(o[4 * j + 2], d1), __fdiv_rn(o[4 * j + 3], d1));
            }
        }
    }
}

// A (heads, S, D) bf16 tensor as a 3-D TMA map with (64-column, `rows`-row,
// 1-head) boxes; boxes past S or D fill with zeros.
bool tensor_map(CUtensorMap* map, const void* ptr, int D, int S, int heads, int rows) {
    const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(S),
                                static_cast<cuuint64_t>(heads)};
    const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(rows), 1};
    return hopper::encode_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, 3, ptr, dims, box);
}

// ------------------------------------------------------------------- f32 ---

constexpr int FQ = 32;            // q rows per CTA (4 threads a row)
constexpr int FKV = 32;           // keys per shared-memory tile
constexpr int F32_THREADS = 128;

// The K and V tiles as dynamic shared memory (2 x FKV x D floats: 64 KB at
// D = 256, past the 48 KB a CTA can hold statically).
template <int D>
constexpr int f32_smem_bytes() { return 2 * FKV * D * static_cast<int>(sizeof(float)); }

template <int D>
__global__ void __launch_bounds__(F32_THREADS)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out, int H, int Hkv, int Sq,
                 int Skv, float scale, float softcap, int causal) {
    constexpr int NV = D / 4;         // dims a thread holds: sub, sub + 4, ...
    extern __shared__ __align__(16) float f32_smem[];
    float (*Ks)[D] = reinterpret_cast<float (*)[D]>(f32_smem);
    float (*Vs)[D] = reinterpret_cast<float (*)[D]>(f32_smem + FKV * D);

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
        for (int it = 0; it < (FKV * D / 4) / F32_THREADS; ++it) {
            const int c = tid + it * F32_THREADS;
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

// ---------------------------------------------------------------- slabs ---
//
// D > 256 (a multiple of 64; the wrapper zero-pads to one), f32 on the CUDA
// cores: bf16 and fp16 are staged to f32 by the wrapper and rounded once. A
// third grid axis runs over ceil(D / SLAB) slabs of output columns; each CTA
// keeps its slab's accumulator in registers and forms the whole score
// q k^T over all of D itself, in SLAB-column chunks of q, K (and, with the
// last chunk, its slab of V) staged through shared memory, before the
// softmax and P V over its own slab of V. So the scores are formed once a
// slab: ceil(D / SLAB) times the q k^T work of one pass.
// Layout: the f32 kernel's 32-row q tile, 4 threads a row, but thread `sub`
// holds a contiguous quarter of each chunk (columns 64 sub .. 64 sub + 63)
// rather than every fourth column, so it reads K and V as 16-byte vectors:
// a warp's 4 distinct vectors (one per sub) sit in distinct banks because
// each 64-column quarter of a staged row is padded by 4 floats (QUARTER),
// and the 8 rows of a warp read them as one broadcast. One 16-byte load
// feeds 4 FMAs a lane, where the f32 kernel's interleaved columns take one
// 4-byte load an FMA. The staging loops keep 4 loads a thread in flight,
// which leaves the registers to the accumulators (fully unrolled, ptxas
// spilled).

constexpr int SLAB = 256;
constexpr int QUARTER = SLAB / 4 + 4;     // floats a padded quarter of a staged row
constexpr int SROW = 4 * QUARTER;         // floats a staged row

constexpr int slab_smem_bytes() {
    return (FQ + 2 * FKV) * SROW * static_cast<int>(sizeof(float));
}

__global__ void __launch_bounds__(F32_THREADS)
flash_slab_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ out, int H, int Hkv, int Sq,
                  int Skv, int D, float scale, float softcap, int causal) {
    constexpr int NV = SLAB / 4;      // columns of a chunk or a slab a thread holds
    extern __shared__ __align__(16) float slab_smem[];
    float* Qs = slab_smem;                      // FQ staged rows
    float* Ks = Qs + FQ * SROW;                 // FKV staged rows
    float* Vs = Ks + FKV * SROW;                // FKV staged rows

    const int tid = threadIdx.x;
    const int sub = tid & 3;
    const int q0 = (gridDim.x - 1 - blockIdx.x) * FQ;
    const int row = q0 + (tid >> 2);
    const int bh = blockIdx.y;
    const int c0 = blockIdx.z * SLAB;                 // this CTA's output columns
    const int kvh = (bh / H) * Hkv + (bh % H) / (H / Hkv);
    const float* qb = q + static_cast<size_t>(bh) * Sq * D;
    const float* kb = k + static_cast<size_t>(kvh) * Skv * D;
    const float* vb = v + static_cast<size_t>(kvh) * Skv * D;
    const int n_chunks = (D + SLAB - 1) / SLAB;
    const int mine = sub * QUARTER;                   // this thread's quarter of a staged row

    float acc[NV];
#pragma unroll
    for (int i = 0; i < NV; ++i) acc[i] = 0.f;
    float m = NEG, l = 0.f;
    int n_tiles = (Skv + FKV - 1) / FKV;
    if (causal) n_tiles = min(n_tiles, (min(q0 + FQ, Sq) - 1) / FKV + 1);

    // 32 rows x SLAB columns of t (n rows) from row r0 and column d0 into
    // dst as staged rows, zeros past n or D
    auto stage = [&](float* dst, const float* t, int n, int r0, int d0) {
#pragma unroll 4
        for (int it = 0; it < (32 * SLAB / 4) / F32_THREADS; ++it) {
            const int c = tid + it * F32_THREADS;
            const int r = c / (SLAB / 4);
            const int col = (c % (SLAB / 4)) * 4;
            float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
            if (r0 + r < n && d0 + col < D) {
                x = *reinterpret_cast<const float4*>(t + static_cast<size_t>(r0 + r) * D + d0 + col);
            }
            *reinterpret_cast<float4*>(dst + r * SROW + (col / NV) * QUARTER + col % NV) = x;
        }
    };
    static_assert(FQ == 32 && FKV == 32, "stage copies 32 rows");

    for (int t = 0; t < n_tiles; ++t) {
        const int kv0 = t * FKV;
        float s[FKV];
#pragma unroll
        for (int c = 0; c < FKV; ++c) s[c] = 0.f;
        for (int ch = 0; ch < n_chunks; ++ch) {
            const int d0 = ch * SLAB;
            __syncthreads();          // the previous chunk (or V tile) is consumed
            stage(Qs, qb, Sq, q0, d0);
            stage(Ks, kb, Skv, kv0, d0);
            if (ch == n_chunks - 1) stage(Vs, vb, Skv, kv0, c0);
            __syncthreads();
            float qr[NV];
            const float* qrow = Qs + (tid >> 2) * SROW + mine;
#pragma unroll
            for (int i = 0; i < NV; i += 4) {
                const float4 x = *reinterpret_cast<const float4*>(qrow + i);
                qr[i] = x.x, qr[i + 1] = x.y, qr[i + 2] = x.z, qr[i + 3] = x.w;
            }
#pragma unroll
            for (int c = 0; c < FKV; ++c) {
                const float* krow = Ks + c * SROW + mine;
                float part = 0.f;
#pragma unroll
                for (int i = 0; i < NV; i += 4) {
                    const float4 x = *reinterpret_cast<const float4*>(krow + i);
                    part = fmaf(qr[i], x.x, part);
                    part = fmaf(qr[i + 1], x.y, part);
                    part = fmaf(qr[i + 2], x.z, part);
                    part = fmaf(qr[i + 3], x.w, part);
                }
                s[c] += part;
            }
        }
        float mx = NEG;
#pragma unroll
        for (int c = 0; c < FKV; ++c) {
            float dot = s[c];
            dot += __shfl_xor_sync(0xffffffffu, dot, 1);
            dot += __shfl_xor_sync(0xffffffffu, dot, 2);
            const int col = kv0 + c;
            s[c] = score(dot, scale, softcap, col >= Skv || (causal && col > row));
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
            const float* vrow = Vs + c * SROW + mine;
#pragma unroll
            for (int i = 0; i < NV; i += 4) {
                const float4 x = *reinterpret_cast<const float4*>(vrow + i);
                acc[i] = fmaf(s[c], x.x, acc[i]);
                acc[i + 1] = fmaf(s[c], x.y, acc[i + 1]);
                acc[i + 2] = fmaf(s[c], x.z, acc[i + 2]);
                acc[i + 3] = fmaf(s[c], x.w, acc[i + 3]);
            }
        }
    }

    // D is a multiple of 64: a thread's quarter of the slab is in D or not
    if (row < Sq && c0 + sub * NV < D) {
        const float d = fmaxf(l, 1e-30f);
        float* orow = out + (static_cast<size_t>(bh) * Sq + row) * D + c0 + sub * NV;
#pragma unroll
        for (int i = 0; i < NV; i += 4) {
            *reinterpret_cast<float4*>(orow + i) =
                make_float4(__fdiv_rn(acc[i], d), __fdiv_rn(acc[i + 1], d),
                            __fdiv_rn(acc[i + 2], d), __fdiv_rn(acc[i + 3], d));
        }
    }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int B, int H,
                   int Hkv, int Sq, int Skv, int bf16, float scale, float softcap, int causal,
                   cudaStream_t stream) {
    if (bf16) {
        CUtensorMap qm, km, vm;
        constexpr int BN = Tiles<D>::BN;
        if (!tensor_map(&qm, q, D, Sq, B * H, BQ) || !tensor_map(&km, k, D, Skv, B * Hkv, BN) ||
            !tensor_map(&vm, v, D, Skv, B * Hkv, BN)) {
            return cudaErrorInvalidValue;
        }
        const int smem = Tiles<D>::SMEM;
        const cudaError_t err = cudaFuncSetAttribute(
            flash_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (err != cudaSuccess) return err;
        const dim3 grid(B * H, (Sq + BQ - 1) / BQ);
        flash_bf16_kernel<D><<<grid, BF16_THREADS, smem, stream>>>(
            qm, km, vm, static_cast<__nv_bfloat16*>(out), H, Hkv, Sq, Skv, scale, softcap, causal);
    } else {
        constexpr int smem = f32_smem_bytes<D>();
        const cudaError_t err = cudaFuncSetAttribute(
            flash_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (err != cudaSuccess) return err;
        dim3 grid((Sq + FQ - 1) / FQ, B * H);
        flash_f32_kernel<D><<<grid, F32_THREADS, smem, stream>>>(
            static_cast<const float*>(q), static_cast<const float*>(k),
            static_cast<const float*>(v), static_cast<float*>(out), H, Hkv, Sq, Skv, scale,
            softcap, causal);
    }
    return cudaGetLastError();
}

cudaError_t launch_slab(const void* q, const void* k, const void* v, void* out, int B, int H,
                        int Hkv, int Sq, int Skv, int D, float scale, float softcap, int causal,
                        cudaStream_t stream) {
    constexpr int smem = slab_smem_bytes();
    const cudaError_t err = cudaFuncSetAttribute(
        flash_slab_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((Sq + FQ - 1) / FQ, B * H, (D + SLAB - 1) / SLAB);
    flash_slab_kernel<<<grid, F32_THREADS, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<float*>(out), H, Hkv, Sq, Skv, D, scale, softcap, causal);
    return cudaGetLastError();
}

}  // namespace

// q (B,H,Sq,D), k/v (B,Hkv,Skv,D), out (B,H,Sq,D): contiguous device pointers,
// 16-byte aligned, all f32 (bf16 = 0) or all bf16 (bf16 = 1). D in
// {16, 32, 64, 128, 256}, or in f32 a multiple of 64 above 256 (the slab
// kernel); H a multiple of Hkv; Sq / 128 <= 65535 in bf16, B * H <= 65535
// on the slab kernel. Returns the launch's cudaError_t.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* out,
                                      int B, int H, int Hkv, int Sq, int Skv, int D, int bf16,
                                      float scale, float softcap, int causal, void* stream) {
    if (B <= 0 || H <= 0 || Sq <= 0) return static_cast<int>(cudaSuccess);
    if (Hkv <= 0 || H % Hkv != 0 || Skv <= 0) return static_cast<int>(cudaErrorInvalidValue);
    if (bf16 && (Sq + BQ - 1) / BQ > 65535) return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (D) {
        case 16: return static_cast<int>(launch<16>(q, k, v, out, B, H, Hkv, Sq, Skv, bf16, scale, softcap, causal, s));
        case 32: return static_cast<int>(launch<32>(q, k, v, out, B, H, Hkv, Sq, Skv, bf16, scale, softcap, causal, s));
        case 64: return static_cast<int>(launch<64>(q, k, v, out, B, H, Hkv, Sq, Skv, bf16, scale, softcap, causal, s));
        case 128: return static_cast<int>(launch<128>(q, k, v, out, B, H, Hkv, Sq, Skv, bf16, scale, softcap, causal, s));
        case 256: return static_cast<int>(launch<256>(q, k, v, out, B, H, Hkv, Sq, Skv, bf16, scale, softcap, causal, s));
        default:
            if (bf16 || D <= 256 || D % 64 != 0 || B * H > 65535) {
                return static_cast<int>(cudaErrorInvalidValue);
            }
            return static_cast<int>(launch_slab(q, k, v, out, B, H, Hkv, Sq, Skv, D, scale, softcap, causal, s));
    }
}

// The runtime's text for an error code returned by the launch entry.
extern "C" const char* flash_attention_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}
