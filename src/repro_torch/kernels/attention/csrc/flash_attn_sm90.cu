// Flash-attention forward for Hopper (sm_90a), bf16: TMA loads, wgmma on the
// tensor cores, online softmax in registers.  CUDA C++ with a plain C entry.
//
// Replaces the TPU kernel `src/repro/kernels/attention/kernel.py`:
// `flash_attention_bhtd` (pl.pallas_call at :124, body `_attn_kernel` :26).
// Same function: causal / sliding-window GQA attention with an online softmax
// whose running max, denominator and accumulator are f32, sm_scale =
// 1/sqrt(hd), kv tiles wholly in the future or wholly outside the window are
// skipped, rows that see no key output 0 (denominator clamped to 1e-30), and
// the output is bf16 like q.  The f32 route is `flash_attn.cu`.
//
// Bound on an H100 SXM.  At the llama3.2-3b prefill shape (B=4, T=S=1024,
// H=24, KV=8, hd=128, causal) the work is 4*hd*B*H*T(T+1)/2 = 25.8 GFLOP,
// 26 us at the 989 TFLOP/s bf16 tensor-core peak; q, k, v read once and o
// written once are 67 MB, 20 us at 3.35 TB/s.  The tensor cores bound it.
//
// Design.
// - Work item: 128 query rows of one (head, batch) and the tiles of BK keys
//   (128; 64 at hd 192 and 256, see Tile) that its rows can see.  The grid is persistent, one block per SM;
//   block c takes items c, c + gridDim.x, ..., numbered so that under
//   causal masking the q blocks that see the most keys come first and the
//   short ones fill the tail.
// - A block is three warpgroups.  Two consumers own 64 rows each of the
//   item; the third is the producer, whose one thread issues TMA loads and
//   whose registers go to the consumers (setmaxnreg 24 / 240).
// - The producer loads each q tile into its buffer and the k and v tiles
//   into a ring of stages (three; two at hd 256), each under a "full" mbarrier that counts
//   the tile's bytes; it refills a buffer or stage once all eight consumer
//   warps have arrived on its "empty" mbarrier.  The ring runs on across
//   items, so the next item's k/v loads overlap this item's tail.
// - q, k, v are 4-D tensor maps (hd, heads, seq, batch) over their own
//   strides, so the model's transposed (B,T,H,hd) views are read without a
//   copy, GQA reads kv head h/(H/KV), and rows past T or S are zero-filled
//   by TMA, never read from the next head.
// - Tiles sit in shared memory as TMA writes them: rows of hd bf16 cut into
//   boxes of 64 columns (128 B, 128-B swizzle; hd 192 is three boxes) or,
//   for hd 32, one box of 64 B (64-B swizzle).  The wgmma descriptors name the same swizzle.
// - S = Q K^T: wgmma m64n{BK}k16, both operands K-major in shared memory,
//   f32 accumulator in registers.
// - Softmax on the accumulator fragment: each thread holds two rows; row max
//   and sum by shuffles within the quad that shares a row; exp2 with the
//   scale folded into one FMA.  Masks (causal, window, keys at or past S,
//   which TMA fills with zeros that would score 0) are applied only on
//   tiles that straddle a boundary; a warpgroup skips the tiles none of its
//   rows can see.
// - O += P V: P rounded to bf16 in registers is the A operand of the
//   register-sourced wgmma m64n{hd}k16 (above hd 128, two of them, over
//   columns 0-127 and the rest); V is the B operand, MN-major in shared
//   memory (transpose bit set).  The plain version rounds its
//   probabilities to bf16 too (ref.py, `.to(v.dtype)`).
// - Within a warpgroup the scores of tile i are issued beside the P V of
//   tile i - 1, and the softmax of tile i runs while that P V finishes.
//   Registers a product reads are written only while no product is in
//   flight (else ptxas serialises the wgmmas).
// - Epilogue: 1/l, narrow to bf16, masked 4-byte stores into (B,T,H,hd).
// What it leaves for later: q in registers, which would halve the shared
// memory the scores read; an order of turns between the two consumers on
// the tensor cores (a ping-pong on named barriers measured slower, PERF.md);
// an epilogue through shared memory and a TMA store; k/v tiles multicast
// across a cluster; a dynamic order of items (the static round robin leaves
// long causal sequences unbalanced).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <cstdio>

namespace {

constexpr int BQ = 128;                     // query rows per work item
// k/v ring depth (but 2 at hd 256, see Tile) and q buffers: 3 and 1 fill
// shared memory at hd 128 (224 KB), and measured faster there than 2 and 2
// (PERF.md)
constexpr int STAGES = 3;
constexpr int QBUF = 1;
constexpr int NCONSUMER = 256;              // two consumer warpgroups
constexpr int NTHREADS = NCONSUMER + 128;   // + the producer warpgroup
constexpr float LOG2E = 1.4426950408889634f;

// Shared memory of a block: the q buffers, a ring of k tiles and of v tiles,
// and the mbarriers (full and empty per q buffer; full k, full v and empty
// per stage).  Keys per k/v tile and ring depth by head dim: 128 keys in
// STAGES stages up to hd 128; 64 keys at hd 192 (STAGES stages) and 256 (2
// stages), where 128-key tiles would need 337 and 449 KB of the 227 KB a
// block may have, and a 128-key score fragment beside hd 256's accumulator
// (128 registers a thread) would spill.  Both come to 193 KB.
template <int HD>
struct Tile {
  static constexpr int BK = HD >= 192 ? 64 : 128;      // keys per k/v tile
  static constexpr int RING = HD == 256 ? 2 : STAGES;  // k/v ring depth
  static constexpr int BOXW = HD < 64 ? HD : 64;      // columns per TMA box (one swizzle span)
  static constexpr int ROWB = BOXW * 2;               // bytes of a box row: 64 or 128
  static constexpr int NBOX = HD / BOXW;
  static constexpr int LAYOUT = ROWB == 128 ? 1 : 2;  // descriptor layout: 1 = 128-B swizzle, 2 = 64-B
  static constexpr int Q_BYTES = BQ * HD * 2;
  static constexpr int KV_BYTES = BK * HD * 2;
  static constexpr int SMEM = 1024 + QBUF * Q_BYTES + 2 * RING * KV_BYTES + 8 * (2 * QBUF + 3 * RING);
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait until the barrier has completed the phase of parity `parity`.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0,
                                            int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-B units), layout (swizzle) type; base offset 0, so every
// tile starts on a 1024-B boundary.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo, uint32_t layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)layout << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() { asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory"); }

// Keep the compiler from moving reads or writes of wgmma registers across
// the fence / wait instructions.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float ex2(float x) {  // 2^x; 2^-inf = 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ bool visible(int qpos, int kpos, int S, int causal, int window) {
  return kpos < S && (!causal || kpos <= qpos) && (window <= 0 || qpos - kpos < window);
}

// d(64x64, f32) = A(64x16) * B(64x16)^T, A and B K-major in smem; d is only
// written, so nothing that defined it before counts as an input.
__device__ __forceinline__ void wgmma_ss_zero(float (&d)[32], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(0));
}

// d(64x64, f32) += A(64x16) * B(64x16)^T, A and B K-major in smem.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// d(64x128, f32) = A(64x16) * B(128x16)^T, A and B K-major in smem; d is only
// written, so nothing that defined it before counts as an input.
__device__ __forceinline__ void wgmma_ss_zero(float (&d)[64], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31]),
        "=f"(d[32]), "=f"(d[33]), "=f"(d[34]), "=f"(d[35]), "=f"(d[36]), "=f"(d[37]), "=f"(d[38]), "=f"(d[39]),
        "=f"(d[40]), "=f"(d[41]), "=f"(d[42]), "=f"(d[43]), "=f"(d[44]), "=f"(d[45]), "=f"(d[46]), "=f"(d[47]),
        "=f"(d[48]), "=f"(d[49]), "=f"(d[50]), "=f"(d[51]), "=f"(d[52]), "=f"(d[53]), "=f"(d[54]), "=f"(d[55]),
        "=f"(d[56]), "=f"(d[57]), "=f"(d[58]), "=f"(d[59]), "=f"(d[60]), "=f"(d[61]), "=f"(d[62]), "=f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(0));
}

// d(64x128, f32) += A(64x16) * B(128x16)^T, A and B K-major in smem.
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// d(64x32, f32) += A(64x16, bf16 in registers) * B(16x32), B MN-major in smem.
__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d(64x64, f32) += A(64x16, bf16 in registers) * B(16x64), B MN-major in smem.
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d(64x128, f32) += A(64x16, bf16 in registers) * B(16x128), B MN-major in smem.
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// The columns [OFF, OFF + N/2) of an accumulator fragment: the fragment of
// columns [2 OFF, 2 OFF + N) of the tile, since each 8 columns are 4
// registers a thread in column order.
template <int OFF, int N, int M>
__device__ __forceinline__ float (&columns(float (&a)[M]))[N] {
  static_assert(OFF + N <= M, "columns past the fragment");
  return *reinterpret_cast<float(*)[N]>(&a[OFF]);
}

// What one consumer warpgroup computes on one k/v tile of BK keys.  S and O
// are accumulator fragments: thread (warp w, lane) of the warpgroup holds
// rows 16 w + lane / 4 (+ 8) and columns 8 j + 2 (lane % 4) (+ 1).
template <int HD>
struct Consumer {
  using L = Tile<HD>;
  static constexpr int BK = L::BK;
  uint32_t sQ;  // this warpgroup's 64 q rows
  int row0, col0, S_len, causal, window;
  float scale_log2;

  // S = Q K^T over the tile at `k_tile`, both K-major: k-steps of 16
  // columns walk 32 B at a time through each 64-column box.
  __device__ __forceinline__ void qk(float (&sc)[BK / 2], uint32_t k_tile) const {
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const int box = kk * 16 / L::BOXW;
      const uint32_t off = (kk * 16 % L::BOXW) * 2;
      const uint64_t da = make_desc(sQ + box * BQ * L::ROWB + off, 16, 8 * L::ROWB, L::LAYOUT);
      const uint64_t db = make_desc(k_tile + box * BK * L::ROWB + off, 16, 8 * L::ROWB, L::LAYOUT);
      if (kk == 0)
        wgmma_ss_zero(sc, da, db);
      else
        wgmma_ss(sc, da, db);
    }
  }

  // O += P V over the tile at `v_tile`, V MN-major: k-steps of 16 keys
  // (rows); the next 64-column box of V is BK rows on (LBO), the next
  // 8-row group 8 rows on (SBO).  Above hd 128 a k-step is two products,
  // columns 0-127 (boxes 0 and 1) and the rest (box 2, or boxes 2 and 3),
  // each into its own columns of the accumulator.
  __device__ __forceinline__ void pv(float (&acc)[HD / 2], const uint32_t (&p)[BK / 4], uint32_t v_tile) const {
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t a[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3]};
      const uint32_t rows = v_tile + kk * 16 * L::ROWB;
      if constexpr (HD <= 128) {
        wgmma_rs(acc, a, make_desc(rows, BK * L::ROWB, 8 * L::ROWB, L::LAYOUT));
      } else {
        wgmma_rs(columns<0, 64>(acc), a, make_desc(rows, BK * L::ROWB, 8 * L::ROWB, L::LAYOUT));
        wgmma_rs(columns<64, HD / 2 - 64>(acc), a,
                 make_desc(rows + 2 * BK * L::ROWB, BK * L::ROWB, 8 * L::ROWB, L::LAYOUT));
      }
    }
  }

  __device__ __forceinline__ static void rescale(float (&acc)[HD / 2], const float (&alpha)[2]) {
#pragma unroll
    for (int j = 0; j < HD / 2; ++j) acc[j] *= alpha[(j / 2) % 2];
  }

  // Online softmax of the scores of keys k0.. (raw, unscaled), in place:
  // masks if asked, updates the running max m (raw) and denominator l (this
  // thread's share), leaves the probabilities in sc and returns the rescale
  // alpha of the accumulator.
  __device__ __forceinline__ void softmax(float (&sc)[BK / 2], int k0, bool need_mask, float (&m)[2],
                                          float (&l)[2], float (&alpha)[2]) const {
    if (need_mask) {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (!visible(row0 + 8 * (e / 2), k0 + 8 * j + col0 + (e % 2), S_len, causal, window))
            sc[4 * j + e] = -INFINITY;
    }
    float ms[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = m[r];
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * r], sc[4 * j + 2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      // a row that has seen no key yet keeps m = -inf, its p are 0, and its
      // accumulator and denominator (both 0) take alpha = 0
      ms[r] = mx == -INFINITY ? 0.f : mx * scale_log2;
      alpha[r] = m[r] == -INFINITY ? 0.f : ex2(m[r] * scale_log2 - ms[r]);
      m[r] = mx;
    }
    float rowsum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        sc[4 * j + 2 * r] = ex2(fmaf(sc[4 * j + 2 * r], scale_log2, -ms[r]));
        sc[4 * j + 2 * r + 1] = ex2(fmaf(sc[4 * j + 2 * r + 1], scale_log2, -ms[r]));
        rowsum[r] += sc[4 * j + 2 * r] + sc[4 * j + 2 * r + 1];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rowsum[r];
  }

  // P in bf16 pairs, the A fragment of the P V product: p[2 j + r] = row r,
  // columns 8 j + col0 + {0, 1}.
  __device__ __forceinline__ static void pack(const float (&sc)[BK / 2], uint32_t (&p)[BK / 4]) {
#pragma unroll
    for (int j = 0; j < BK / 4; ++j) p[j] = pack_bf16(sc[2 * j], sc[2 * j + 1]);
  }
};

// One work item: 128 query rows of one (head, batch), and the kv tiles
// [kt_begin, kt_begin + n_tiles) that hold a visible key for one of them.
// Items are numbered so that, under causal masking, the q blocks that see
// the most keys come first.
struct Item {
  int h, b, q0, kt_begin, n_tiles;

  __device__ __forceinline__ Item(int k, int H, int B, int nq, int T_len, int S_len, int causal, int window,
                                  int BK) {
    const int bh = k % (H * B), rank = k / (H * B);
    h = bh % H;
    b = bh / H;
    q0 = (causal ? nq - 1 - rank : rank) * BQ;
    const int q_last = min(q0 + BQ, T_len) - 1;
    int kt_end = (S_len + BK - 1) / BK;
    if (causal) kt_end = min(kt_end, q_last / BK + 1);
    kt_begin = window > 0 && q0 - window + 1 > 0 ? (q0 - window + 1) / BK : 0;
    n_tiles = max(kt_end - kt_begin, 0);
  }
};

// Persistent: block c takes items c, c + gridDim.x, ...; the k/v ring and
// the two q buffers run on across items, so the producer loads the next
// item while the consumers finish this one.
template <int HD>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_attn_sm90_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ o,
                       int64_t o_b, int64_t o_t, int64_t o_h, int H, int B, int T_len, int S_len, int group,
                       int causal, int window, float scale_log2) {
  using L = Tile<HD>;
  constexpr int BK = L::BK, RING = L::RING;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;  // buffer j at sQ + j * Q_BYTES
  const uint32_t sK = sQ + QBUF * L::Q_BYTES;        // stage s at sK + s * KV_BYTES
  const uint32_t sV = sK + RING * L::KV_BYTES;     // stage s at sV + s * KV_BYTES
  const uint32_t bar_q = sV + RING * L::KV_BYTES;  // buffer j at + 8 j: q tile landed
  const uint32_t bar_q_empty = bar_q + 8 * QBUF;     // every consumer warp is done with the q buffer
  const uint32_t bar_k = bar_q_empty + 8 * QBUF;     // stage s at + 8 s: k tile landed
  const uint32_t bar_v = bar_k + 8 * RING;         // v tile landed
  const uint32_t bar_empty = bar_v + 8 * RING;     // every consumer warp is done with the stage

  const int nq = (T_len + BQ - 1) / BQ;
  const int n_items = nq * H * B;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int j = 0; j < QBUF; ++j) {
      mbar_init(bar_q + 8 * j, 1);
      mbar_init(bar_q_empty + 8 * j, NCONSUMER / 32);  // lane 0 of each consumer warp
    }
    for (int s = 0; s < RING; ++s) {
      mbar_init(bar_k + 8 * s, 1);
      mbar_init(bar_v + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, NCONSUMER / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= NCONSUMER) {
    // producer warpgroup: gives its registers to the consumers; one thread
    // issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == NCONSUMER) {
      int g = 0;  // k/v tiles loaded so far by this block
      for (int k = blockIdx.x, it = 0; k < n_items; k += gridDim.x, ++it) {
        const Item w(k, H, B, nq, T_len, S_len, causal, window, BK);
        const int j = it % QBUF;
        if (it >= QBUF) mbar_wait(bar_q_empty + 8 * j, ((it / QBUF) - 1) & 1);
        mbar_expect_tx(bar_q + 8 * j, L::Q_BYTES);
        for (int c = 0; c < L::NBOX; ++c)
          tma_load_4d(sQ + j * L::Q_BYTES + c * BQ * L::ROWB, &tm_q, bar_q + 8 * j, c * L::BOXW, w.h, w.q0, w.b);
        const int kvh = w.h / group;
        for (int i = 0; i < w.n_tiles; ++i, ++g) {
          const int s = g % RING;
          if (g >= RING) mbar_wait(bar_empty + 8 * s, ((g / RING) - 1) & 1);
          const int k0 = (w.kt_begin + i) * BK;
          mbar_expect_tx(bar_k + 8 * s, L::KV_BYTES);
          for (int c = 0; c < L::NBOX; ++c)
            tma_load_4d(sK + s * L::KV_BYTES + c * BK * L::ROWB, &tm_k, bar_k + 8 * s, c * L::BOXW, kvh, k0, w.b);
          mbar_expect_tx(bar_v + 8 * s, L::KV_BYTES);
          for (int c = 0; c < L::NBOX; ++c)
            tma_load_4d(sV + s * L::KV_BYTES + c * BK * L::ROWB, &tm_v, bar_v + 8 * s, c * L::BOXW, kvh, k0, w.b);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int wg = tid / 128;
    const int warp = (tid % 128) / 32;
    const int lane = tid % 32;
    auto parity = [](int n, int depth) { return (uint32_t)((n / depth) & 1); };
    auto arrive = [&](uint32_t bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };
    int g = 0;  // k/v tiles consumed so far by this block
    for (int k = blockIdx.x, it = 0; k < n_items; k += gridDim.x, ++it) {
      const Item w(k, H, B, nq, T_len, S_len, causal, window, BK);
      const int j = it % QBUF;
      // warpgroup wg owns rows r_lo .. r_hi (at most 64) of the item
      const int r_lo = w.q0 + 64 * wg;
      const int r_hi = min(r_lo + 63, T_len - 1);
      const Consumer<HD> c{sQ + j * L::Q_BYTES + 64 * wg * L::ROWB, r_lo + 16 * warp + lane / 4,
                                       2 * (lane % 4), S_len, causal, window, scale_log2};
      // this warpgroup's own tiles [a, e) of the item's; it waits for the
      // others to land and releases them untouched
      int a = 0, e = 0;
      if (r_lo <= r_hi) {
        const int kt_end = w.kt_begin + w.n_tiles;
        const int te = causal ? min(kt_end, r_hi / BK + 1) : kt_end;
        const int tb = window > 0 && r_lo - window + 1 > 0 ? max(w.kt_begin, (r_lo - window + 1) / BK) : w.kt_begin;
        a = min(tb - w.kt_begin, w.n_tiles);
        e = max(te - w.kt_begin, a);
      }
      auto need_mask = [&](int k0) {
        return (causal && k0 + BK - 1 > r_lo) || (window > 0 && r_hi - k0 >= window) || k0 + BK > S_len;
      };
      auto k_tile = [&](int i) { return sK + ((g + i) % RING) * L::KV_BYTES; };
      auto v_tile = [&](int i) { return sV + ((g + i) % RING) * L::KV_BYTES; };
      auto wait_k = [&](int i) { mbar_wait(bar_k + 8 * ((g + i) % RING), parity(g + i, RING)); };
      auto wait_v = [&](int i) { mbar_wait(bar_v + 8 * ((g + i) % RING), parity(g + i, RING)); };
      auto release = [&](int i) { arrive(bar_empty + 8 * ((g + i) % RING)); };

      float acc[HD / 2];
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
      float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, alpha[2];
      float sc[BK / 2];
      uint32_t p[BK / 4];

      mbar_wait(bar_q + 8 * j, parity(it, QBUF));
      for (int i = 0; i < a; ++i) {
        wait_v(i);
        release(i);
      }
      if (a < e) {
        // first tile: scores and softmax (the accumulator is still 0)
        wait_k(a);
        wgmma_fence();
        c.qk(sc, k_tile(a));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sc);
        c.softmax(sc, (w.kt_begin + a) * BK, need_mask((w.kt_begin + a) * BK), m, l, alpha);
        c.pack(sc, p);
        // then each tile's scores run on the tensor cores beside the
        // previous tile's P V, and its softmax while that P V finishes;
        // registers that a product reads are written only while no product
        // is in flight
        for (int i = a + 1; i < e; ++i) {
          const int k0 = (w.kt_begin + i) * BK;
          wait_k(i);
          wait_v(i - 1);
          fence_regs(acc);
          fence_regs(p);
          wgmma_fence();
          c.qk(sc, k_tile(i));
          wgmma_commit();
          c.pv(acc, p, v_tile(i - 1));
          wgmma_commit();
          wgmma_wait<1>();
          fence_regs(sc);
          c.softmax(sc, k0, need_mask(k0), m, l, alpha);
          wgmma_wait<0>();
          fence_regs(acc);
          fence_regs(p);
          release(i - 1);
          c.rescale(acc, alpha);
          c.pack(sc, p);
        }
        wait_v(e - 1);
        fence_regs(acc);
        fence_regs(p);
        wgmma_fence();
        c.pv(acc, p, v_tile(e - 1));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
        release(e - 1);
      }
      for (int i = e; i < w.n_tiles; ++i) {
        wait_v(i);
        release(i);
      }
      arrive(bar_q_empty + 8 * j);
      g += w.n_tiles;

      // epilogue: the denominator is spread over the quad that shares a row
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float lr = l[r];
        lr += __shfl_xor_sync(0xffffffffu, lr, 1);
        lr += __shfl_xor_sync(0xffffffffu, lr, 2);
        const int row = c.row0 + 8 * r;
        if (row >= T_len) continue;
        const float inv = 1.f / fmaxf(lr, 1e-30f);
        __nv_bfloat16* orow = o + (int64_t)w.b * o_b + (int64_t)row * o_t + (int64_t)w.h * o_h + c.col0;
#pragma unroll
        for (int jj = 0; jj < HD / 8; ++jj)
          *reinterpret_cast<__nv_bfloat162*>(orow + 8 * jj) =
              __floats2bfloat162_rn(acc[4 * jj + 2 * r] * inv, acc[4 * jj + 2 * r + 1] * inv);
      }
    }
  }
}

// Error codes of the C entry beyond cudaError_t.
constexpr int ERR_NO_ENCODE = 200000;  // cuTensorMapEncodeTiled is not available
constexpr int ERR_ENCODE = 100000;     // + the CUresult of a refused tensor map

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime's entry-point
// table, so the library links against the CUDA runtime only.
EncodeTiledFn encode_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A (hd, heads, seq, batch) bf16 tensor map; strides in bytes of heads,
// seq and batch; a box of `boxw` columns by `rows` rows of one head.
int encode(EncodeTiledFn fn, CUtensorMap* map, const void* ptr, int hd, int heads, int seq, int batch,
           int64_t s_head, int64_t s_seq, int64_t s_batch, int boxw, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads, (cuuint64_t)seq, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)s_head, (cuuint64_t)s_seq, (cuuint64_t)s_batch};
  const cuuint32_t box[4] = {(cuuint32_t)boxw, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        boxw * 2 == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_ENCODE + (int)r;
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H, int KV, int T_len, int S_len,
           const int64_t* st, int causal, int window, float sm_scale, cudaStream_t stream) {
  using L = Tile<HD>;
  EncodeTiledFn fn = encode_fn();
  if (fn == nullptr) return ERR_NO_ENCODE;
  CUtensorMap tq, tk, tv;
  int err;
  // st in elements: q (b, t, h), k (b, s, h), v (b, s, h), o (b, t, h)
  if ((err = encode(fn, &tq, q, HD, H, T_len, B, 2 * st[2], 2 * st[1], 2 * st[0], L::BOXW, BQ))) return err;
  if ((err = encode(fn, &tk, k, HD, KV, S_len, B, 2 * st[5], 2 * st[4], 2 * st[3], L::BOXW, L::BK))) return err;
  if ((err = encode(fn, &tv, v, HD, KV, S_len, B, 2 * st[8], 2 * st[7], 2 * st[6], L::BOXW, L::BK))) return err;
  auto kernel = flash_attn_sm90_kernel<HD>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
  if (e != cudaSuccess) return (int)e;
  int device = 0, n_sms = 0;
  if ((e = cudaGetDevice(&device)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&n_sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess) return (int)e;
  const int n_items = (T_len + BQ - 1) / BQ * H * B;  // one block per SM, persistent
  kernel<<<min(n_sms, n_items), NTHREADS, L::SMEM, stream>>>(tq, tk, tv, static_cast<__nv_bfloat16*>(o), st[9],
                                                              st[10], st[11], H, B, T_len, S_len, H / KV, causal,
                                                              window, sm_scale * LOG2E);
  return (int)cudaGetLastError();
}

}  // namespace

// bf16 q (B,H,T,hd), k and v (B,KV,S,hd), o like q, each read through
// `strides`: 12 int64 in elements, (batch, sequence, head) of q, k, v, o.
// The head dim is contiguous; every other stride of a dim longer than 1, in
// bytes, and every base address are multiples of 16 (TMA's rule; the Python
// wrapper checks).  Launches on `stream`; returns 0, a cudaError_t, or a
// code of this file (see flash_attn_sm90_error_string).
extern "C" int flash_attn_sm90_fwd(const void* q, const void* k, const void* v, void* o, int B, int H, int KV,
                                   int T_len, int S_len, int hd, const int64_t* strides, int causal, int window,
                                   float sm_scale, void* stream) {
  if (B <= 0 || H <= 0 || KV <= 0 || H % KV || T_len <= 0 || S_len <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32: return launch<32>(q, k, v, o, B, H, KV, T_len, S_len, strides, causal, window, sm_scale, s);
    case 64: return launch<64>(q, k, v, o, B, H, KV, T_len, S_len, strides, causal, window, sm_scale, s);
    case 128: return launch<128>(q, k, v, o, B, H, KV, T_len, S_len, strides, causal, window, sm_scale, s);
    case 192: return launch<192>(q, k, v, o, B, H, KV, T_len, S_len, strides, causal, window, sm_scale, s);
    case 256: return launch<256>(q, k, v, o, B, H, KV, T_len, S_len, strides, causal, window, sm_scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* flash_attn_sm90_error_string(int code) {
  static thread_local char buf[96];
  if (code == ERR_NO_ENCODE) return "cuTensorMapEncodeTiled is not available";
  if (code >= ERR_ENCODE) {
    snprintf(buf, sizeof buf, "cuTensorMapEncodeTiled refused a tensor map (CUresult %d)", code - ERR_ENCODE);
    return buf;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
