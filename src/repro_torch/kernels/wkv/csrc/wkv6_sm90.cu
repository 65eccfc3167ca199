// RWKV-6 wkv chunked scan for Hopper (sm_90a) on the tensor cores, CUDA C++
// with a plain C entry.  The route of the wkv6 kernel for K = V = 64 and a
// chunk that is a multiple of 16 up to 64; every other shape goes to
// `wkv6.cu`.
//
// Replaces the TPU kernel `src/repro/kernels/wkv/kernel.py`: `wkv6_bhtk`
// (pl.pallas_call at :136, body `_wkv_kernel` :26).  Same function, per
// (batch b, head h), with a K x V f32 state S carried over the sequence.
// Inside a chunk of C tokens, with w clamped to >= 1e-20 and P(a, b] the
// product of w over the positions a < l <= b of the chunk (the Pallas
// kernel's exp(li_b - li_a), its decays in log space):
//
//     y_t  = (r_t P[0, t)) S  +  sum_{tau < t} A[t][tau] v_tau  +  (sum_k r_t u k_t) v_t
//     A[t][tau] = sum_k r_t[k] k_tau[k] P(tau, t)[k]
//     S'   = diag(P[0, C)) S  +  sum_tau (k_tau P(tau, C)) v_tau^T
//
// Scores without overflow: the Pallas kernel's straddle-boundary
// factorisation (kernel.py:62-99).  Every pair tau < t straddles one
// power-of-two-aligned boundary: at level h = 1, 2, 4, ... < C, t lies in
// the second (query) half of a 2h-block and tau in its first (key) half, and
// A[t][tau] = sum_k (r_t E_h(t)) (k_tau F_h(tau)), where E_h(t) is the
// product of w from the start of t's h-block up to t, and F_h(tau) the
// product after tau to the end of its h-block: both products of decays, so
// <= 1 at any decay strength.  One C x C product per level, each pair taken
// from the level it straddles.  The kernel keeps the factors as products
// instead of exponentials: E_2h = E_h times the product over the sibling
// h-block when t is in the odd block (F likewise in the even one), and the
// sibling's product comes from a neighbouring lane (h < 8) or the thread's
// own registers (h >= 8).  So a chunk needs no log and no exp, and the last
// level leaves r P[0, t), k P(t, C) and P[0, C) behind.
//
// Precision.  Every product runs on the tensor cores, with f32
// accumulation, on TF32 operands.  One TF32 pass keeps 11 bits, too few for
// the f32 tolerances the kernel is held to, so each f32 operand x is split
// into hi = x cut to TF32 and lo = x - hi, and a product is
// lo*hi + hi*lo + hi*hi (3xTF32, about 22 bits).  bf16 r, k, v are exact in
// TF32, so a product with v as one operand is v*lo + v*hi (two passes) when
// v is bf16.
//
// Chunk.  The function does not depend on the chunk (the scan is the same
// recurrence at any blocking), so the kernel runs sub-chunks of C = 32 for a
// chunk that is a multiple of 32, and of C = 16 otherwise.
//
// Layout of the work.  A block owns one (b, h), loops over the T / C
// sub-chunks, and has eight warps.  Per sub-chunk:
//   1. its r, k, v, w were loaded by cp.async into one of two shared-memory
//      buffers while the last sub-chunk computed; the next one's copies are
//      issued;
//   2. warp w takes the channels [8w, 8w+8) (a thread: two adjacent
//      channels at positions g, g+8, ...) and walks the levels: factors, one
//      3xTF32 mma.sync m16n8k8 per needed 16 x 8 score tile, masked into the
//      partial scores of its eight channels; then r P[0,t) and k P(t,C)
//      (split into TF32 halves), P[0,C), and the u-bonus on the diagonal.
//      The partial scores go to shared memory and are summed over the warps;
//   3. the state S^T (64 x 64) lives in registers for the whole sequence, as
//      the accumulators of two wgmma m64n32k8 products: warpgroup q holds
//      the columns [32q, 32q+32) of K.  Because an accumulator holds columns
//      (2c, 2c+1) where an A operand in registers holds k-slots (c, c+4),
//      the fragments are read as A operands of y^T = S^T (r P)^T, with r P
//      stored in the matching channel order, so S never goes through shared
//      memory.  Warpgroup q sums y^T (64 x C) over its half of K and v^T A^T
//      over half of the tau steps (wgmma, v^T in registers, r P and the
//      scores from shared memory); the halves are summed through shared
//      memory.  Then S^T is scaled by P[0, C) in place and v^T (k P) is
//      accumulated onto it (wgmma).
// Four barriers per sub-chunk: loads landed; factors and partial scores
// written; scores summed; y's halves.
//
// Bound on an H100 SXM at the rwkv6-3b prefill shape (B=4, T=1024, H=40,
// K=V=64, bf16 r/k/v, f32 w, chunk 32): 152 MB moved once, 45 us at 3.35
// TB/s; the chunked form's 3.4 GFLOP (as f32 multiply-adds, no split) at
// 495/3 TFLOP/s for 3xTF32: 20 us.  So the bytes bound it.  What holds it
// above that (PERF.md): each (b, h) is a serial chain of T / C sub-chunks
// with four barriers each; 160 blocks on 132 SMs leave 28 SMs with two
// chains; and step 2 (mma.sync on mostly masked tiles, and the factors'
// arithmetic) takes about half of each sub-chunk (tools/wkv_phases.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int KD = 64;  // K = V = 64
constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr unsigned FULL = 0xffffffffu;

struct Strides {  // in elements; the last dim is contiguous
  int64_t r_b, r_t, r_h;
  int64_t k_b, k_t, k_h;
  int64_t v_b, v_t, v_h;
  int64_t w_b, w_t, w_h;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// Two adjacent elements as floats.
__device__ __forceinline__ float2 load2(const float* p) { return *reinterpret_cast<const float2*>(p); }
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// --- levels of the straddle-boundary factorisation -------------------------

__host__ __device__ constexpr int log2i(int h) { return h <= 1 ? 0 : 1 + log2i(h / 2); }

// (t, tau) straddles a boundary of level h: same 2h-block, t in its second half, tau in its first.
__host__ __device__ constexpr bool pair_at(int h, int t, int tau) {
  return t / (2 * h) == tau / (2 * h) && ((t / h) & 1) && !((tau / h) & 1);
}

// Score tiles: rows [16m, 16m+16) x columns [8n, 8n+8), n <= 2m + 1 (the
// lower triangle and the diagonal), numbered m (m + 1) + n.
__host__ __device__ constexpr int tile_index(int m, int n) { return m * (m + 1) + n; }

// Bit tile_index(m, n) of `some`: the tile holds a pair of level h; of
// `all`: every entry of the tile is one.
struct TileMasks {
  uint64_t some, all;
};
__host__ __device__ constexpr TileMasks tile_masks(int C, int h) {
  TileMasks mask{0, 0};
  for (int m = 0; m < C / 16; ++m)
    for (int n = 0; n <= 2 * m + 1; ++n) {
      int pairs = 0;
      for (int t = 16 * m; t < 16 * m + 16; ++t)
        for (int tau = 8 * n; tau < 8 * n + 8; ++tau) pairs += pair_at(h, t, tau);
      if (pairs) mask.some |= uint64_t(1) << tile_index(m, n);
      if (pairs == 128) mask.all |= uint64_t(1) << tile_index(m, n);
    }
  return mask;
}

// --- TF32 and the tensor cores ---------------------------------------------

// x = hi + lo: hi is x cut to TF32 (its top 11 significant bits), lo = x - hi
// is exact in f32 and goes in whole; the tensor core reads its top 11 bits,
// so hi + lo keeps 22 bits of x.  Two instructions.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// d += a (16x8, row) * b (8x8, col), TF32 in, f32 accumulate.
// a0 (g, c), a1 (g+8, c), a2 (g, c+4), a3 (g+8, c+4); b0 (k c, n g), b1 (k c+4, n g);
// d0 (g, 2c), d1 (g, 2c+1), d2 (g+8, 2c), d3 (g+8, 2c+1); g = lane / 4, c = lane % 4.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a * b with both split: lo*hi + hi*lo + hi*hi.
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4], const uint32_t (&al)[4],
                                     uint32_t bh0, uint32_t bh1, uint32_t bl0, uint32_t bl1) {
  mma(d, al, bh0, bh1);
  mma(d, ah, bl0, bl1);
  mma(d, ah, bh0, bh1);
}

// --- cp.async ----------------------------------------------------------------

__device__ __forceinline__ void cp16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void cp_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

// --- wgmma -------------------------------------------------------------------

// Shared-memory matrix descriptor of a K-major operand without swizzle:
// 8-row x 16-byte core matrices, `lbo` bytes apart along K and `sbo` bytes
// apart along M or N.
__device__ __forceinline__ uint64_t make_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait_all() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }
// Generic-proxy writes to shared memory, made visible to wgmma's reads.
__device__ __forceinline__ void fence_async_smem() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

// Keep the compiler from moving reads or writes of wgmma registers across
// the fence and wait instructions.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d(64xN, f32) += A(64x8, TF32 in registers) * B(8xN), B K-major in shared memory.
__device__ __forceinline__ void wgmma_tf32(float (&d)[16], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}
__device__ __forceinline__ void wgmma_tf32(float (&d)[8], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d += a * b, a split in registers, b split into two K-major shared-memory
// matrices: lo*hi + hi*lo + hi*hi; or, with a exact (bf16 v), a*lo + a*hi.
template <bool EXACT, int N>
__device__ __forceinline__ void wgmma3(float (&d)[N], const uint32_t (&ah)[4], const uint32_t (&al)[4],
                                       uint64_t bh, uint64_t bl) {
  if constexpr (!EXACT) wgmma_tf32(d, al, bh);
  wgmma_tf32(d, ah, bl);
  wgmma_tf32(d, ah, bh);
}

// --- shared memory -------------------------------------------------------------

// The products of step 3 read their B operands through wgmma descriptors:
// K-major, no swizzle, element (n, k) at byte (n / 8) * SBO + (k / 4) * 128
// + (n % 8) * 16 + (k % 4) * 4.
__host__ __device__ constexpr int core_offset(int n, int k, int sbo) {
  return (n / 8) * sbo + (k / 4) * 128 + (n % 8) * 16 + (k % 4) * 4;
}

template <typename T, int C>
struct Layout {
  static constexpr int NTILES = (C / 16) * (C / 16 + 1);  // score tiles kept
  static constexpr int PADT = 16 / sizeof(T); // 16 bytes of padding per row
  // Row strides, in elements, of the staged sub-chunk, chosen so that the
  // reads of step 2 and of the v fragments hit distinct banks.
  static constexpr int RS = KD + PADT;        // r, k, v (T)
  static constexpr int WS = KD + 4;           // w (f32)
  static constexpr int R_BYTES = C * RS * (int)sizeof(T);
  static constexpr int W_BYTES = C * WS * 4;
  static constexpr int STAGE = 3 * R_BYTES + W_BYTES;
  // B operands, TF32 halves (hi, then lo), as core matrices:
  // r P[0, t) as (n = t, k = channel), the channels of each 8 ordered
  //   0, 2, 4, 6, 1, 3, 5, 7 to match S's accumulator columns as A's k-slots;
  // k P(t, C) as (n = channel, k = t); the scores as (n = t, k = tau).
  static constexpr int RD_SBO = (KD / 4) * 128;
  static constexpr int KC_SBO = (C / 4) * 128;
  static constexpr int SA_SBO = (C / 4) * 128;
  static constexpr int RD_OFF = 2 * STAGE;
  static constexpr int KC_OFF = RD_OFF + 2 * C * KD * 4;
  static constexpr int SA_OFF = KC_OFF + 2 * C * KD * 4;
  static constexpr int DT_OFF = SA_OFF + 2 * C * C * 4;     // P[0, C) per channel
  static constexpr int SP_OFF = DT_OFF + KD * 4;            // partial scores, then y's second half
  static constexpr int SP_BYTES = NWARPS * NTILES * 32 * 16;
  static constexpr int YP_BYTES = 4 * (C / 2) * 32 * 4;
  static constexpr int BYTES = SP_OFF + (SP_BYTES > YP_BYTES ? SP_BYTES : YP_BYTES);
};

template <typename T, int C>
struct Stage {
  T* r;
  T* k;
  T* v;
  float* w;
  __device__ Stage(unsigned char* smem, int s) {
    using L = Layout<T, C>;
    unsigned char* base = smem + s * L::STAGE;
    r = reinterpret_cast<T*>(base);
    k = reinterpret_cast<T*>(base + L::R_BYTES);
    v = reinterpret_cast<T*>(base + 2 * L::R_BYTES);
    w = reinterpret_cast<float*>(base + 3 * L::R_BYTES);
  }
};

// Call f(i) for this thread's items i < N of a block-wide loop: i = tid + n * NTHREADS.
template <int N, typename F>
__device__ __forceinline__ void for_items(F f) {
#pragma unroll
  for (int n = 0; n < (N + NTHREADS - 1) / NTHREADS; ++n) {
    const int i = threadIdx.x + n * NTHREADS;
    if (N % NTHREADS == 0 || i < N) f(i);
  }
}

// Issue the cp.async copies of rows [t0, t0 + C) of r, k, v, w into stage
// `st`.  Offsets inside the sub-chunk are 32-bit (the entry checks that C
// rows of every stride fit).
template <typename T, int C>
__device__ __forceinline__ void load_chunk(const Stage<T, C>& st, const T* rb, const T* kb, const T* vb,
                                           const float* wb, const Strides& s, int t0) {
  using L = Layout<T, C>;
  constexpr int EPV = 16 / sizeof(T);        // elements per 16-byte copy
  constexpr int RV = KD / EPV;               // copies per r, k or v row
  constexpr int WV = KD / 4;                 // copies per w row
  rb += t0 * s.r_t, kb += t0 * s.k_t, vb += t0 * s.v_t, wb += t0 * s.w_t;
  const int r_t = (int)s.r_t, k_t = (int)s.k_t, v_t = (int)s.v_t, w_t = (int)s.w_t;
  for_items<C * RV>([&](int i) {
    const int t = i / RV, q = (i % RV) * EPV;
    cp16(st.r + t * L::RS + q, rb + (t * r_t + q));
    cp16(st.k + t * L::RS + q, kb + (t * k_t + q));
    cp16(st.v + t * L::RS + q, vb + (t * v_t + q));
  });
  for_items<C * WV>([&](int i) {
    const int t = i / WV, q = (i % WV) * 4;
    cp16(st.w + t * L::WS + q, wb + (t * w_t + q));
  });
}

// One level h of the scores over this thread's two channels (e = 0, 1) at
// positions p = 8j + g: factors, the 3xTF32 products of the needed tiles
// masked into `acc`, then E, F and the block products D one level up.
// `lmask` holds this lane's pair mask of levels 1, 2, 4 (bit (2 log2 h +
// n - 2m) * 4 + e); from level 8 on the mask does not depend on the lane.
template <int C, int H>
__device__ __forceinline__ void level_step(float (&E)[C / 8][2], float (&F)[C / 8][2], float (&D)[C / 8][2],
                                           const float (&rr)[C / 8][2], const float (&kk)[C / 8][2],
                                           float (&acc)[(C / 16) * (C / 16 + 1)][4], uint32_t lmask, int g) {
  constexpr int NJ = C / 8, NM = C / 16;
  constexpr TileMasks TILES = tile_masks(C, H);
  uint32_t fh[NJ][2], fl[NJ][2];
  bool q[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    q[j] = ((8 * j + g) / H) & 1;  // query side at this level
#pragma unroll
    for (int e = 0; e < 2; ++e) split(q[j] ? rr[j][e] * E[j][e] : kk[j][e] * F[j][e], fh[j][e], fl[j][e]);
  }
#pragma unroll
  for (int m = 0; m < NM; ++m) {
    // A rows are positions 16m + g (+8), B columns 8n + g; k-slots (c, c+4)
    // are this thread's channels (e = 0, 1)
    const uint32_t ah[4] = {fh[2 * m][0], fh[2 * m + 1][0], fh[2 * m][1], fh[2 * m + 1][1]};
    const uint32_t al[4] = {fl[2 * m][0], fl[2 * m + 1][0], fl[2 * m][1], fl[2 * m + 1][1]};
#pragma unroll
    for (int n = 0; n <= 2 * m + 1; ++n) {
      const int tile = tile_index(m, n);
      if (!((TILES.some >> tile) & 1)) continue;
      if ((TILES.all >> tile) & 1) {  // no other level shares the tile
        mma3(acc[tile], ah, al, fh[n][0], fh[n][1], fl[n][0], fl[n][1]);
        continue;
      }
      float tmp[4] = {0.f, 0.f, 0.f, 0.f};
      mma3(tmp, ah, al, fh[n][0], fh[n][1], fl[n][0], fl[n][1]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool keep = H >= 8 ? pair_at(H, 16 * m + 8 * (e >> 1), 8 * n + (e & 1))
                                 : (lmask >> ((2 * log2i(H) + n - 2 * m) * 4 + e)) & 1;
        if (keep) acc[tile][e] += tmp[e];
      }
    }
  }
  // the product over the sibling h-block: a neighbouring lane's below 8,
  // this thread's own block j ^ (h / 8) from 8 on (none past the chunk)
  float sib[NJ][2];
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (H < 8) sib[j][e] = __shfl_xor_sync(FULL, D[j][e], 4 * H);
      else sib[j][e] = (j ^ (H / 8)) < NJ ? D[j ^ (H / 8)][e] : 1.f;
    }
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (q[j]) E[j][e] *= sib[j][e];
      else F[j][e] *= sib[j][e];
      D[j][e] *= sib[j][e];
    }
}


template <typename T, int C>
__global__ void __launch_bounds__(NTHREADS, 2)
wkv6_sm90_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
                 const float* __restrict__ w, const float* __restrict__ u, const float* __restrict__ s0,
                 float* __restrict__ y, float* __restrict__ sT, int H, int T_len, Strides st) {
  using L = Layout<T, C>;
  constexpr bool EXACT = sizeof(T) == 2;  // bf16 r, k, v are exact in TF32
  constexpr int NT = C / 8;               // 8-wide tiles of the sub-chunk, and positions per thread
  constexpr int NM = C / 16;

  extern __shared__ __align__(128) unsigned char smem[];
  uint32_t* RDH = reinterpret_cast<uint32_t*>(smem + L::RD_OFF);
  uint32_t* RDL = RDH + C * KD;
  uint32_t* KCH = reinterpret_cast<uint32_t*>(smem + L::KC_OFF);
  uint32_t* KCL = KCH + C * KD;
  uint32_t* SAH = reinterpret_cast<uint32_t*>(smem + L::SA_OFF);
  uint32_t* SAL = SAH + C * C;
  float* DT = reinterpret_cast<float*>(smem + L::DT_OFF);
  float4* SP = reinterpret_cast<float4*>(smem + L::SP_OFF);
  float* YP = reinterpret_cast<float*>(smem + L::SP_OFF);

  const int tid = threadIdx.x, lane = tid & 31, g = lane >> 2, c = lane & 3;
  const int warp = __shfl_sync(FULL, tid >> 5, 0);  // warp-uniform, and the compiler knows it
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int k0 = 8 * warp + 2 * c;  // this thread's two channels in step 2
  const int q = warp >> 2, wq = warp & 3;  // step 3: warpgroup q (half of K), rows 16 wq + g (+8) of V

  const T* rb = r + (int64_t)b * st.r_b + (int64_t)h * st.r_h;
  const T* kbp = k + (int64_t)b * st.k_b + (int64_t)h * st.k_h;
  const T* vb = v + (int64_t)b * st.v_b + (int64_t)h * st.v_h;
  const float* wb = w + (int64_t)b * st.w_b + (int64_t)h * st.w_h;
  const int y_t = H * KD;  // y is contiguous (B, T, H, V)
  float* yb = y + (int64_t)b * T_len * y_t + (int64_t)h * KD + 16 * wq + g;
  const int nc = T_len / C;

  load_chunk(Stage<T, C>(smem, 0), rb, kbp, vb, wb, st, 0);
  cp_commit();

  for (int i = tid; i < 2 * C * C; i += NTHREADS) SAH[i] = 0u;  // tau > t stays 0; SAL follows SAH
  const float2 uu = *reinterpret_cast<const float2*>(u + (int64_t)h * KD + k0);
  uint32_t lmask = 0;  // pair masks of levels 1, 2, 4 in the diagonal tiles
#pragma unroll
  for (int l = 0; l < 3; ++l)
#pragma unroll
    for (int d = 0; d < 2; ++d)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (pair_at(1 << l, g + 8 * (e >> 1), 8 * d + 2 * c + (e & 1))) lmask |= 1u << ((2 * l + d) * 4 + e);

  // S^T (64 x 64) as the accumulators of two m64n32 products: warpgroup q
  // holds columns 32q + 8i + 2c (+1) of rows 16 wq + g (+8), in S[4i + e]
  float S[16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = 16 * wq + g + 8 * (e >> 1), col = 32 * q + 8 * i + 2 * c + (e & 1);
      S[4 * i + e] = s0 ? s0[((int64_t)bh * KD + col) * KD + row] : 0.f;
    }

  for (int ci = 0; ci < nc; ++ci) {
    cp_wait_all();
    __syncthreads();  // sub-chunk ci has landed; the last one's readers are done
    if (ci + 1 < nc) load_chunk(Stage<T, C>(smem, (ci + 1) & 1), rb, kbp, vb, wb, st, (ci + 1) * C);
    cp_commit();
    const Stage<T, C> cur(smem, ci & 1);
    const int t0 = ci * C;

    // 2. the levels over channels k0, k0 + 1 at positions 8j + g
    {
      float rr[NT][2], kk[NT][2], E[NT][2], F[NT][2], D[NT][2], bonus[NT];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int p = 8 * j + g;
        const float2 r2 = load2(cur.r + p * L::RS + k0), k2 = load2(cur.k + p * L::RS + k0);
        const float2 w2 = load2(cur.w + p * L::WS + k0);
        rr[j][0] = r2.x, rr[j][1] = r2.y, kk[j][0] = k2.x, kk[j][1] = k2.y;
        D[j][0] = fmaxf(w2.x, 1e-20f), D[j][1] = fmaxf(w2.y, 1e-20f);
        E[j][0] = E[j][1] = F[j][0] = F[j][1] = 1.f;
        bonus[j] = r2.x * uu.x * k2.x + r2.y * uu.y * k2.y;
        bonus[j] += __shfl_xor_sync(FULL, bonus[j], 1);
        bonus[j] += __shfl_xor_sync(FULL, bonus[j], 2);
      }
      float acc[L::NTILES][4];
#pragma unroll
      for (int i = 0; i < L::NTILES; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
      level_step<C, 1>(E, F, D, rr, kk, acc, lmask, g);
      level_step<C, 2>(E, F, D, rr, kk, acc, lmask, g);
      level_step<C, 4>(E, F, D, rr, kk, acc, lmask, g);
      level_step<C, 8>(E, F, D, rr, kk, acc, lmask, g);
      if constexpr (C > 16) level_step<C, 16>(E, F, D, rr, kk, acc, lmask, g);
      // the u-bonus of this warp's channels on the diagonal (t = tau)
#pragma unroll
      for (int mm = 0; mm < NM; ++mm)
#pragma unroll
        for (int d = 0; d < 2; ++d)
#pragma unroll
          for (int e = 2 * d; e < 2 * d + 2; ++e)
            if (g == 2 * c + (e & 1)) acc[tile_index(mm, 2 * mm + d)][e] += bonus[2 * mm + d];
#pragma unroll
      for (int i = 0; i < L::NTILES; ++i)
        SP[(warp * L::NTILES + i) * 32 + lane] = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      // now E = P[0, p), F = P(p, C), D = P[0, C); channel k0 + e is k-slot
      // c + 4e of r P's k-step `warp`
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int p = 8 * j + g;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          uint32_t hi, lo;
          split(rr[j][e] * E[j][e], hi, lo);
          const int ro = core_offset(p, 8 * warp + c + 4 * e, L::RD_SBO) / 4;
          RDH[ro] = hi, RDL[ro] = lo;
          split(kk[j][e] * F[j][e], hi, lo);
          const int ko = core_offset(k0 + e, p, L::KC_SBO) / 4;
          KCH[ko] = hi, KCL[ko] = lo;
        }
      }
      if (g == 0) *reinterpret_cast<float2*>(DT + k0) = make_float2(D[0][0], D[0][1]);
      fence_async_smem();
    }
    __syncthreads();

    //    the scores: the warps' partial sums, tile by tile, split into TF32 halves
    for_items<L::NTILES * 32>([&](int i) {
      const int tile = i / 32, ln = i % 32;
      int mm = 0;
      while (tile_index(mm + 1, 0) <= tile) ++mm;
      const int n = tile - tile_index(mm, 0);
      float4 s = SP[tile * 32 + ln];
#pragma unroll
      for (int ww = 1; ww < NWARPS; ++ww) {
        const float4 x = SP[(ww * L::NTILES + tile) * 32 + ln];
        s.x += x.x, s.y += x.y, s.z += x.z, s.w += x.w;
      }
      const int t = 16 * mm + (ln >> 2), tau = 8 * n + 2 * (ln & 3);
      const float sv[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        uint32_t hi, lo;
        split(sv[e], hi, lo);
        const int o = core_offset(t + 8 * (e >> 1), tau + (e & 1), L::SA_SBO) / 4;
        SAH[o] = hi, SAL[o] = lo;
      }
    });
    fence_async_smem();
    __syncthreads();

    // 3. y^T (64 x C) = S^T (r P[0,t))^T + v^T A^T, warpgroup q over its half of
    //    K and the tau steps ks = q (mod 2); the halves summed through shared
    //    memory.  A operands in registers, B operands from shared memory.
    const T* vrow = cur.v + 16 * wq + g;
    auto v_frag = [&](int ks, uint32_t(&vh)[4], uint32_t(&vl)[4]) {
      const float va[4] = {to_f32(vrow[(8 * ks + c) * L::RS]), to_f32(vrow[(8 * ks + c) * L::RS + 8]),
                           to_f32(vrow[(8 * ks + c + 4) * L::RS]), to_f32(vrow[(8 * ks + c + 4) * L::RS + 8])};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if constexpr (EXACT) {
          vh[e] = __float_as_uint(va[e]), vl[e] = 0u;
        } else {
          split(va[e], vh[e], vl[e]);
        }
      }
    };
    float ya[C / 2];
#pragma unroll
    for (int i = 0; i < C / 2; ++i) ya[i] = 0.f;
    uint32_t sh[4][4], sl[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // accumulator columns (2c, 2c+1) as the A operand's k-slots (c, c+4)
      split(S[4 * i + 0], sh[i][0], sl[i][0]);
      split(S[4 * i + 2], sh[i][1], sl[i][1]);
      split(S[4 * i + 1], sh[i][2], sl[i][2]);
      split(S[4 * i + 3], sh[i][3], sl[i][3]);
    }
    uint32_t vh[NT / 2][4], vl[NT / 2][4];
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) v_frag(2 * kk + q, vh[kk], vl[kk]);
    wgmma_fence();
    fence_regs(ya);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int o = core_offset(0, 8 * (4 * q + i), L::RD_SBO);
      wgmma3<false>(ya, sh[i], sl[i], make_desc(RDH + o / 4, 128, L::RD_SBO), make_desc(RDL + o / 4, 128, L::RD_SBO));
    }
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
      const int o = core_offset(0, 8 * (2 * kk + q), L::SA_SBO);
      wgmma3<EXACT>(ya, vh[kk], vl[kk], make_desc(SAH + o / 4, 128, L::SA_SBO),
                    make_desc(SAL + o / 4, 128, L::SA_SBO));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(ya);
    float* yp = YP + wq * (C / 2) * 32 + lane;
    if (q == 1) {
#pragma unroll
      for (int i = 0; i < C / 2; ++i) yp[i * 32] = ya[i];
    }
    __syncthreads();
    if (q == 0) {
      float* yc = yb + t0 * y_t;
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          yc[(8 * n + 2 * c + (e & 1)) * y_t + 8 * (e >> 1)] = ya[4 * n + e] + yp[(4 * n + e) * 32];
    }

    //    S^T = S^T diag(P[0, C)) + v^T (k P(t, C)), warpgroup q over its 32 columns of K
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 d = *reinterpret_cast<const float2*>(DT + 32 * q + 8 * i + 2 * c);
      S[4 * i + 0] *= d.x;
      S[4 * i + 1] *= d.y;
      S[4 * i + 2] *= d.x;
      S[4 * i + 3] *= d.y;
    }
    uint32_t uh[NT][4], ul[NT][4];
#pragma unroll
    for (int ks = 0; ks < NT; ++ks) v_frag(ks, uh[ks], ul[ks]);
    wgmma_fence();
    fence_regs(S);
#pragma unroll
    for (int ks = 0; ks < NT; ++ks) {
      const int o = core_offset(32 * q, 8 * ks, L::KC_SBO);
      wgmma3<EXACT>(S, uh[ks], ul[ks], make_desc(KCH + o / 4, 128, L::KC_SBO), make_desc(KCL + o / 4, 128, L::KC_SBO));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(S);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = 16 * wq + g + 8 * (e >> 1), col = 32 * q + 8 * i + 2 * c + (e & 1);
      sT[((int64_t)bh * KD + col) * KD + row] = S[4 * i + e];
    }
}

template <typename T, int C>
cudaError_t launch(const void* r, const void* k, const void* v, const float* w, const float* u,
                   const float* s0, float* y, float* sT, int B, int H, int T_len, const Strides& st,
                   cudaStream_t stream) {
  constexpr int smem = Layout<T, C>::BYTES;
  auto kernel = wkv6_sm90_kernel<T, C>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<B * H, NTHREADS, smem, stream>>>(static_cast<const T*>(r), static_cast<const T*>(k),
                                             static_cast<const T*>(v), w, u, s0, y, sT, H, T_len, st);
  return cudaGetLastError();
}

// The sub-chunk the kernel runs for a chunk: 32 where it divides the chunk, else 16.
template <typename T>
cudaError_t launch_c(int chunk, const void* r, const void* k, const void* v, const float* w, const float* u,
                     const float* s0, float* y, float* sT, int B, int H, int T_len, const Strides& st,
                     cudaStream_t stream) {
  if (chunk % 32 == 0) return launch<T, 32>(r, k, v, w, u, s0, y, sT, B, H, T_len, st, stream);
  return launch<T, 16>(r, k, v, w, u, s0, y, sT, B, H, T_len, st, stream);
}

}  // namespace

// dtype (of r, k, v): 0 = float32, 1 = bfloat16; w, u, s0, y, s_T are f32.
// r, k, w are (B, T, H, 64) and v (B, T, H, 64) with the strides given (12
// int64 in elements, in the order of `Strides`: r, k, v, w, each batch,
// time, head); every base address and stride must be a multiple of 16 bytes
// (cp.async copies 16 bytes).  u is contiguous (H, 64); s0 (may be null:
// zeros) and s_T contiguous (B, H, 64, 64); y contiguous (B, T, H, 64).
// Needs K = V = 64, a chunk C that is a multiple of 16 up to 64, T % C == 0.
// Launches on `stream` and returns cudaGetLastError() of the launch (0 on
// success).
extern "C" int wkv6_sm90_fwd(const void* r, const void* k, const void* v, const float* w, const float* u,
                             const float* s0, float* y, float* sT, int dtype, int B, int H, int T_len, int C,
                             int K, int V, const int64_t* strides, void* stream) {
  if (B <= 0 || H <= 0 || T_len <= 0 || K != KD || V != KD || C <= 0 || C > 64 || C % 16 || T_len % C)
    return (int)cudaErrorInvalidValue;
  for (int i = 1; i < 12; i += 3)  // the time strides, and y's: 32 rows of each in 32-bit offsets
    if (strides[i] < 0 || strides[i] > (1 << 25)) return (int)cudaErrorInvalidValue;
  if ((int64_t)H * KD > (1 << 25)) return (int)cudaErrorInvalidValue;
  Strides st;
  st.r_b = strides[0]; st.r_t = strides[1]; st.r_h = strides[2];
  st.k_b = strides[3]; st.k_t = strides[4]; st.k_h = strides[5];
  st.v_b = strides[6]; st.v_t = strides[7]; st.v_h = strides[8];
  st.w_b = strides[9]; st.w_t = strides[10]; st.w_h = strides[11];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_c<float>(C, r, k, v, w, u, s0, y, sT, B, H, T_len, st, s);
  if (dtype == 1) return (int)launch_c<__nv_bfloat16>(C, r, k, v, w, u, s0, y, sT, B, H, T_len, st, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* wkv6_sm90_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
