// Flash-attention forward for Hopper (sm_90a), f32, CUDA C++ with a plain C
// entry.  bf16 inputs take the tensor-core route, `flash_attn_sm90.cu`.
//
// Replaces the TPU kernel `src/repro/kernels/attention/kernel.py`:
// `flash_attention_bhtd` (pl.pallas_call at :124, body `_attn_kernel` :26).
// Same function: causal / sliding-window GQA attention with an online
// softmax whose running max, denominator and accumulator are f32,
// sm_scale = 1/sqrt(hd), kv blocks that are fully in the future or fully
// expired are skipped, rows that see no key output 0 (denominator clamped to
// 1e-30), and the output is f32.
//
// Why a route of its own: wgmma has no f32 product other than TF32, which
// keeps about three decimal digits, and the f32 parity tests and the f32
// smoke model need full f32 (the Pallas kernel's
// preferred_element_type=f32).  So every product here is a scalar f32 FMA.
//
// Design.  The TPU walks kv blocks on a sequential grid axis and carries the
// softmax state in VMEM scratch; here one thread block owns one (q block,
// head, batch) triple and loops over the kv blocks itself, so nothing has to
// carry between blocks.  BQ x hd of q and BK x hd of k (then v, in the same
// buffer) are held in shared memory; the BQ x BK scores and probabilities
// too.  256 threads form a 16 x 16 grid: each computes a 4 x 4 patch of the
// scores and a 4 x (hd/16) patch of the accumulator in registers.  One warp
// per 8 rows does the softmax with shuffles.  The kv head of q head h is
// h / (H/KV): kv is read once per q head from its own rows, never repeated
// in memory.
//
// Bound on an H100 SXM.  For the llama3.2-3b prefill shape in f32 (B=4,
// T=S=1024, H=24, KV=8, hd=128, causal) the work is 25.8 GFLOP, 385 us at
// the 67 TFLOP/s f32 peak without tensor cores; the bytes (q, k, v read
// once, o written once) are 134 MB, 40 us at 3.35 TB/s.  Every FMA reads
// its operands from shared memory, which caps it well below that peak; the
// loads are synchronous and the diagonal blocks compute their masked half.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;          // query rows per block
constexpr int BK = 64;          // keys per kv tile
constexpr int NTHREADS = 256;   // 16 x 16 thread grid
constexpr int RQ = BQ / 16;     // score / accumulator rows per thread
constexpr int CK = BK / 16;     // score columns per thread
constexpr float NEG_INF = -1e30f;

struct Strides {  // in elements; the head dim is contiguous
  int64_t q_b, q_t, q_h;
  int64_t k_b, k_s, k_h;
  int64_t v_b, v_s, v_h;
  int64_t o_b, o_t, o_h;
};

__device__ __forceinline__ bool visible(int qpos, int kpos, int S, int causal, int window) {
  return kpos < S && (!causal || kpos <= qpos) && (window <= 0 || qpos - kpos < window);
}

template <int HD>
constexpr int smem_floats() {
  return BQ * (HD + 1) + BK * (HD + 1) + BQ * (BK + 1) + 3 * BQ;
}

// Copy `rows` rows of HD elements from global (row stride `rs`) into shared
// f32 rows of stride HD + 1 (the pad keeps column reads conflict-free);
// rows at or past `valid` are zero.
template <int HD>
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src, int64_t rs,
                                          int rows, int valid) {
  for (int i = threadIdx.x; i < rows * HD; i += NTHREADS) {
    const int r = i / HD, d = i % HD;
    dst[r * (HD + 1) + d] = r < valid ? src[(int64_t)r * rs + d] : 0.f;
  }
}

template <int HD>
__global__ void __launch_bounds__(NTHREADS)
flash_attn_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                      float* __restrict__ o, int T_len, int S_len, int group, Strides st,
                      int causal, int window, float sm_scale) {
  constexpr int CV = HD / 16;  // accumulator columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;                       // [BQ][HD + 1]
  float* sKV = sQ + BQ * (HD + 1);        // [BK][HD + 1], k then v
  float* sP = sKV + BK * (HD + 1);        // [BQ][BK + 1], scores then probabilities
  float* sM = sP + BQ * (BK + 1);         // [BQ] running max
  float* sL = sM + BQ;                    // [BQ] running denominator
  float* sAlpha = sL + BQ;                // [BQ] rescale of this kv tile

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / group;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int warp = tid / 32, lane = tid % 32;

  const float* qb = q + (int64_t)b * st.q_b + (int64_t)q0 * st.q_t + (int64_t)h * st.q_h;
  const float* kb = k + (int64_t)b * st.k_b + (int64_t)kvh * st.k_h;
  const float* vb = v + (int64_t)b * st.v_b + (int64_t)kvh * st.v_h;

  load_tile<HD>(sQ, qb, st.q_t, BQ, T_len - q0);
  for (int r = tid; r < BQ; r += NTHREADS) {
    sM[r] = NEG_INF;
    sL[r] = 0.f;
  }
  float acc[RQ][CV];
#pragma unroll
  for (int i = 0; i < RQ; ++i)
#pragma unroll
    for (int j = 0; j < CV; ++j) acc[i][j] = 0.f;
  __syncthreads();

  // kv tiles that hold at least one visible key for some row of this block
  const int q_last = min(q0 + BQ, T_len) - 1;
  int kb_end = (S_len + BK - 1) / BK;
  if (causal) kb_end = min(kb_end, q_last / BK + 1);
  int kb_begin = 0;
  if (window > 0 && q0 - window + 1 > 0) kb_begin = (q0 - window + 1) / BK;

  for (int kt = kb_begin; kt < kb_end; ++kt) {
    const int k0 = kt * BK;
    load_tile<HD>(sKV, kb + (int64_t)k0 * st.k_s, st.k_s, BK, S_len - k0);
    __syncthreads();

    // scores: rows ty*RQ + i, columns tx + 16*j
    float s[RQ][CK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < CK; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qv[RQ], kv[CK];
#pragma unroll
      for (int i = 0; i < RQ; ++i) qv[i] = sQ[(ty * RQ + i) * (HD + 1) + d];
#pragma unroll
      for (int j = 0; j < CK; ++j) kv[j] = sKV[(tx + 16 * j) * (HD + 1) + d];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < CK; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < CK; ++j) sP[(ty * RQ + i) * (BK + 1) + tx + 16 * j] = s[i][j] * sm_scale;
    __syncthreads();

    // online softmax, one warp per BQ/8 rows, two columns per lane
    for (int rr = 0; rr < BQ / 8; ++rr) {
      const int r = warp * (BQ / 8) + rr;
      const int qpos = q0 + r;
      const bool v0 = visible(qpos, k0 + lane, S_len, causal, window);
      const bool v1 = visible(qpos, k0 + lane + 32, S_len, causal, window);
      const float s0 = v0 ? sP[r * (BK + 1) + lane] : NEG_INF;
      const float s1 = v1 ? sP[r * (BK + 1) + lane + 32] : NEG_INF;
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = sM[r];
      const float m_new = fmaxf(m_prev, mx);
      const float p0 = v0 ? expf(s0 - m_new) : 0.f;
      const float p1 = v1 ? expf(s1 - m_new) : 0.f;
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      sP[r * (BK + 1) + lane] = p0;
      sP[r * (BK + 1) + lane + 32] = p1;
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        sL[r] = sL[r] * alpha + sum;
        sM[r] = m_new;
        sAlpha[r] = alpha;
      }
    }
    // v replaces k in the same buffer: every read of k ended at the last barrier
    load_tile<HD>(sKV, vb + (int64_t)k0 * st.v_s, st.v_s, BK, S_len - k0);
    __syncthreads();

    // acc = acc * alpha + P @ V: rows ty*RQ + i, columns tx + 16*j
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      float pv[CV];
#pragma unroll
      for (int j = 0; j < CV; ++j) pv[j] = 0.f;
      const float* prow = sP + (ty * RQ + i) * (BK + 1);
#pragma unroll 4
      for (int c = 0; c < BK; ++c) {
        const float p = prow[c];
#pragma unroll
        for (int j = 0; j < CV; ++j) pv[j] = fmaf(p, sKV[c * (HD + 1) + tx + 16 * j], pv[j]);
      }
      const float alpha = sAlpha[ty * RQ + i];
#pragma unroll
      for (int j = 0; j < CV; ++j) acc[i][j] = acc[i][j] * alpha + pv[j];
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int r = ty * RQ + i;
    if (q0 + r >= T_len) continue;
    const float inv_l = 1.f / fmaxf(sL[r], 1e-30f);
    float* orow = o + (int64_t)b * st.o_b + (int64_t)(q0 + r) * st.o_t + (int64_t)h * st.o_h;
#pragma unroll
    for (int j = 0; j < CV; ++j) orow[tx + 16 * j] = acc[i][j] * inv_l;
  }
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int H, int KV,
                   int T_len, int S_len, const Strides& st, int causal, int window,
                   float sm_scale, cudaStream_t stream) {
  const size_t smem = smem_floats<HD>() * sizeof(float);
  auto kernel = flash_attn_fwd_kernel<HD>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((T_len + BQ - 1) / BQ, H, B);
  kernel<<<grid, NTHREADS, smem, stream>>>(static_cast<const float*>(q), static_cast<const float*>(k),
                                           static_cast<const float*>(v), static_cast<float*>(o), T_len,
                                           S_len, H / KV, st, causal, window, sm_scale);
  return cudaGetLastError();
}

}  // namespace

// f32 q (B,H,T,hd), k and v (B,KV,S,hd), o like q.  strides: 12 int64 in
// elements, (batch, sequence, head) of q, k, v, o; the head dim is
// contiguous.  Launches on `stream` and returns cudaGetLastError() of the
// launch (0 on success).
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v, void* o, int B, int H, int KV,
                              int T_len, int S_len, int hd, const int64_t* strides, int causal, int window,
                              float sm_scale, void* stream) {
  if (B <= 0 || H <= 0 || KV <= 0 || H % KV || T_len <= 0 || S_len <= 0)
    return (int)cudaErrorInvalidValue;
  Strides st;
  st.q_b = strides[0]; st.q_t = strides[1]; st.q_h = strides[2];
  st.k_b = strides[3]; st.k_s = strides[4]; st.k_h = strides[5];
  st.v_b = strides[6]; st.v_s = strides[7]; st.v_h = strides[8];
  st.o_b = strides[9]; st.o_t = strides[10]; st.o_h = strides[11];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return (int)launch<16>(q, k, v, o, B, H, KV, T_len, S_len, st, causal, window, sm_scale, s);
    case 32: return (int)launch<32>(q, k, v, o, B, H, KV, T_len, S_len, st, causal, window, sm_scale, s);
    case 48: return (int)launch<48>(q, k, v, o, B, H, KV, T_len, S_len, st, causal, window, sm_scale, s);
    case 64: return (int)launch<64>(q, k, v, o, B, H, KV, T_len, S_len, st, causal, window, sm_scale, s);
    case 128: return (int)launch<128>(q, k, v, o, B, H, KV, T_len, S_len, st, causal, window, sm_scale, s);
    case 192: return (int)launch<192>(q, k, v, o, B, H, KV, T_len, S_len, st, causal, window, sm_scale, s);
    case 256: return (int)launch<256>(q, k, v, o, B, H, KV, T_len, S_len, st, causal, window, sm_scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* flash_attn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
