// RWKV-6 wkv chunked scan for Hopper (sm_90a), CUDA C++ with a plain C entry.
//
// Replaces the TPU kernel `src/repro/kernels/wkv/kernel.py`: `wkv6_bhtk`
// (pl.pallas_call at :136, body `_wkv_kernel` :26).  Same function, per
// (batch b, head h), with a K x V state S carried over the sequence:
//
//     y_t = r_t (S_{t-1} + diag(u) k_t v_t^T)        S_t = diag(w_t) S_{t-1} + k_t v_t^T
//
// computed chunk by chunk in log space, as the Pallas kernel does: with
// lw = log(max(w, 1e-20)), li the inclusive and le the exclusive cumulative
// sum of lw inside the chunk, and lt its total,
//
//     y_t  = (r_t exp(le_t)) S  +  sum_{tau<t} A[t][tau] v_tau  +  (sum_k r_t u k_t) v_t
//     A[t][tau] = sum_k r_t[k] k_tau[k] exp(le_t[k] - li_tau[k])
//     S'   = diag(exp(lt)) S  +  sum_tau (k_tau exp(lt - li_tau)) v_tau^T
//
// Inputs r, k, v are f32 or bf16, w, u and s0 f32; everything is computed in
// f32 (bf16 is widened with __bfloat162float as it is read, never rounded
// again; no TF32).  Outputs y and s_T are f32.
//
// Design.  The TPU walks the chunks on a sequential grid axis and carries S
// in VMEM scratch.  CUDA blocks run in no order, so nothing could carry S from
// one block to the next: one block owns one (b, h) and loops over the T/C
// chunks itself, with S (K x V f32, 16 KB at 64 x 64) in shared memory for
// the whole sequence.  Each chunk's r, k, v, lw and the cumulative log decays
// are staged in shared memory as f32 (rows padded to K + 1 so that threads
// reading different rows hit different banks), then the block computes, with
// a barrier between each: the cumulative sums (one thread per channel), the
// C x C scores, the decayed r and k, y, and the new S.  r, k, v, w are read
// in the model's (B, T, H, K) layout through strides, so the wrapper folds
// nothing; u is read at row h (the Pallas kernel's `b % n_heads` in its
// folded (B*H) layout).  Any C <= 64 and K, V <= 64 work: a prompt shorter
// than the model's chunk of 32 runs one ragged chunk of C = T.
//
// Why not the Pallas kernel's straddle-boundary factorisation (kernel.py:
// 62-99).  There each score exp(le_t - li_tau) is split into two factors
// around a power-of-two boundary between tau and t, one masked C x C matmul
// per level, only so that the scores are MXU-shaped matrix products.  Here
// each score is summed directly over k; every exponent le_t - li_tau with
// tau < t is a partial sum of log decays, so it is <= 0 and cannot overflow
// at any decay strength, with no levels and no masks.  The cost is one expf
// per (t, tau, k): C(C-1)/2 * K = 31,744 per chunk at C = 32, K = 64, on the
// SFUs.  A later wgmma redesign may bring the factorisation back to put the
// scores on the tensor cores.
//
// Bound on an H100 SXM.  At the rwkv6-3b prefill shape (B=4, T=1024, H=40,
// K=V=64, bf16 r/k/v, f32 w) the bytes moved once are r, k, v (63 MB), w
// (42 MB), y (42 MB) and s0, s_T (5 MB): 152 MB, 45 us at 3.35 TB/s.  The
// chunked form's f32 work per chunk is 4CKV (state application and state
// update, one multiply-add each) plus C(C+1)(K+V) (scores and their
// application for tau <= t): 3.4 GFLOP in all, 50 us at the 67 TFLOP/s f32
// peak without tensor cores, so the bound is the f32 pipe (the expf calls
// are not counted).  This first kernel runs every product as a scalar
// f32 FMA with shared-memory operands, recomputes an expf per score term,
// launches only B*H = 160 blocks on 132 SMs, and does not overlap the
// chunk loads with compute (no cp.async / TMA), so it stays well above that.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 256;
constexpr int MAX_DIM = 64;  // C, K and V are each at most 64

struct Strides {  // in elements; the last dim is contiguous
  int64_t r_b, r_t, r_h;
  int64_t k_b, k_t, k_h;
  int64_t v_b, v_t, v_h;
  int64_t w_b, w_t, w_h;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

size_t smem_floats(int C, int K, int V) {
  return (size_t)4 * C * (K + 1) + (size_t)C * V + (size_t)C * (C + 1) + (size_t)K * V + 2 * K;
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
wkv6_fwd_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
                const float* __restrict__ w, const float* __restrict__ u,
                const float* __restrict__ s0, float* __restrict__ y, float* __restrict__ sT,
                int H, int T_len, int C, int K, int V, Strides st) {
  extern __shared__ float smem[];
  const int KP = K + 1;
  const int CP = C + 1;
  float* sR = smem;               // [C][KP] r, then r * exp(le)
  float* sK = sR + C * KP;        // [C][KP] k, then k * exp(lt - li)
  float* sLe = sK + C * KP;       // [C][KP] lw, then the exclusive cumulative sum le
  float* sLi = sLe + C * KP;      // [C][KP] inclusive cumulative sum li
  float* sV = sLi + C * KP;       // [C][V]
  float* sA = sV + C * V;         // [C][CP] scores, the u-bonus on the diagonal
  float* sS = sA + C * CP;        // [K][V] carried state
  float* sU = sS + K * V;         // [K] bonus u of head h
  float* sLt = sU + K;            // [K] chunk-total log decay lt

  const int bh = blockIdx.x;  // b * H + h, the row of s0 / s_T
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x;

  const T* rb = r + (int64_t)b * st.r_b + (int64_t)h * st.r_h;
  const T* kb = k + (int64_t)b * st.k_b + (int64_t)h * st.k_h;
  const T* vb = v + (int64_t)b * st.v_b + (int64_t)h * st.v_h;
  const float* wb = w + (int64_t)b * st.w_b + (int64_t)h * st.w_h;
  const int64_t y_t = (int64_t)H * V;  // y is contiguous (B, T, H, V)
  float* yb = y + (int64_t)b * T_len * y_t + (int64_t)h * V;

  for (int i = tid; i < K * V; i += NTHREADS) sS[i] = s0 ? s0[(int64_t)bh * K * V + i] : 0.f;
  for (int i = tid; i < K; i += NTHREADS) sU[i] = u[(int64_t)h * K + i];

  for (int t0 = 0; t0 < T_len; t0 += C) {
    // 1. stage the chunk as f32
    for (int i = tid; i < C * K; i += NTHREADS) {
      const int t = i / K, d = i % K;
      const int64_t tt = t0 + t;
      sR[t * KP + d] = to_f32(rb[tt * st.r_t + d]);
      sK[t * KP + d] = to_f32(kb[tt * st.k_t + d]);
      sLe[t * KP + d] = logf(fmaxf(wb[tt * st.w_t + d], 1e-20f));
    }
    for (int i = tid; i < C * V; i += NTHREADS) {
      const int t = i / V, e = i % V;
      sV[i] = to_f32(vb[(int64_t)(t0 + t) * st.v_t + e]);
    }
    __syncthreads();

    // 2. cumulative log decays, one thread per channel.  Summed in order,
    //    le_t = li_{t-1} exactly, so le_t - li_tau <= 0 for every tau < t.
    for (int d = tid; d < K; d += NTHREADS) {
      float acc = 0.f;
      for (int t = 0; t < C; ++t) {
        const float lw = sLe[t * KP + d];
        sLe[t * KP + d] = acc;
        acc += lw;
        sLi[t * KP + d] = acc;
      }
      sLt[d] = acc;
    }
    __syncthreads();

    // 3. scores: tau < t decayed, tau == t the u-bonus, tau > t zero
    for (int i = tid; i < C * C; i += NTHREADS) {
      const int t = i / C, tau = i % C;
      const float* rt = sR + t * KP;
      const float* kt = sK + tau * KP;
      float acc = 0.f;
      if (tau < t) {
        const float* le = sLe + t * KP;
        const float* li = sLi + tau * KP;
        for (int d = 0; d < K; ++d) acc = fmaf(rt[d] * kt[d], expf(le[d] - li[d]), acc);
      } else if (tau == t) {
        for (int d = 0; d < K; ++d) acc = fmaf(rt[d] * sU[d], kt[d], acc);
      }
      sA[t * CP + tau] = acc;
    }
    __syncthreads();

    // 4. r * exp(le) for the inter-chunk term; k * exp(lt - li) for the carry
    for (int i = tid; i < C * K; i += NTHREADS) {
      const int t = i / K, d = i % K;
      const int j = t * KP + d;
      sR[j] *= expf(sLe[j]);
      sK[j] *= expf(sLt[d] - sLi[j]);
    }
    __syncthreads();

    // 5. y_t = (r_t exp(le_t)) S + sum_{tau <= t} A[t][tau] v_tau, from the old S
    for (int i = tid; i < C * V; i += NTHREADS) {
      const int t = i / V, e = i % V;
      const float* rt = sR + t * KP;
      const float* at = sA + t * CP;
      float acc = 0.f;
      for (int d = 0; d < K; ++d) acc = fmaf(rt[d], sS[d * V + e], acc);
      for (int tau = 0; tau <= t; ++tau) acc = fmaf(at[tau], sV[tau * V + e], acc);
      yb[(int64_t)(t0 + t) * y_t + e] = acc;
    }
    __syncthreads();

    // 6. S = diag(exp(lt)) S + sum_tau (k_tau exp(lt - li_tau)) v_tau^T
    for (int i = tid; i < K * V; i += NTHREADS) {
      const int d = i / V, e = i % V;
      float acc = expf(sLt[d]) * sS[i];
      for (int tau = 0; tau < C; ++tau) acc = fmaf(sK[tau * KP + d], sV[tau * V + e], acc);
      sS[i] = acc;
    }
    __syncthreads();
  }

  for (int i = tid; i < K * V; i += NTHREADS) sT[(int64_t)bh * K * V + i] = sS[i];
}

template <typename T>
cudaError_t launch(const void* r, const void* k, const void* v, const float* w, const float* u,
                   const float* s0, float* y, float* sT, int B, int H, int T_len, int C, int K,
                   int V, const Strides& st, cudaStream_t stream) {
  const size_t smem = smem_floats(C, K, V) * sizeof(float);
  auto kernel = wkv6_fwd_kernel<T>;
  // above 48 KB only after this attribute; 116 KB at C = K = V = 64
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<B * H, NTHREADS, smem, stream>>>(static_cast<const T*>(r), static_cast<const T*>(k),
                                             static_cast<const T*>(v), w, u, s0, y, sT, H, T_len,
                                             C, K, V, st);
  return cudaGetLastError();
}

}  // namespace

// dtype (of r, k, v): 0 = float32, 1 = bfloat16; w, u, s0, y, s_T are f32.
// r, k, w are (B, T, H, K) and v (B, T, H, V) with the strides given (12
// int64 in elements, in the order of `Strides`: r, k, v, w, each batch,
// time, head); u is contiguous (H, K); s0 (may be null: zeros), s_T are
// contiguous (B, H, K, V); y is contiguous (B, T, H, V).  Needs T % C == 0
// and C, K, V <= 64.  Launches on `stream` and returns cudaGetLastError() of
// the launch (0 on success).
extern "C" int wkv6_fwd(const void* r, const void* k, const void* v, const float* w,
                        const float* u, const float* s0, float* y, float* sT, int dtype, int B,
                        int H, int T_len, int C, int K, int V, const int64_t* strides,
                        void* stream) {
  if (B <= 0 || H <= 0 || T_len <= 0 || C <= 0 || K <= 0 || V <= 0 || T_len % C ||
      C > MAX_DIM || K > MAX_DIM || V > MAX_DIM)
    return (int)cudaErrorInvalidValue;
  Strides st;
  st.r_b = strides[0]; st.r_t = strides[1]; st.r_h = strides[2];
  st.k_b = strides[3]; st.k_t = strides[4]; st.k_h = strides[5];
  st.v_b = strides[6]; st.v_t = strides[7]; st.v_h = strides[8];
  st.w_b = strides[9]; st.w_t = strides[10]; st.w_h = strides[11];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = launch<float>(r, k, v, w, u, s0, y, sT, B, H, T_len, C, K, V, st, s);
  else if (dtype == 1)
    err = launch<__nv_bfloat16>(r, k, v, w, u, s0, y, sT, B, H, T_len, C, K, V, st, s);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}

extern "C" const char* wkv6_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
