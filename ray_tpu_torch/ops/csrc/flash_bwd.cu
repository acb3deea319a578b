// Flash-attention backward for Hopper (sm_90a): the gradients of
// O = softmax(Q K^T * scale) V with respect to Q, K and V, causal or full,
// from the saved O's per-row f32 log-sum-exp (LSE) and
// delta = rowsum(dO * O), which the caller computes in f32.
//
// Two kernels, as in the TPU reference (ray_tpu/ops/attention.py):
//   B2 flash_bwd_dkv_kernel replaces _bwd_dkv_kernel (launched by
//      _bhsd_bwd): one CUDA block per (key tile, head, batch) loops over
//      the query tiles that can see its keys and accumulates
//        P  = exp(S - LSE)               S = Q K^T * scale
//        dV += P^T dO
//        dS = P * (dO V^T - delta) * scale
//        dK += dS^T Q
//   B3 flash_bwd_dq_kernel replaces _bwd_dq_kernel: one CUDA block per
//      (query tile, head, batch) loops over the key tiles its rows can see
//      and accumulates dQ += dS K.
// dQ is its own kernel, as in the reference, so every output element is
// summed by one thread in a fixed order: the result is deterministic (no
// atomics), at the price of computing S and dO V^T twice.
//
// Rounding is the TPU kernels': every product takes inputs of the input
// type (bf16 values are exact in the f32 tiles) and sums in f32; P is
// rounded to the input type before P^T dO, dS before dS^T Q and dS K;
// dK, dV and dQ are written in the input type. P is set to 0 by index
// wherever a key is masked (causal, or past the ragged end of S or Sk),
// instead of relying on exp(-1e30 - LSE) = 0, so a row can never give
// P = 1 from a masked score.
//
// Redesigned for the GPU, not copied block by block: the TPU runs a
// sequential grid with f32 scratch carried across grid steps on
// 1024-row blocks padded to 128 lanes. Here the loop over the other
// sequence axis runs inside the block, the accumulators live in
// registers (4 rows x 8 columns of each output per thread), and causally
// dead tiles are never visited. The public [B, S, H, D] layout is read
// through row strides (H * D), so nothing is padded or transposed; LSE
// and delta are [B, H, S] f32.
//
// Bound on the H100: at the training shapes (B = 4, S = 1024, H = 32,
// D = 128, causal, bf16) products and bytes are close. B2 does 4 and B3
// 3 products of 2 * D flops per visible (query, key) pair, S(S+1)/2
// pairs per head: 0.070 and 0.052 ms at the tensor cores' 989 TFLOP/s,
// against 0.060 and 0.050 ms for their bytes at 3.35 TB/s. This
// first version runs the products as scalar f32 FMAs on the CUDA cores
// (67 TFLOP/s peak) from f32 tiles in shared memory, which is simple and
// keeps f32 inputs exact, and so sits well above that bound; tensor-core
// tiles (mma.sync / wgmma) and TMA are the next step.
//
// Instantiated for float32 and bfloat16 at head dim 128, the types and
// width of the training path; the wrappers refuse anything else.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (ray_tpu_torch/ops/_build.py does this).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int D = 128;       // head dim (the only one instantiated)
constexpr int BQ = 64;       // query rows per tile
constexpr int BK = 64;       // key rows per tile
constexpr int CG = 16;       // column groups: threads sharing one row group
constexpr int RPT = 4;       // rows per thread (query rows, or key rows)
constexpr int NT = (BQ / RPT) * CG;   // 256 threads
constexpr int KC = BK / CG;  // score columns per thread
constexpr int DC = D / CG;   // output columns per thread
constexpr int LD = D + 1;    // padded row of a [rows][D] f32 tile
constexpr int LP = BK + 1;   // padded row of a [BQ][BK] f32 tile
static_assert(BQ == BK, "one thread layout serves both tile axes");

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to T and read back as f32: the reference's `.astype(q.dtype)`
// before a product.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// rows [r0, r0 + 64) of one head of a [B, n, H, D] tensor (base already
// at batch b, head h; `row` = H * D) into dst [64][LD] f32, zeros past n.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* base,
                                          long row, int r0, int n) {
  for (int i = threadIdx.x; i < 64 * D; i += NT) {
    const int r = i / D, d = i % D, s = r0 + r;
    dst[r * LD + d] = s < n ? to_f(base[s * row + d]) : 0.f;
  }
}

// s[i][j] = Q[qr] . K[kc] and dp[i][j] = dO[qr] . V[kc] for the thread's
// query rows qr = rg * RPT + i and key columns kc = cg + CG * j.
__device__ __forceinline__ void scores(const float* Qs, const float* dOs,
                                       const float* Ks, const float* Vs,
                                       int rg, int cg, float s[RPT][KC],
                                       float dp[RPT][KC]) {
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < KC; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float qv[RPT], ov[RPT], kv[KC], vv[KC];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      qv[i] = Qs[(rg * RPT + i) * LD + d];
      ov[i] = dOs[(rg * RPT + i) * LD + d];
    }
#pragma unroll
    for (int j = 0; j < KC; ++j) {
      kv[j] = Ks[(cg + CG * j) * LD + d];
      vv[j] = Vs[(cg + CG * j) * LD + d];
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < KC; ++j) {
        s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
        dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
      }
  }
}

// P (f32, 0 where masked) and dS = P * (dP - delta) * scale for the
// thread's (query, key) pairs; q0/k0 are the tiles' first indices.
__device__ __forceinline__ void probs(float s[RPT][KC], float dp[RPT][KC],
                                      const float* lse_s,
                                      const float* delta_s, int q0, int k0,
                                      int S, int Sk, int causal, float scale,
                                      int rg, int cg) {
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = rg * RPT + i, qi = q0 + r;
#pragma unroll
    for (int j = 0; j < KC; ++j) {
      const int kj = k0 + cg + CG * j;
      const bool live = qi < S && kj < Sk && (!causal || kj <= qi);
      const float p = live ? expf(s[i][j] * scale - lse_s[r]) : 0.f;
      s[i][j] = p;
      dp[i][j] = p * (dp[i][j] - delta_s[r]) * scale;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(NT)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int S, int Sk, int H, float scale,
                     int causal) {
  extern __shared__ float smem[];
  float* Qs = smem;                   // [BQ][LD]
  float* dOs = Qs + BQ * LD;          // [BQ][LD]
  float* Ks = dOs + BQ * LD;          // [BK][LD]
  float* Vs = Ks + BK * LD;           // [BK][LD]
  float* Ps = Vs + BK * LD;           // [BQ][LP]  P rounded to T
  float* dSs = Ps + BQ * LP;          // [BQ][LP]  dS rounded to T
  float* lse_s = dSs + BQ * LP;       // [BQ]
  float* delta_s = lse_s + BQ;        // [BQ]

  const int b = blockIdx.z, h = blockIdx.y;
  const int k0 = blockIdx.x * BK;
  const int tid = threadIdx.x;
  const int rg = tid / CG, cg = tid % CG;
  const long row = long(H) * D;
  const long qoff = (long(b) * S * H + h) * D;
  const long koff = (long(b) * Sk * H + h) * D;
  const float* lse_b = lse + (long(b) * H + h) * S;
  const float* delta_b = delta + (long(b) * H + h) * S;

  load_tile(Ks, k + koff, row, k0, Sk);
  load_tile(Vs, v + koff, row, k0, Sk);

  // Accumulators for key rows rg * RPT + i, columns cg + CG * j.
  float adk[RPT][DC], adv[RPT][DC];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < DC; ++j) adk[i][j] = adv[i][j] = 0.f;

  const int nq = (S + BQ - 1) / BQ;
  // Causal: query tiles wholly above the diagonal see none of these keys.
  for (int qt = causal ? k0 / BQ : 0; qt < nq; ++qt) {
    const int q0 = qt * BQ;
    __syncthreads();                  // previous tiles fully consumed
    load_tile(Qs, q + qoff, row, q0, S);
    load_tile(dOs, dout + qoff, row, q0, S);
    if (tid < BQ) {
      const int qi = q0 + tid;
      lse_s[tid] = qi < S ? lse_b[qi] : 0.f;
      delta_s[tid] = qi < S ? delta_b[qi] : 0.f;
    }
    __syncthreads();

    float s[RPT][KC], dp[RPT][KC];
    scores(Qs, dOs, Ks, Vs, rg, cg, s, dp);
    probs(s, dp, lse_s, delta_s, q0, k0, S, Sk, causal, scale, rg, cg);
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < KC; ++j) {
        const int at = (rg * RPT + i) * LP + cg + CG * j;
        Ps[at] = round_to<T>(s[i][j]);
        dSs[at] = round_to<T>(dp[i][j]);
      }
    __syncthreads();                  // Ps, dSs complete

    // dV += P^T dO, dK += dS^T Q over the tile's query rows.
#pragma unroll 4
    for (int qq = 0; qq < BQ; ++qq) {
      float pv[RPT], sv[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        pv[i] = Ps[qq * LP + rg * RPT + i];
        sv[i] = dSs[qq * LP + rg * RPT + i];
      }
#pragma unroll
      for (int j = 0; j < DC; ++j) {
        const float ov = dOs[qq * LD + cg + CG * j];
        const float qv = Qs[qq * LD + cg + CG * j];
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          adv[i][j] = fmaf(pv[i], ov, adv[i][j]);
          adk[i][j] = fmaf(sv[i], qv, adk[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int kj = k0 + rg * RPT + i;
    if (kj >= Sk) continue;
#pragma unroll
    for (int j = 0; j < DC; ++j) {
      const long at = koff + kj * row + cg + CG * j;
      dk[at] = from_f<T>(adk[i][j]);
      dv[at] = from_f<T>(adv[i][j]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int S, int Sk, int H, float scale, int causal) {
  extern __shared__ float smem[];
  float* Qs = smem;                   // [BQ][LD]
  float* dOs = Qs + BQ * LD;          // [BQ][LD]
  float* Ks = dOs + BQ * LD;          // [BK][LD]
  float* Vs = Ks + BK * LD;           // [BK][LD]
  float* dSs = Vs + BK * LD;          // [BQ][LP]  dS rounded to T
  float* lse_s = dSs + BQ * LP;       // [BQ]
  float* delta_s = lse_s + BQ;        // [BQ]

  const int b = blockIdx.z, h = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const int rg = tid / CG, cg = tid % CG;
  const long row = long(H) * D;
  const long qoff = (long(b) * S * H + h) * D;
  const long koff = (long(b) * Sk * H + h) * D;

  load_tile(Qs, q + qoff, row, q0, S);
  load_tile(dOs, dout + qoff, row, q0, S);
  if (tid < BQ) {
    const int qi = q0 + tid;
    const long at = (long(b) * H + h) * S + qi;
    lse_s[tid] = qi < S ? lse[at] : 0.f;
    delta_s[tid] = qi < S ? delta[at] : 0.f;
  }

  // Accumulator for query rows rg * RPT + i, columns cg + CG * j.
  float adq[RPT][DC];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < DC; ++j) adq[i][j] = 0.f;

  int nk = (Sk + BK - 1) / BK;
  if (causal) nk = min(nk, (q0 + BQ - 1) / BK + 1);   // dead tiles skipped

  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();                  // previous tiles fully consumed
    load_tile(Ks, k + koff, row, k0, Sk);
    load_tile(Vs, v + koff, row, k0, Sk);
    __syncthreads();

    float s[RPT][KC], dp[RPT][KC];
    scores(Qs, dOs, Ks, Vs, rg, cg, s, dp);
    probs(s, dp, lse_s, delta_s, q0, k0, S, Sk, causal, scale, rg, cg);
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < KC; ++j)
        dSs[(rg * RPT + i) * LP + cg + CG * j] = round_to<T>(dp[i][j]);
    __syncthreads();                  // dSs complete

    // dQ += dS K over the tile's keys.
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float sv[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) sv[i] = dSs[(rg * RPT + i) * LP + kk];
#pragma unroll
      for (int j = 0; j < DC; ++j) {
        const float kv = Ks[kk * LD + cg + CG * j];
#pragma unroll
        for (int i = 0; i < RPT; ++i) adq[i][j] = fmaf(sv[i], kv, adq[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int qi = q0 + rg * RPT + i;
    if (qi >= S) continue;
#pragma unroll
    for (int j = 0; j < DC; ++j)
      dq[qoff + qi * row + cg + CG * j] = from_f<T>(adq[i][j]);
  }
}

constexpr size_t DKV_SMEM =
    sizeof(float) * (4 * 64 * LD + 2 * BQ * LP + 2 * BQ);
constexpr size_t DQ_SMEM =
    sizeof(float) * (4 * 64 * LD + BQ * LP + 2 * BQ);

template <typename T>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv,
               int B, int S, int Sk, int H, int causal, float scale,
               cudaStream_t stream) {
  auto kern = flash_bwd_dkv_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(DKV_SMEM));
  if (err != cudaSuccess) return int(err);
  const dim3 grid((Sk + BK - 1) / BK, H, B);
  kern<<<grid, NT, DKV_SMEM, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), S, Sk, H, scale, causal);
  return int(cudaGetLastError());
}

template <typename T>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, int B, int S,
              int Sk, int H, int causal, float scale, cudaStream_t stream) {
  auto kern = flash_bwd_dq_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(DQ_SMEM));
  if (err != cudaSuccess) return int(err);
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  kern<<<grid, NT, DQ_SMEM, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), S, Sk, H, scale, causal);
  return int(cudaGetLastError());
}

bool bad_shape(int B, int S, int Sk, int H, int d) {
  return B < 1 || S < 1 || Sk < 1 || H < 1 || d != D;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; head dim must be 128. q, dout are
// [B, S, H, D] and k, v, dk, dv [B, Sk, H, D], all contiguous; lse and
// delta are [B, H, S] float32. Each returns the launch's cudaError_t (0 on
// success); the caller raises on anything else.
extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, void* dk, void* dv, int B,
                             int S, int Sk, int H, int d, int dtype,
                             int causal, float scale, void* stream) {
  if (bad_shape(B, S, Sk, H, d)) return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_dkv<float>(q, k, v, dout, lse, delta, dk, dv, B, S, Sk, H, causal, scale, st);
    case 1: return launch_dkv<__nv_bfloat16>(q, k, v, dout, lse, delta, dk, dv, B, S, Sk, H, causal, scale, st);
    default: return int(cudaErrorInvalidValue);
  }
}

extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, void* dq, int B, int S,
                            int Sk, int H, int d, int dtype, int causal,
                            float scale, void* stream) {
  if (bad_shape(B, S, Sk, H, d)) return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_dq<float>(q, k, v, dout, lse, delta, dq, B, S, Sk, H, causal, scale, st);
    case 1: return launch_dq<__nv_bfloat16>(q, k, v, dout, lse, delta, dq, B, S, Sk, H, causal, scale, st);
    default: return int(cudaErrorInvalidValue);
  }
}

extern "C" const char* flash_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
