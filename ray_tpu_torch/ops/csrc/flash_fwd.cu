// Flash-attention forward for Hopper (sm_90a): O and the per-row f32
// log-sum-exp of softmax(Q K^T * scale) V, causal or full.
//
// Replaces the TPU kernel ray_tpu/ops/attention.py::_fwd_kernel (launched
// by _flash_fwd_bhsd). Same function, redesigned for the GPU:
//   - one CUDA block per (query tile of BQ rows, head, batch); a loop over
//     key tiles up to the causal limit replaces the TPU's sequential key
//     grid axis, so the running max / sum / accumulator live in registers;
//   - K and V tiles are staged in shared memory as f32, Q once per block;
//   - P is rounded to the input type before P.V, as the TPU kernel does
//     (`p.astype(v.dtype)`), and both products accumulate in f32;
//   - ragged S is masked by absolute index inside the kernel (no padding
//     of the tensors); rows with l == 0 give O = 0 and LSE = -1e30;
//   - the layout is the public [B, S, H, D] one, read through row strides,
//     so no transpose runs before or after the kernel; LSE is [B, H, S].
//
// Bound on the H100: at the serving shapes (S <= 512, D = 128, bf16) the
// least time is set by bytes, not operations: at S = 512 the inputs and
// outputs are 16.8 MB, 5.0 us at 3.35 TB/s, against 2.2 us for the
// products at the tensor cores' 989 TFLOP/s. This first version does the
// products as scalar f32 FMAs on the CUDA cores (67 TFLOP/s peak), which
// keeps f32 inputs exact and the code simple, and so sits 60-70x above
// that bound; register tiling (4 rows x 8 columns per thread) and padded
// shared-memory rows keep it free of bank conflicts. Tensor-core tiles
// (mma.sync / wgmma) and TMA are the next step.
//
// Instantiated for float32 and bfloat16 at head dim 128, the types and
// width of the serving path; the wrapper refuses anything else.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (ray_tpu_torch/ops/_build.py does this).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;       // query rows per block
constexpr int BK = 64;       // keys per tile
constexpr int CG = 8;        // column groups: threads sharing one row group
constexpr int RPT = 4;       // query rows per thread
constexpr int NT = (BQ / RPT) * CG;   // 128 threads
constexpr float NEG_INF = -1e30f;

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

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (size_t(BQ) * (D + 1) + size_t(BK) * (D + 1) + size_t(BK) * D +
          size_t(BQ) * (BK + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int S, int Sk, int H, float scale,
                 int causal) {
  static_assert(D % CG == 0, "head dim must be a multiple of 8");
  constexpr int DC = D / CG;          // output columns per thread
  constexpr int KC = BK / CG;         // score columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                   // [BQ][D + 1]
  float* Ks = Qs + BQ * (D + 1);      // [BK][D + 1]
  float* Vs = Ks + BK * (D + 1);      // [BK][D]
  float* Ps = Vs + BK * D;            // [BQ][BK + 1]

  const int b = blockIdx.z, h = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const int rg = tid / CG, cg = tid % CG;
  const long row = long(H) * D;       // stride between sequence positions
  const T* qb = q + (long(b) * S * H + h) * D;
  const T* kb = k + (long(b) * Sk * H + h) * D;
  const T* vb = v + (long(b) * Sk * H + h) * D;

  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, d = i % D, s = q0 + r;
    Qs[r * (D + 1) + d] = s < S ? to_f(qb[s * row + d]) : 0.f;
  }

  float m[RPT], l[RPT], acc[RPT][DC];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[i][j] = 0.f;
  }

  int nk = (Sk + BK - 1) / BK;
  if (causal) nk = min(nk, (q0 + BQ - 1) / BK + 1);   // dead tiles skipped

  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();                  // previous tile fully consumed
    for (int i = tid; i < BK * D; i += NT) {
      const int r = i / D, d = i % D, s = k0 + r;
      const bool in = s < Sk;
      Ks[r * (D + 1) + d] = in ? to_f(kb[s * row + d]) : 0.f;
      Vs[r * D + d] = in ? to_f(vb[s * row + d]) : 0.f;
    }
    __syncthreads();

    float sc[RPT][KC];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < KC; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[RPT], kv[KC];
#pragma unroll
      for (int i = 0; i < RPT; ++i) qv[i] = Qs[(rg * RPT + i) * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < KC; ++j) kv[j] = Ks[(cg + CG * j) * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < KC; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int qi = q0 + rg * RPT + i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < KC; ++j) {
        const int kj = k0 + cg + CG * j;
        float x = sc[i][j] * scale;
        if (kj >= Sk || (causal && kj > qi)) x = NEG_INF;
        sc[i][j] = x;
        mx = fmaxf(mx, x);
      }
      // The CG threads of a row group are adjacent lanes of one warp.
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < KC; ++j) {
        const float p = expf(sc[i][j] - m_new);
        sum += p;
        Ps[(rg * RPT + i) * (BK + 1) + cg + CG * j] = to_f(from_f<T>(p));
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      l[i] = alpha * l[i] + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DC; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();                  // Ps complete

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pv[i] = Ps[(rg * RPT + i) * (BK + 1) + kk];
#pragma unroll
      for (int j = 0; j < DC; ++j) {
        const float vv = Vs[kk * D + cg + CG * j];
#pragma unroll
        for (int i = 0; i < RPT; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }

  T* ob = o + (long(b) * S * H + h) * D;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int qi = q0 + rg * RPT + i;
    if (qi >= S) continue;
    const float ls = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int j = 0; j < DC; ++j)
      ob[qi * row + cg + CG * j] = from_f<T>(acc[i][j] / ls);
    if (cg == 0)
      lse[(long(b) * H + h) * S + qi] =
          l[i] == 0.f ? NEG_INF : m[i] + logf(ls);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int B, int S, int Sk, int H, int causal, float scale,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  auto kern = flash_fwd_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o),
      static_cast<float*>(lse), S, Sk, H, scale, causal);
  return int(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; D must be 128. q/o are [B, S, H, D],
// k/v [B, Sk, H, D], all contiguous; lse is [B, H, S] float32. Returns the
// launch's cudaError_t (0 on success); the caller raises on anything else.
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         void* o, void* lse, int B, int S, int Sk, int H,
                         int D, int dtype, int causal, float scale,
                         void* stream) {
  if (B < 1 || S < 1 || Sk < 1 || H < 1 || D != 128)
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float, 128>(q, k, v, o, lse, B, S, Sk, H, causal, scale, st);
    case 1: return launch<__nv_bfloat16, 128>(q, k, v, o, lse, B, S, Sk, H, causal, scale, st);
    default: return int(cudaErrorInvalidValue);
  }
}

extern "C" const char* flash_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
