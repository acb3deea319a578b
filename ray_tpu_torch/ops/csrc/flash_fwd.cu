// Flash-attention forward for Hopper (sm_90a): O and the per-row f32
// log-sum-exp of softmax(Q K^T * scale) V, causal or full.
//
// Replaces the TPU kernel ray_tpu/ops/attention.py::_fwd_kernel (launched
// by _flash_fwd_bhsd). Same function, redesigned for the GPU:
//   - one CUDA block per (query tile of 64 rows, head, batch); a loop over
//     key tiles up to the causal limit replaces the TPU's sequential key
//     grid axis, so the running max / sum / accumulator live in registers;
//   - the online softmax runs in f32; P is rounded to the input type before
//     P.V, as the TPU kernel does (`p.astype(v.dtype)`), and both products
//     sum in f32; the row sum l adds the unrounded P;
//   - ragged S and Sk are masked by absolute index inside the kernel (no
//     padding of the tensors); rows with l == 0 give O = 0 and LSE = -1e30;
//   - the layout is the public [B, S, H, D] one, read through row strides,
//     so no transpose runs before or after the kernel; LSE is [B, H, S].
//
// Bound on the H100: at the serving shapes (S <= 512, D = 128, bf16) the
// least time is set by bytes: at B = 1, S = 512 the inputs and outputs are
// 16.8 MB, 5.0 us at 3.35 TB/s, against 2.2 us of causal products at the
// tensor cores' 989 TFLOP/s. At the training shape (B = 4, S = 1024) the
// 34.4 GFLOP of causal products take 0.035 ms at that rate and the bytes
// 0.040 ms: the two are close, so the products must run on the tensor
// cores. The bf16 kernel (namespace tc) is built on them, from the helpers
// B2 and B3 use (hopper.cuh):
//   - S = Q K^T and O += P V are mma.sync.m16n8k16 (bf16 operands, f32
//     accumulators). Each of the block's 4 warps owns 16 query rows; Q's A
//     fragments are read once with ldmatrix and held in 32 registers a
//     thread; K is the B operand of Q K^T, read with ldmatrix from its
//     [key][D] tile, V the B operand of P V, read with ldmatrix.trans from
//     its [key][D] tile: no tile is transposed;
//   - P never touches shared memory: the m16n8 accumulators of a 64-key
//     tile are scaled, masked, exponentiated and summed in registers, then
//     packed to bf16 as P V's A fragments (to_a). That packing is the
//     rounding the reference does;
//   - each row's scores lie on the 4 lanes of a quad, so the row max takes
//     two __shfl_xor_sync (lane masks 1 and 2); each lane keeps its own
//     part of the row sum l until the end (the rescale factor is the
//     quad's, so the parts stay consistent);
//   - exp2f, with log2(e) folded into the scale: scores, the running max
//     and the rescale factors are in base-2 units, and LSE = m ln 2 + ln l;
//   - only the causal diagonal tile and a ragged last key tile are masked;
//     interior tiles skip the index arithmetic;
//   - K and V tiles are bf16 in shared memory, 16-byte chunks XOR-swizzled
//     by row, copied with 16-byte cp.async into two stages: the next tile
//     loads while this one computes; rows past Sk are zero-filled by the
//     copy. Shared memory: Q 16 KB + 2 x (K + V) 64 KB = 80 KB; at most
//     255 registers a thread (__launch_bounds__(128, 2)): two blocks per SM;
//   - the grid runs (head, batch, query tile) with the causally heaviest
//     query tiles first;
//   - O leaves through the warp's own 16 rows of the Q tile as bf16, so each
//     lane writes whole 16-byte chunks of a row; one lane per quad writes
//     LSE.
// What still separates it from the card's best: mma.sync reaches about two
// thirds of the tensor cores' rate, where wgmma (a warpgroup's 64-row
// products, B from shared memory) reaches all of it; every thread issues
// its own copies rather than one TMA request per tile; 8 of 64 warp slots
// per SM leave little latency hiding; at B = 1, S = 128 the grid has 64
// blocks for 132 SMs.
//
// The f32 kernel (namespace scalar) keeps the first, scalar design: the
// tensor cores take f32 only as TF32 (10 mantissa bits), which would break
// the f32 limit this kernel is held to (1e-4). It runs both products as
// f32 FMAs on the CUDA cores (4 rows x 8 columns per thread, padded f32
// tiles in shared memory, 128 threads).
//
// Instantiated at head dim 128; the wrapper pads narrower heads with zeros
// and refuses wider ones.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (ray_tpu_torch/ops/_build.py does this).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using hopper::D;             // head dim (the only one instantiated)
constexpr float NEG_INF = -1e30f;

// ---------------------------------------------------------------------------
// f32: scalar FMAs on the CUDA cores
// ---------------------------------------------------------------------------
namespace scalar {

constexpr int BQ = 64;       // query rows per block
constexpr int BK = 64;       // keys per tile
constexpr int CG = 8;        // column groups: threads sharing one row group
constexpr int RPT = 4;       // query rows per thread
constexpr int NT = (BQ / RPT) * CG;   // 128 threads
constexpr int DC = D / CG;   // output columns per thread
constexpr int KC = BK / CG;  // score columns per thread
constexpr size_t SMEM = sizeof(float) *
                        (size_t(BQ) * (D + 1) + size_t(BK) * (D + 1) +
                         size_t(BK) * D + size_t(BQ) * (BK + 1));

__global__ void __launch_bounds__(NT)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, int S, int Sk, int H,
                     float scale, int causal) {
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
  const float* qb = q + (long(b) * S * H + h) * D;
  const float* kb = k + (long(b) * Sk * H + h) * D;
  const float* vb = v + (long(b) * Sk * H + h) * D;

  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, d = i % D, s = q0 + r;
    Qs[r * (D + 1) + d] = s < S ? qb[s * row + d] : 0.f;
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
      Ks[r * (D + 1) + d] = in ? kb[s * row + d] : 0.f;
      Vs[r * D + d] = in ? vb[s * row + d] : 0.f;
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
        Ps[(rg * RPT + i) * (BK + 1) + cg + CG * j] = p;
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

  float* ob = o + (long(b) * S * H + h) * D;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int qi = q0 + rg * RPT + i;
    if (qi >= S) continue;
    const float ls = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int j = 0; j < DC; ++j) ob[qi * row + cg + CG * j] = acc[i][j] / ls;
    if (cg == 0)
      lse[(long(b) * H + h) * S + qi] =
          l[i] == 0.f ? NEG_INF : m[i] + logf(ls);
  }
}

}  // namespace scalar

// ---------------------------------------------------------------------------
// bf16: mma.sync tensor-core tiles
// ---------------------------------------------------------------------------
namespace tc {

using namespace hopper;
constexpr int BK = 64;                   // keys per stage
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr size_t SMEM = 5 * TILE;        // Q, then 2 stages of K and V
static_assert(BK == ROWS, "K and V tiles are load_tile's 64 rows");

// Grid (H, B, query tiles); query tile z sees 64 (z + 1) keys when causal,
// so the heaviest (last) tiles start first.
__global__ void __launch_bounds__(NT, 2)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o,
                 float* __restrict__ lse, int S, int Sk, int H, float scale,
                 int causal) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t Qs = smem_u32(smem);        // [64][D]; O on the way out
  const uint32_t Ks = Qs + TILE;             // [2 stages][64][D]
  const uint32_t Vs = Ks + 2 * TILE;         // [2 stages][64][D]

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * ROWS;
  const int lane = threadIdx.x & 31, m0 = (threadIdx.x >> 5) * 16;
  const int g = lane >> 2, t = lane & 3;
  const long row = long(H) * D;
  const long qoff = (long(b) * S * H + h) * D;
  const long koff = (long(b) * Sk * H + h) * D;
  const float sl2 = scale * LOG2E;

  auto stage = [&](int kt, int st) {
    load_tile(Ks + st * TILE, k + koff, row, kt * BK, Sk);
    load_tile(Vs + st * TILE, v + koff, row, kt * BK, Sk);
  };

  int nk = (Sk + BK - 1) / BK;
  if (causal) nk = min(nk, (q0 + ROWS - 1) / BK + 1);   // dead tiles
  load_tile(Qs, q + qoff, row, q0, S);
  cp_commit();
  stage(0, 0);
  cp_commit();
  cp_wait<1>();                               // Q has landed
  __syncthreads();
  // The warp's 16 query rows as A fragments, one per 16 columns of D.
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    ldsm(Qs + swz(m0 + (lane & 15), 2 * kk + (lane >> 4)), qf[kk]);

  // The thread's rows qa (c0, c1 of every tile) and qa + 8 (c2, c3): the
  // running max (base 2) and this lane's part of the row sum.
  const int qa = q0 + m0 + g;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float acc[16][4];
#pragma unroll
  for (int nt = 0; nt < 16; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;

  for (int kt = 0; kt < nk; ++kt) {
    const int st = kt & 1, k0 = kt * BK;
    if (kt + 1 < nk) stage(kt + 1, st ^ 1);   // freed by the last sync
    cp_commit();
    cp_wait<1>();                             // this stage has landed
    __syncthreads();

    const uint32_t Kt = Ks + st * TILE, Vt = Vs + st * TILE;
    float s[8][4];                            // S: 16 queries x 64 keys
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        // matrices (n 0-7, k 0-7), (n 0-7, k 8-15), (n 8-15, k 0-7),
        // (n 8-15, k 8-15): b0, b1 of n-tile 2np, then of 2np + 1.
        uint32_t fb[4];
        ldsm(Kt + swz(16 * np + (lane & 7) + ((lane >> 4) << 3),
                      2 * kk + ((lane >> 3) & 1)), fb);
        mma(s[2 * np], qf[kk], fb[0], fb[1]);
        mma(s[2 * np + 1], qf[kk], fb[2], fb[3]);
      }

    // Base-2 scores; the mask only where a key may be hidden from a row:
    // the causal diagonal of this warp's rows, or keys past Sk.
    const bool edge = (causal && k0 + BK - 1 > q0 + m0) || k0 + BK > Sk;
    if (edge) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kj = k0 + 8 * j + 2 * t + (e & 1), qi = qa + 8 * (e >> 1);
          const bool live = kj < Sk && (!causal || kj <= qi);
          s[j][e] = live ? s[j][e] * sl2 : NEG_INF;
        }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] *= sl2;
    }

    // Online softmax per row; a row's 64 scores lie on the quad's 4 lanes.
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float mx = m[hr];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * hr], s[j][2 * hr + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float alpha = exp2f(m[hr] - mx);
      m[hr] = mx;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 2 * hr; e < 2 * hr + 2; ++e) {
          const float p = exp2f(s[j][e] - mx);
          s[j][e] = p;
          sum += p;
        }
      l[hr] = alpha * l[hr] + sum;
#pragma unroll
      for (int nt = 0; nt < 16; ++nt) {
        acc[nt][2 * hr] *= alpha;
        acc[nt][2 * hr + 1] *= alpha;
      }
    }

    uint32_t pa[4][4];                        // P as bf16 A fragments
    to_a<4>(s, pa);
    accumulate<4>(acc, pa, Vt, 0, lane);      // O += P V
    __syncthreads();                          // this stage consumed
  }
  cp_wait<0>();

  // The quad's parts of each row sum, then O = acc / l (O = 0 where
  // l = 0), rounded to bf16 into the warp's own 16 rows of the Q tile
  // (only this warp read them), and from there to O in 16-byte chunks.
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 1);
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 2);
  }
  const float l0 = l[0] == 0.f ? 1.f : l[0], l1 = l[1] == 0.f ? 1.f : l[1];
#pragma unroll
  for (int nt = 0; nt < 16; ++nt) {
    *reinterpret_cast<uint32_t*>(smem + swz(m0 + g, nt) + 4 * t) =
        pack(acc[nt][0] / l0, acc[nt][1] / l0);
    *reinterpret_cast<uint32_t*>(smem + swz(m0 + g + 8, nt) + 4 * t) =
        pack(acc[nt][2] / l1, acc[nt][3] / l1);
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < 16 * CH / 32; ++i) {
    const int idx = i * 32 + lane, r = idx / CH, c = idx % CH;
    const int qi = q0 + m0 + r;
    if (qi < S)
      *reinterpret_cast<uint4*>(o + qoff + qi * row + c * 8) =
          *reinterpret_cast<const uint4*>(smem + swz(m0 + r, c));
  }
  if (t == 0) {
    float* lb = lse + (long(b) * H + h) * S;
    if (qa < S) lb[qa] = l[0] == 0.f ? NEG_INF : m[0] * LN2 + logf(l0);
    if (qa + 8 < S)
      lb[qa + 8] = l[1] == 0.f ? NEG_INF : m[1] * LN2 + logf(l1);
  }
}

}  // namespace tc

int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int B, int S, int Sk, int H, int dtype, int causal, float scale,
           cudaStream_t stream) {
  cudaError_t err;
  float* l = static_cast<float*>(lse);
  if (dtype == 0) {
    auto kern = scalar::flash_fwd_f32_kernel;
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(scalar::SMEM));
    if (err != cudaSuccess) return int(err);
    const dim3 grid((S + scalar::BQ - 1) / scalar::BQ, H, B);
    kern<<<grid, scalar::NT, scalar::SMEM, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), l, S, Sk, H,
        scale, causal);
  } else {
    using tc::bf16;
    auto kern = tc::flash_fwd_kernel;
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(tc::SMEM));
    if (err != cudaSuccess) return int(err);
    const dim3 grid(H, B, (S + tc::ROWS - 1) / tc::ROWS);
    kern<<<grid, tc::NT, tc::SMEM, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<bf16*>(o), l, S, Sk, H,
        scale, causal);
  }
  return int(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; D must be 128. q/o are [B, S, H, D],
// k/v [B, Sk, H, D], all contiguous and 16-byte aligned; lse is [B, H, S]
// float32. Returns the launch's cudaError_t (0 on success); the caller
// raises on anything else.
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         void* o, void* lse, int B, int S, int Sk, int H,
                         int d, int dtype, int causal, float scale,
                         void* stream) {
  if (B < 1 || S < 1 || Sk < 1 || H < 1 || d != D || dtype < 0 || dtype > 1)
    return int(cudaErrorInvalidValue);
  return launch(q, k, v, o, lse, B, S, Sk, H, dtype, causal, scale,
                static_cast<cudaStream_t>(stream));
}

// How many blocks of B1 fit on one SM at once (registers, shared memory,
// threads), from the CUDA runtime; dtype as above. Writes the count to
// *blocks and returns the cudaError_t.
extern "C" int flash_fwd_blocks_per_sm(int dtype, int* blocks) {
  const void* fn =
      dtype == 0 ? reinterpret_cast<const void*>(scalar::flash_fwd_f32_kernel)
                 : reinterpret_cast<const void*>(tc::flash_fwd_kernel);
  const int threads = dtype == 0 ? scalar::NT : tc::NT;
  const size_t smem = dtype == 0 ? scalar::SMEM : tc::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  return int(cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fn,
                                                           threads, smem));
}

extern "C" const char* flash_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
