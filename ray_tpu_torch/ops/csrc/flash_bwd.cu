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
// summed in one fixed order: the result is deterministic (no atomics), at
// the price of computing S and dO V^T twice.
//
// Rounding is the TPU kernels': every product takes operands of the input
// type and sums in f32; exp(s * scale - LSE) is f32; P is rounded to the
// input type before P^T dO, dS before dS^T Q and dS K; dK, dV and dQ are
// written in the input type. P is set to 0 by index wherever a key is
// masked (causal, or past the ragged end of S or Sk), so a row can never
// give P = 1 from a masked score. Causally dead tiles are never visited.
// The public [B, S, H, D] layout is read through the row stride H * D:
// nothing is padded or transposed in device memory. LSE and delta are
// [B, H, S] f32.
//
// Bound on the H100 at the training shape (B = 4, S = 1024, H = 32,
// D = 128, causal, bf16): B2 does 4 and B3 3 products of 2 * D flops per
// visible (query, key) pair, S(S+1)/2 pairs per head, 0.0696 and 0.0522 ms
// at the tensor cores' 989 TFLOP/s; their bytes (0.060 and 0.050 ms at
// 3.35 TB/s) are close behind. So the bf16 kernels are built on the tensor
// cores:
//   - every product is mma.sync.m16n8k16 (bf16 operands, f32
//     accumulators), its operands read from shared memory with ldmatrix
//     (.trans where the tile is stored [contraction][output]);
//   - each of a block's 4 warps owns 16 rows of the block's tile. B2
//     computes the transposed scores S^T = K Q^T and dP^T = V dO^T for its
//     16 keys; the accumulators of P^T and dS^T, rounded to bf16, are the
//     A fragments of dV += P^T dO and dK += dS^T Q as they stand (an
//     m16n8 accumulator pair has the layout of an m16k16 A fragment), so
//     P and dS never go through shared memory. B3 computes S = Q K^T and
//     dP = dO V^T for its 16 queries and dQ += dS K, with K read through
//     ldmatrix.trans;
//   - tiles are bf16 in shared memory, their 16-byte chunks XOR-swizzled
//     by row so that ldmatrix's 8 rows hit 8 different bank groups, and
//     copied with 16-byte cp.async into two stages over the loop axis (Q
//     and dO tiles in B2, K and V tiles in B3): the next tile loads while
//     this one computes. Rows past S or Sk are zero-filled by the copy;
//   - tiles are 64 rows (4 warps x 16) on both axes, 128 threads a block,
//     at most 255 registers a thread (__launch_bounds__(128, 2)): two
//     blocks per SM, 97 KB of shared memory each (B3: 96 KB). B2 holds
//     128 f32 accumulators per thread for dK and dV, so it takes each
//     stage's 64 queries in two halves of 32, in a loop the compiler does
//     not unroll: S^T and dP^T then need 32 registers, not 64, and the
//     kernel does not spill (all 64 at once, or the two halves unrolled,
//     spilled 32 bytes). The build's -Xptxas -v report gives 255
//     registers and no spills for each, and the runtime's occupancy
//     calculator 2 blocks per SM (chip_smoke.py prints both).
// What still separates them from the card's best: mma.sync reaches about
// two thirds of the tensor cores' rate, where wgmma (a warpgroup's 64-row
// products, B from shared memory) reaches all of it; every thread starts
// its own copies rather than one TMA request per tile, with a
// __syncthreads() per stage rather than mbarriers; no warp is specialised
// to load, and 8 of 64 warp slots per SM leave little to hide latency
// with.
//
// The f32 kernels stay on the first, scalar design: the tensor cores take
// f32 only as TF32 (10 mantissa bits), which would break the f32 limits
// these kernels are held to (1e-5 of max|grad|). They run every product as
// f32 FMAs on the CUDA cores from f32 tiles, 4 rows x 8 columns of each
// output per thread: 256 threads, 174 (B2) and 128 (B3) registers, 162
// and 146 KB of shared memory, 1 block per SM.
//
// Instantiated at head dim 128, the width of the training path; the
// wrappers pad narrower heads with zeros up to 128 and refuse wider ones.
// The tensor-core helpers (swizzled tiles, cp.async, ldmatrix, mma.sync,
// to_a) are in hopper.cuh, shared with B1 (flash_fwd.cu).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (ray_tpu_torch/ops/_build.py does this).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using hopper::D;             // head dim (the only one instantiated)

// ---------------------------------------------------------------------------
// f32: scalar FMAs on the CUDA cores
// ---------------------------------------------------------------------------
namespace scalar {

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

// rows [r0, r0 + 64) of one head of a [B, n, H, D] tensor (base already
// at batch b, head h; `row` = H * D) into dst [64][LD], zeros past n.
__device__ __forceinline__ void load_tile(float* dst, const float* base,
                                          long row, int r0, int n) {
  for (int i = threadIdx.x; i < 64 * D; i += NT) {
    const int r = i / D, d = i % D, s = r0 + r;
    dst[r * LD + d] = s < n ? base[s * row + d] : 0.f;
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

// P (0 where masked) and dS = P * (dP - delta) * scale for the thread's
// (query, key) pairs; q0/k0 are the tiles' first indices.
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

__global__ void __launch_bounds__(NT)
flash_bwd_dkv_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv,
                         int S, int Sk, int H, float scale, int causal) {
  extern __shared__ float smem[];
  float* Qs = smem;                   // [BQ][LD]
  float* dOs = Qs + BQ * LD;          // [BQ][LD]
  float* Ks = dOs + BQ * LD;          // [BK][LD]
  float* Vs = Ks + BK * LD;           // [BK][LD]
  float* Ps = Vs + BK * LD;           // [BQ][LP]
  float* dSs = Ps + BQ * LP;          // [BQ][LP]
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
        Ps[at] = s[i][j];
        dSs[at] = dp[i][j];
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
      dk[at] = adk[i][j];
      dv[at] = adv[i][j];
    }
  }
}

__global__ void __launch_bounds__(NT)
flash_bwd_dq_f32_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        float* __restrict__ dq, int S, int Sk, int H,
                        float scale, int causal) {
  extern __shared__ float smem[];
  float* Qs = smem;                   // [BQ][LD]
  float* dOs = Qs + BQ * LD;          // [BQ][LD]
  float* Ks = dOs + BQ * LD;          // [BK][LD]
  float* Vs = Ks + BK * LD;           // [BK][LD]
  float* dSs = Vs + BK * LD;          // [BQ][LP]
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
        dSs[(rg * RPT + i) * LP + cg + CG * j] = dp[i][j];
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
      dq[qoff + qi * row + cg + CG * j] = adq[i][j];
  }
}

constexpr size_t DKV_SMEM =
    sizeof(float) * (4 * 64 * LD + 2 * BQ * LP + 2 * BQ);
constexpr size_t DQ_SMEM =
    sizeof(float) * (4 * 64 * LD + BQ * LP + 2 * BQ);

}  // namespace scalar

// ---------------------------------------------------------------------------
// bf16: mma.sync tensor-core tiles
// ---------------------------------------------------------------------------
namespace tc {

// The shared tensor-core helpers (hopper.cuh): smem_u32, swz, cp16,
// cp_commit / cp_wait, load_tile, ldsm / ldsm_t, mma, pack, to_a,
// accumulate, store_rows; 4 warps of 16 rows, 64-row tiles.
using namespace hopper;
constexpr int STEP = 64;             // rows of the loop axis per stage
static_assert(STEP == ROWS, "one tile size serves both axes");

__device__ __forceinline__ void cp4(uint32_t dst, const void* src,
                                    bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(full ? 4 : 0));
}

// src[r0, r0 + 64) into dst[64] f32; zeros past n.
__device__ __forceinline__ void load_vec(uint32_t dst, const float* src,
                                         int r0, int n) {
  if (threadIdx.x < STEP) {
    const int s = r0 + threadIdx.x;
    cp4(dst + threadIdx.x * 4, src + (s < n ? s : 0), s < n);
  }
}

// x[j] = A1[m0, m0 + 16) . B1[n0 + 8j, n0 + 8j + 8)^T and y[j] likewise
// from A2, B2, over all D, for 16 NP columns: four swizzled [64][D] tiles,
// A rows the warp's own, B rows those of the other axis. These are S and
// dP (B3), or S^T and dP^T (B2).
template <int NP>
__device__ __forceinline__ void score_pair(uint32_t a1, uint32_t a2,
                                           uint32_t b1, uint32_t b2, int m0,
                                           int n0, int lane,
                                           float (&x)[2 * NP][4],
                                           float (&y)[2 * NP][4]) {
#pragma unroll
  for (int j = 0; j < 2 * NP; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[j][e] = y[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t fa1[4], fa2[4];
    const uint32_t ao = swz(m0 + (lane & 15), 2 * kk + (lane >> 4));
    ldsm(a1 + ao, fa1);
    ldsm(a2 + ao, fa2);
#pragma unroll
    for (int np = 0; np < NP; ++np) {
      // matrices (n 0-7, k 0-7), (n 0-7, k 8-15), (n 8-15, k 0-7),
      // (n 8-15, k 8-15): b0, b1 of n-tile 2np, then of 2np + 1.
      uint32_t fb1[4], fb2[4];
      const uint32_t bo = swz(n0 + 16 * np + (lane & 7) + ((lane >> 4) << 3),
                              2 * kk + ((lane >> 3) & 1));
      ldsm(b1 + bo, fb1);
      ldsm(b2 + bo, fb2);
      mma(x[2 * np], fa1, fb1[0], fb1[1]);
      mma(x[2 * np + 1], fa1, fb1[2], fb1[3]);
      mma(y[2 * np], fa2, fb2[0], fb2[1]);
      mma(y[2 * np + 1], fa2, fb2[2], fb2[3]);
    }
  }
}

// Grid (H, B, key tiles); key tile z runs S - 64z queries, so the
// heaviest tiles start first.
__global__ void __launch_bounds__(NT, 2)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v,
                     const bf16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int S, int Sk, int H,
                     float scale, int causal) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t Ks = smem_u32(smem), Vs = Ks + TILE;
  const uint32_t Qs = Vs + TILE;             // [2 stages][64][D]
  const uint32_t dOs = Qs + 2 * TILE;        // [2 stages][64][D]
  const uint32_t vec = dOs + 2 * TILE;       // lse [2][64], delta [2][64]
  const float* lse_s = reinterpret_cast<const float*>(smem + 6 * TILE);
  const float* delta_s = lse_s + 2 * STEP;

  const int h = blockIdx.x, b = blockIdx.y, k0 = blockIdx.z * ROWS;
  const int lane = threadIdx.x & 31, m0 = (threadIdx.x >> 5) * 16;
  const int g = lane >> 2, t = lane & 3;
  const long row = long(H) * D;
  const long qoff = (long(b) * S * H + h) * D;
  const long koff = (long(b) * Sk * H + h) * D;
  const float* lse_b = lse + (long(b) * H + h) * S;
  const float* delta_b = delta + (long(b) * H + h) * S;

  auto stage = [&](int qt, int st) {
    const int q0 = qt * STEP;
    load_tile(Qs + st * TILE, q + qoff, row, q0, S);
    load_tile(dOs + st * TILE, dout + qoff, row, q0, S);
    load_vec(vec + st * STEP * 4, lse_b, q0, S);
    load_vec(vec + (2 + st) * STEP * 4, delta_b, q0, S);
  };

  const int nq = (S + STEP - 1) / STEP;
  // Causal: query tiles wholly above the diagonal see none of these keys.
  const int qt0 = causal ? k0 / STEP : 0;
  load_tile(Ks, k + koff, row, k0, Sk);
  load_tile(Vs, v + koff, row, k0, Sk);
  if (qt0 < nq) stage(qt0, 0);
  cp_commit();

  // The warp's 16 key rows: ka (c0, c1 of every tile) and ka + 8 (c2, c3).
  const int ka = k0 + m0 + g;
  float adk[16][4], adv[16][4];
#pragma unroll
  for (int nt = 0; nt < 16; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) adk[nt][e] = adv[nt][e] = 0.f;

  for (int qt = qt0; qt < nq; ++qt) {
    const int st = (qt - qt0) & 1, q0 = qt * STEP;
    if (qt + 1 < nq) stage(qt + 1, st ^ 1);   // freed by the last sync
    cp_commit();
    cp_wait<1>();                             // this stage has landed
    __syncthreads();

    const uint32_t Qt = Qs + st * TILE, dOt = dOs + st * TILE;
    const float* lse_t = lse_s + st * STEP;
    const float* delta_t = delta_s + st * STEP;
    // The stage's 64 queries in two halves of 32, one after the other
    // (not unrolled into each other), so that S^T and dP^T (16 keys x 32)
    // fit in registers beside the 128 of dK and dV.
#pragma unroll 1
    for (int sub = 0; sub < STEP; sub += 32) {
      float sT[4][4], dpT[4][4];
      score_pair<2>(Ks, Vs, Qt, dOt, m0, sub, lane, sT, dpT);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int ql = sub + 8 * j + 2 * t + e, qi = q0 + ql;
          const float l = lse_t[ql], dl = delta_t[ql];
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const int kj = ka + 8 * hr, x = 2 * hr + e;
            const bool live = qi < S && kj < Sk && (!causal || kj <= qi);
            const float p = live ? expf(sT[j][x] * scale - l) : 0.f;
            dpT[j][x] = p * (dpT[j][x] - dl) * scale;
            sT[j][x] = p;
          }
        }
      uint32_t pa[2][4], sa[2][4];            // P^T, dS^T as bf16 A
      to_a<2>(sT, pa);
      to_a<2>(dpT, sa);
      accumulate<2>(adv, pa, dOt, sub, lane);   // dV += P^T dO
      accumulate<2>(adk, sa, Qt, sub, lane);    // dK += dS^T Q
    }
    __syncthreads();                          // this stage consumed
  }
  cp_wait<0>();

  const long at = koff + ka * row;
  store_rows(dk + at, row, adk, ka < Sk, ka + 8 < Sk, t);
  store_rows(dv + at, row, adv, ka < Sk, ka + 8 < Sk, t);
}

// Grid (H, B, query tiles); query tile z runs 64 (nz - z) keys when
// causal, so the heaviest (last) tiles start first.
__global__ void __launch_bounds__(NT, 2)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v,
                    const bf16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dq,
                    int S, int Sk, int H, float scale, int causal) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t Qs = smem_u32(smem), dOs = Qs + TILE;
  const uint32_t Ks = dOs + TILE;            // [2 stages][64][D]
  const uint32_t Vs = Ks + 2 * TILE;         // [2 stages][64][D]

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * ROWS;
  const int lane = threadIdx.x & 31, m0 = (threadIdx.x >> 5) * 16;
  const int g = lane >> 2, t = lane & 3;
  const long row = long(H) * D;
  const long qoff = (long(b) * S * H + h) * D;
  const long koff = (long(b) * Sk * H + h) * D;

  auto stage = [&](int kt, int st) {
    load_tile(Ks + st * TILE, k + koff, row, kt * STEP, Sk);
    load_tile(Vs + st * TILE, v + koff, row, kt * STEP, Sk);
  };

  int nk = (Sk + STEP - 1) / STEP;
  if (causal) nk = min(nk, (q0 + ROWS - 1) / STEP + 1);   // dead tiles
  load_tile(Qs, q + qoff, row, q0, S);
  load_tile(dOs, dout + qoff, row, q0, S);
  stage(0, 0);
  cp_commit();

  // The warp's 16 query rows: qa (c0, c1 of every tile) and qa + 8.
  const int qa = q0 + m0 + g;
  const long vb = (long(b) * H + h) * S;
  float l[2], dl[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int qi = qa + 8 * hr;
    l[hr] = qi < S ? lse[vb + qi] : 0.f;
    dl[hr] = qi < S ? delta[vb + qi] : 0.f;
  }
  float adq[16][4];
#pragma unroll
  for (int nt = 0; nt < 16; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) adq[nt][e] = 0.f;

  for (int kt = 0; kt < nk; ++kt) {
    const int st = kt & 1, k0 = kt * STEP;
    if (kt + 1 < nk) stage(kt + 1, st ^ 1);   // freed by the last sync
    cp_commit();
    cp_wait<1>();                             // this stage has landed
    __syncthreads();

    const uint32_t Kt = Ks + st * TILE, Vt = Vs + st * TILE;
    float s[8][4], dp[8][4];                  // S, dP: 16 queries x 64
    score_pair<4>(Qs, dOs, Kt, Vt, m0, 0, lane, s, dp);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kj = k0 + 8 * j + 2 * t + e;
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int qi = qa + 8 * hr, x = 2 * hr + e;
          const bool live = qi < S && kj < Sk && (!causal || kj <= qi);
          const float p = live ? expf(s[j][x] * scale - l[hr]) : 0.f;
          dp[j][x] = p * (dp[j][x] - dl[hr]) * scale;
        }
      }
    uint32_t sa[4][4];                        // dS as bf16 A
    to_a<4>(dp, sa);
    accumulate<4>(adq, sa, Kt, 0, lane);      // dQ += dS K
    __syncthreads();                          // this stage consumed
  }
  cp_wait<0>();

  store_rows(dq + qoff + qa * row, row, adq, qa < S, qa + 8 < S, t);
}

constexpr size_t DKV_SMEM = 6 * TILE + 4 * STEP * sizeof(float);
constexpr size_t DQ_SMEM = 6 * TILE;

}  // namespace tc

int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv,
               int B, int S, int Sk, int H, int dtype, int causal,
               float scale, cudaStream_t stream) {
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  cudaError_t err;
  if (dtype == 0) {
    auto kern = scalar::flash_bwd_dkv_f32_kernel;
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               int(scalar::DKV_SMEM));
    if (err != cudaSuccess) return int(err);
    const dim3 grid((Sk + scalar::BK - 1) / scalar::BK, H, B);
    kern<<<grid, scalar::NT, scalar::DKV_SMEM, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), l, dl,
        static_cast<float*>(dk), static_cast<float*>(dv), S, Sk, H, scale,
        causal);
  } else {
    using tc::bf16;
    auto kern = tc::flash_bwd_dkv_kernel;
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               int(tc::DKV_SMEM));
    if (err != cudaSuccess) return int(err);
    const dim3 grid(H, B, (Sk + tc::ROWS - 1) / tc::ROWS);
    kern<<<grid, tc::NT, tc::DKV_SMEM, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const bf16*>(dout), l, dl,
        static_cast<bf16*>(dk), static_cast<bf16*>(dv), S, Sk, H, scale,
        causal);
  }
  return int(cudaGetLastError());
}

int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, int B, int S,
              int Sk, int H, int dtype, int causal, float scale,
              cudaStream_t stream) {
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  cudaError_t err;
  if (dtype == 0) {
    auto kern = scalar::flash_bwd_dq_f32_kernel;
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               int(scalar::DQ_SMEM));
    if (err != cudaSuccess) return int(err);
    const dim3 grid((S + scalar::BQ - 1) / scalar::BQ, H, B);
    kern<<<grid, scalar::NT, scalar::DQ_SMEM, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), l, dl,
        static_cast<float*>(dq), S, Sk, H, scale, causal);
  } else {
    using tc::bf16;
    auto kern = tc::flash_bwd_dq_kernel;
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               int(tc::DQ_SMEM));
    if (err != cudaSuccess) return int(err);
    const dim3 grid(H, B, (S + tc::ROWS - 1) / tc::ROWS);
    kern<<<grid, tc::NT, tc::DQ_SMEM, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const bf16*>(dout), l, dl,
        static_cast<bf16*>(dq), S, Sk, H, scale, causal);
  }
  return int(cudaGetLastError());
}

bool bad_args(int B, int S, int Sk, int H, int d, int dtype) {
  return B < 1 || S < 1 || Sk < 1 || H < 1 || d != D || dtype < 0 ||
         dtype > 1;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; head dim must be 128. q, dout are
// [B, S, H, D] and k, v, dk, dv [B, Sk, H, D], all contiguous and 16-byte
// aligned; lse and delta are [B, H, S] float32. Each returns the launch's
// cudaError_t (0 on success); the caller raises on anything else.
extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, void* dk, void* dv, int B,
                             int S, int Sk, int H, int d, int dtype,
                             int causal, float scale, void* stream) {
  if (bad_args(B, S, Sk, H, d, dtype)) return int(cudaErrorInvalidValue);
  return launch_dkv(q, k, v, dout, lse, delta, dk, dv, B, S, Sk, H, dtype,
                    causal, scale, static_cast<cudaStream_t>(stream));
}

extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, void* dq, int B, int S,
                            int Sk, int H, int d, int dtype, int causal,
                            float scale, void* stream) {
  if (bad_args(B, S, Sk, H, d, dtype)) return int(cudaErrorInvalidValue);
  return launch_dq(q, k, v, dout, lse, delta, dq, B, S, Sk, H, dtype,
                   causal, scale, static_cast<cudaStream_t>(stream));
}

// How many blocks of a kernel fit on one SM at once (registers, shared
// memory, threads), from the CUDA runtime: kernel 0 = B2, 1 = B3; dtype as
// above. Writes the count to *blocks and returns the cudaError_t.
extern "C" int flash_bwd_blocks_per_sm(int kernel, int dtype, int* blocks) {
  const void* fn;
  int threads;
  size_t smem;
  if (dtype == 0) {
    fn = kernel == 0 ? reinterpret_cast<const void*>(
                           scalar::flash_bwd_dkv_f32_kernel)
                     : reinterpret_cast<const void*>(
                           scalar::flash_bwd_dq_f32_kernel);
    threads = scalar::NT;
    smem = kernel == 0 ? scalar::DKV_SMEM : scalar::DQ_SMEM;
  } else {
    fn = kernel == 0
             ? reinterpret_cast<const void*>(tc::flash_bwd_dkv_kernel)
             : reinterpret_cast<const void*>(tc::flash_bwd_dq_kernel);
    threads = tc::NT;
    smem = kernel == 0 ? tc::DKV_SMEM : tc::DQ_SMEM;
  }
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  return int(cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fn,
                                                           threads, smem));
}

extern "C" const char* flash_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
