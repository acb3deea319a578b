// Device helpers shared by the flash-attention kernels' tensor-core
// (bf16) paths: flash_fwd.cu (B1) and flash_bwd.cu (B2, B3).
//
// Tiles are [64][D] bf16 in shared memory, their 16-byte chunks
// XOR-swizzled by row; copies are 16-byte cp.async, zero-filled past the
// tensor's end; operands reach mma.sync.m16n8k16 (bf16 operands, f32
// accumulators) through ldmatrix, .trans where the tile is stored
// [contraction][output]. An m16n8 accumulator pair, packed to bf16, is the
// A fragment of a product that contracts over its columns (to_a), so a
// product's result feeds the next without a trip through shared memory.
//
// Every block that uses these has 4 warps (128 threads), each owning 16
// rows of the block's 64-row tile, at head dim 128.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

using bf16 = __nv_bfloat16;
constexpr int D = 128;               // head dim (the only one instantiated)
constexpr int NW = 4;                // warps per block, 16 rows each
constexpr int NT = NW * 32;          // 128 threads
constexpr int ROWS = NW * 16;        // the block's own tile: 64 rows
constexpr int CH = D / 8;            // 16-byte chunks per row
constexpr int TILE = ROWS * D * 2;   // bytes of one [64][D] bf16 tile

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte chunk c of row r in a [rows][D] bf16 tile, the
// chunk index XORed with the row's low 3 bits: the 8 rows of one ldmatrix
// matrix land on 8 different bank groups.
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return uint32_t(r * D + ((c ^ (r & 7)) << 3)) * 2u;
}

// 16 bytes from global to shared memory, asynchronously; zeros when
// `full` is false (src must still be a valid address).
__device__ __forceinline__ void cp16(uint32_t dst, const void* src,
                                     bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(full ? 16 : 0));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N of this thread's copy groups are in flight.
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Rows [r0, r0 + 64) of one head of a [B, n, H, D] bf16 tensor (base at
// batch b, head h; `row` = H * D) into a swizzled tile; zeros past n.
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* base,
                                          long row, int r0, int n) {
#pragma unroll
  for (int j = 0; j < ROWS * CH / NT; ++j) {
    const int i = threadIdx.x + j * NT;
    const int r = i / CH, c = i % CH, s = r0 + r;
    const bool in = s < n;
    cp16(dst + swz(r, c), base + (in ? s * row : 0) + c * 8, in);
  }
}

__device__ __forceinline__ void ldsm(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 "
               "{%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
               "{%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c += a . b for one m16n8k16 tile: bf16 operands, f32 accumulators.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 rounded to bf16 (round to nearest even), lo in the low half.
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The m16n8 accumulators x[2kq], x[2kq + 1] rounded to bf16: the A
// fragment of k-step kq of a product that contracts over x's columns.
template <int NP>
__device__ __forceinline__ void to_a(const float (&x)[2 * NP][4],
                                     uint32_t (&a)[NP][4]) {
#pragma unroll
  for (int kq = 0; kq < NP; ++kq) {
    a[kq][0] = pack(x[2 * kq][0], x[2 * kq][1]);
    a[kq][1] = pack(x[2 * kq][2], x[2 * kq][3]);
    a[kq][2] = pack(x[2 * kq + 1][0], x[2 * kq + 1][1]);
    a[kq][3] = pack(x[2 * kq + 1][2], x[2 * kq + 1][3]);
  }
}

// acc[nt] += A . T[k0, k0 + 16 NP)[8nt, 8nt + 8): A the warp's 16 x 16 NP
// bf16 A fragments, T a swizzled [64][D] tile stored
// [contraction][output], read through ldmatrix.trans.
template <int NP>
__device__ __forceinline__ void accumulate(float (&acc)[16][4],
                                           const uint32_t (&a)[NP][4],
                                           uint32_t t, int k0, int lane) {
#pragma unroll
  for (int kq = 0; kq < NP; ++kq)
#pragma unroll
    for (int np = 0; np < 8; ++np) {
      // matrices (k 0-7, n 0-7), (k 8-15, n 0-7), (k 0-7, n 8-15),
      // (k 8-15, n 8-15): b0, b1 of n-tile 2np, then of 2np + 1.
      uint32_t fb[4];
      ldsm_t(t + swz(k0 + 16 * kq + (lane & 7) + (((lane >> 3) & 1) << 3),
                     2 * np + (lane >> 4)), fb);
      mma(acc[2 * np], a[kq], fb[0], fb[1]);
      mma(acc[2 * np + 1], a[kq], fb[2], fb[3]);
    }
}

// Rows r and r + 8 of the warp's 16 x D accumulator, rounded to bf16,
// into rows at out (row r) and out + 8 * row, where in range.
__device__ __forceinline__ void store_rows(bf16* out, long row,
                                           const float (&acc)[16][4],
                                           bool lo, bool hi, int t) {
#pragma unroll
  for (int nt = 0; nt < 16; ++nt) {
    const int c = 8 * nt + 2 * t;
    if (lo)
      *reinterpret_cast<uint32_t*>(out + c) = pack(acc[nt][0], acc[nt][1]);
    if (hi)
      *reinterpret_cast<uint32_t*>(out + 8 * row + c) =
          pack(acc[nt][2], acc[nt][3]);
  }
}

}  // namespace hopper
