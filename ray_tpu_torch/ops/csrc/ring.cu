// Ring collectives C1-C6 for Hopper (sm_90a), over a ring of n virtual
// ranks on one card.
//
// Replace the TPU kernels of ray_tpu/util/collective/pallas/ring.py:
//   C1 ring_permute_kernel        <- _permute_kernel        (_permute_block)
//   C2 ring_reduce_scatter_kernel <- _reduce_scatter_kernel (_reduce_scatter_block)
//   C3 ring_allgather_kernel      <- _allgather_kernel      (_allgather_block)
//   C4 ring_allreduce_kernel      <- _allreduce_kernel      (_allreduce_block)
// and of ray_tpu/util/collective/pallas/quantized.py (the int8 ring):
//   C5 ring_qhop_kernel           <- _qhop_kernel           (_qhop_block)
//   C6 ring_qallreduce_kernel     <- _qar_kernel            (_qar_block)
//
// Each rank's data is one row of a rank-major tensor: rank r's block starts
// at base + r * rank_stride and holds rows of 128 lanes, the reference's
// (rows, 128) per-device layout. The kernel body is written per rank
// against a table of per-rank pointers (input, output, comm slots, flags).
// Two transports fill that table: one launch plays all n ranks in one
// process (ring_launch, below), or each rank is a process of its own that
// launches only its rank's blocks against its peers' buffers opened
// through CUDA IPC (the rank form, ring_rank_launch, for C2, C3, C4 and
// C6; see its section).
//
// Design.
//   - Grid (blocks_per_rank, n): block (b, r) plays rank r and owns the
//     fixed range b of every chunk, so a block only ever talks to blocks b
//     of other ranks (in the ring kinds only to (b, r +- 1)); no barrier
//     spans the grid.
//   - One hop t of the int8 ring (C5, C6), per block (the reference's
//     _send_recv / _cap_wait / _cap_signal, ring.py:78-104):
//       1. t >= 2: acquire-wait on the capacity flag of slot t % 2 (the
//          right neighbour drained that slot at hop t - 2);
//       2. store its range of the send chunk into the right neighbour's
//          comm slot t % 2 (a peer store through the pointer table);
//       3. __threadfence, then a release store of the neighbour's receive
//          flag;
//       4. acquire-spin on its own receive flag;
//       5. combine the slot into its own range of the output (slot reads
//          bypass L1: another SM wrote them);
//       6. release the capacity flag of that slot to the left neighbour
//          (not after the last two hops, whose slots are not reused in
//          this call; the next call is ordered after this one on the
//          stream).
//     The reference compiles the capacity handshake out in interpret mode;
//     here it always runs. C1 is one hop with no slots: it stores straight
//     into the right neighbour's output and runs steps 3-4.
//   - Flags are epochs: hop t of a call with base B writes B + t + 1, with
//     B = seq * total_hops from the group's per-kind call counter, so flags
//     grow monotonically and are never reset between calls.
//   - The schedule is the reference's index arithmetic (my +- t mod n), so
//     every element is combined in the plain version's order. Combine is
//     sum / max / min / prod in f32, rounded once per step to the element
//     type: bit for bit what torch does for `a + b` on two bf16 or f16
//     tensors. int32 combines in 32-bit integer arithmetic, sum and prod
//     wrapping as torch's do, so it is exact in any order.
//   - All n * blocks_per_rank blocks must be resident at once, or a
//     spinning block waits for one that never runs: the grid is capped
//     from cudaOccupancyMaxActiveBlocksPerMultiprocessor and launched with
//     cudaLaunchCooperativeKernel, which refuses a grid that cannot be
//     resident. Every spin is bounded (about one second of clock64); on
//     timeout the block writes an error record to pinned host memory and
//     exits, its neighbours then time out in turn, and the wrapper raises.
//   - C2, C3 and C4 are no rings of hops: one card needs no ring to get
//     the ring's bits. Each is one pass and one flag round, with no comm
//     slots. Completion is explicit (it tells a rank that its peers have
//     stored into its output and read its input; in the rank form the
//     host's done round on the stream says it): after its stores the
//     block fences and arrives on the receive word of block b of each
//     other rank, then waits (bounded) until all n - 1 have arrived on its
//     own. n - 1 senders share one word, so it counts arrivals under the
//     call's epoch tag, (tag << 32) | arrivals (see arrive). The epoch is
//     base + 1.
//   - C3: a copy needs no combine order, so block (b, r) reads its range
//     of rank r's input once and stores it at r * chunk of every rank's
//     output, its own included (a peer store through the pointer table, as
//     C1's).
//   - C4: one ordered reduce, pushed to every rank. The reference's two
//     sweeps leave chunk c on every rank as the fold acc = x_c[c], then
//     acc = T(combine(x_{c+j}[c], acc)) for j = 1 .. n - 1 (the receiving
//     rank's own element first, as _rs_hop combines), rounded to T after
//     every step, and the allgather sweep copies it exactly. Block (b, r)
//     loads range b of chunk r from in[r], in[r + 1], .., in[r - 1]
//     through the pointer table, folds in that order in registers, and
//     stores the result at chunk r of every rank's output.
//   - C2: one ordered reduce, stored once. The reference's shifted
//     schedule (hop t: rank r sends chunk r - t - 1 and combines into
//     chunk r - t - 2, ring.py:183-195) leaves chunk c on rank c as C4's
//     fold started one rank later: acc = x_{c+1}[c], then acc =
//     T(combine(x_{c+j}[c], acc)) for j = 2 .. n, ending with the owner's
//     own element. Block (b, r) loads range b of chunk r from in[r + 1],
//     in[r + 2], .., in[r], folds in that order in registers, and stores
//     the result once, at out[r]. The input is read, never written.
//
// Bound on the H100: bytes. Each kernel moves (reads + writes) its input
// once and its output once at least, at 3.35 TB/s; the ring's n - 1 (C1:
// 1) hops through the slots move more than that. C2's, C3's and C4's loads
// and stores touch exactly the bound's bytes: each input element is read
// once and each output element written once. With C one bf16 chunk at the
// ZeRO size (4 ranks of 15,024,416 rows of 128, C = 961.6 MB a chunk):
// C2 n + 1 chunks a rank, 5C, 19.23 GB a call, where the n - 1 accumulate
// hops through the slots counted 15C a rank (each hop read the send
// range, wrote it to the neighbour's slot, read cur and the slot and
// wrote dst: 5C), 57.7 GB. C3: n (1 + n) chunks in all; at 4 ranks of
// 3,756,104 rows of 128 bf16 that counts 3.846 GB read and 15.386 GB
// written, 19.23 GB, where n - 1 copy hops through the slots count 53.85
// GB. C4: 2n chunks a rank, 8C, 30.77 GB, where the two sweeps through
// the slots counted 35C a rank (the copy of in to out 8C, a
// reduce-scatter hop 5C, an allgather hop 4C), 134.6 GB. (Counts from the
// code; the card's DRAM traffic is not measured.) Across cards on NVLink
// a push costs each rank the same link bytes as a ring: C2 and C3 n - 1
// chunks, C4 2(n - 1) (n - 1 chunks of peer loads, n - 1 of peer stores),
// in one round instead of n - 1 or 2(n - 1). The copies are 16-byte
// vectors, neighbouring threads on neighbouring addresses.
//
// Types: float32, bfloat16, float16 and int32, the reference's float and
// int blocks (C5, C6: float32 only, as the reference feeds them). The
// wrapper refuses anything else.
//
// The int8 ring (C5, C6). Every hop quantizes the outgoing f32 chunk to
// int8 with ONE scale, max|chunk| / 127 floored at 1e-30, over the whole
// chunk (quantized.py:43-46), sends the payload and the scale, and the
// receiver dequantizes: C6's reduce-scatter sweep accumulates
// (__fmaf_rn(q, scale, acc): one rounding, what the reference computes),
// its allgather sweep and C5's standalone form overwrite (q * scale), and
// C5's in-place form adds (cur + q * scale rounded twice, __fmul_rn then
// __fadd_rn: the port's plain split-phase hop is C5's function followed by
// a tensor add, and a contracted FMA would give other bits). The scale is
// a max over a chunk that bpr blocks share, so a quantizing hop whose max
// no hop before took starts with a per-rank barrier inside the
// cooperative launch:
//   - each block reduces max|x| over its range (as the bits of |x|, which
//     order like the floats and carry a NaN through);
//   - thread 0 publishes it with a 64-bit atomicMax on the rank's word of
//     hop parity t % 2, tagged with the hop's epoch in the high half (a
//     newer epoch always wins, so the words are never reset), fences, and
//     arrives on the rank's counter: every block adds 1 and block 0 adds
//     MAX_BPR - bpr more, so hop t of a call with base B is complete when
//     the counter reaches (B + t + 1) * MAX_BPR whatever bpr each call had;
//   - it spins (bounded, reported like the flags) until then, and reads the
//     word. The word of parity t % 2 is rewritten at hop t + 2 only after
//     every block of the rank has passed hop t + 1's barrier, so after it
//     has read hop t's. Max is exact and order-free: the scale is
//     deterministic.
// Each sending block stores its int8 range into the right neighbour's slot
// and its own copy of the scale into a per-block scale slot beside it, so
// the receiving block (b, right) needs no second barrier. Quantize as
// _quantize: IEEE x / scale (__fdiv_rn), rintf (half to even), clamp to
// +-127. Slots per rank: 2 x chunk int8 payloads, then 2 x MAX_BPR f32
// scales. A block's range is counted in groups of 16 elements; each thread
// turns one float4 into one 32-bit word of four codes, so a warp reads 512
// contiguous bytes of f32 and writes 128 of int8 (the dequantize mirrors
// it), with four float4 in flight per thread.
// C6 reads each send chunk once. In C6's schedule the send chunk of every
// hop but the first is the chunk this block received into at the hop
// before (reduce-scatter: send r - s - 1 = recv r - (s - 1) - 1; the first
// allgather send r + 1 is the last reduce-scatter recv; allgather: send
// r - s = recv r - (s - 1)), so the block takes the next hop's max of its
// range while it dequantizes, in registers, and publishes it at the next
// hop's barrier, as before, without reading the chunk again. Only hop 0
// has a max pass of its own. out needs no copy of in: the reduce-scatter
// sweep accumulates into each received chunk once, reading it from in and
// writing it to out, and every chunk of out is written by the end (chunk
// r + 1 by the last reduce-scatter hop, the others by the allgather
// sweep). Per rank, in f32 chunks C: hop 0 reads C (max) + C (quantize),
// writes C / 4 and reads C / 4 (payload), reads C and writes C (the
// accumulate): 4.5C; each later reduce-scatter hop 3.5C; each allgather
// hop 2.5C. At n = 4: 19C a rank, where reading each send chunk twice
// counted 24C in place, and the copy of in to out 8C more (counts from
// the code).
// C5 has two forms, each one hop and one launch. The standalone form (the
// reference's _qhop_kernel) has no hop before it: a max pass, then the
// hop, out[right] = dequant(quant(in[r])), 3.5C. The in-place form is hop
// t of the split-phase int8 reduce-scatter (the reference's _qrs_hop) on
// the rank-major buffer of n chunks a rank: rank r quantizes its chunk
// r - t - 1 and adds what arrives onto its chunk r - t - 2, reading both
// where they lie (the chunk indices come from t and r, as C2's and C6's).
// Hop t + 1 sends r - t - 2, the chunk hop t wrote, so hop t takes the max
// of what it writes, in registers, and folds it with a 64-bit atomicMax
// into the rank's word of a carry table [n - 1][n] that the wrapper zeroes
// on the stream before each reduce-scatter's hop 0 (two in flight on one
// stream keep two tables): row t + 1, tagged t + 1 in the high half. Hop
// t + 1 is the next launch of that reduce-scatter on the same stream, so
// the word is complete when it starts, and it takes its scale from the
// word with no max pass and no wait at the barrier (it still arrives
// there, which keeps the kind's arrival count in step with its epochs). A
// word not tagged t + 1 (not filled since hop 0 zeroed the table, or
// another hop's) is reported as a fault, never replaced by a max pass.
// Only hop 0 takes a max pass and waits at the barrier. Per
// rank: hop 0 reads C (max) + C (send),
// writes C / 4 and reads C / 4 (payload), reads C and writes C (cur, dst):
// 4.5C; each later hop 3.5C, where the bound is 3C (send, cur, dst; the
// int8 slot's 0.5C is the wire format's price). The split-phase hop it
// replaces, tensor ops around the standalone form, moved about 12.5C: a
// gather of the send chunks (2C), the standalone form (3.5C), a gather of
// cur (2C), the add (3C) and the index-put back (2C) (counts from the
// code).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC -lcuda (ray_tpu_torch/ops/_build.py does this;
//        -lcuda for the rank form's stream memory operations).

#include <algorithm>
#include <cstring>
#include <mutex>
#include <type_traits>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int MAX_RANKS = 16;
constexpr int MAX_BPR = 1024;          // blocks per rank (flag table size)
constexpr int NT = 256;                // threads per block
constexpr long long MIN_VECS_PER_BLOCK = 4 * NT;
constexpr long long SPIN_TIMEOUT_CYCLES = 2000000000LL;   // ~1 s

constexpr int FLAG_SECTIONS = 3;       // receive, capacity, barrier words
constexpr int QGROUP = 16;             // elements per int8 vector
constexpr float QMAX = 127.0f;
constexpr float SCALE_FLOOR = 1e-30f;

enum Kind {
  PERMUTE = 0, REDUCE_SCATTER = 1, ALLGATHER = 2, ALLREDUCE = 3, QHOP = 4,
  QALLREDUCE = 5, QRS_HOP = 6           // QRS_HOP: C5's in-place form
};
enum Op { SUM = 0, MAX = 1, MIN = 2, PROD = 3 };
// What a stopped block waited for (RingGroup's _WAITS names them):
// WAIT_CARRY is no wait but a carried max that is missing (not tagged
// with the reading hop).
enum Wait { WAIT_RECV, WAIT_CAP, WAIT_BARRIER, WAIT_ARRIVALS, WAIT_CARRY };

typedef unsigned long long u64;

struct RingArgs {
  char* in[MAX_RANKS];        // per-rank input (C5 in place: the buffer)
  char* out[MAX_RANKS];       // per-rank output
  char* slot[MAX_RANKS];      // per-rank comm slots (C5, C6)
  u64* recv[MAX_RANKS];       // per-rank receive flags [MAX_BPR][2] (C3:
                              // [b][0] counts arrivals under the epoch tag)
  u64* cap[MAX_RANKS];        // per-rank capacity flags [MAX_BPR][2]
  u64* bar[MAX_RANKS];        // per-rank barrier words (C5, C6): arrivals,
                              // then the max word of each hop parity
  float* scale[MAX_RANKS];    // per-rank scale slots [2][MAX_BPR] (C5, C6)
  u64* carry;                 // C5 in place: the carried maxes [n - 1][n]
  long long chunk_vecs;       // 16-byte vectors per chunk (one hop's payload;
                              // C5, C6: groups of 16 elements)
  u64 base;                   // hop t's epoch is base + t + 1
  int hop;                    // C5 in place: the reduce-scatter's hop t
  int* err_dev;               // elects the first block to report
  long long* err_host;        // pinned host record: set, kind, rank, block,
                              // hop, what, wanted, seen
  int n, bpr, kind;
  int rank0;                  // the rank of blockIdx.y == 0 (see rank form)
  int per_rank;               // 1: one rank's launch in its own process
  const u64* poison;          // the rank form: this rank's poison word
                              // (nullptr in one process; see poisoned)
};

__device__ __forceinline__ int mod(int a, int n) { return ((a % n) + n) % n; }
// The rank after r on a ring of n.
__device__ __forceinline__ int succ(int r, int n) {
  return r + 1 == n ? 0 : r + 1;
}

__device__ __forceinline__ void st_release(u64* p, u64 v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ u64 ld_acquire(const u64* p) {
  u64 v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

// The rank form: whether this rank's call is void. A rank whose wait
// expired writes its poison word (and its peers') before it releases its
// stream, so a launch that runs after that stores nothing into another
// rank's memory; the host then raises (process_ring.py).
__device__ __forceinline__ bool poisoned(const RingArgs& a) {
  return a.poison != nullptr && ld_acquire(a.poison) != 0;
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <> __device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half_rn(x);
}

template <int OP> __device__ __forceinline__ float combine(float a, float b) {
  if (OP == SUM) return a + b;
  if (OP == PROD) return a * b;
  // NaN propagates, as in torch.maximum / torch.minimum.
  if (a != a) return a;
  if (b != b) return b;
  if (OP == MAX) return a > b ? a : b;
  return a < b ? a : b;
}

// int32: sum and prod wrap modulo 2^32 (unsigned arithmetic), as torch's.
template <int OP> __device__ __forceinline__ int combine_int(int a, int b) {
  if (OP == SUM) return int(unsigned(a) + unsigned(b));
  if (OP == PROD) return int(unsigned(a) * unsigned(b));
  if (OP == MAX) return a > b ? a : b;
  return a < b ? a : b;
}

template <typename T, int OP>
__device__ __forceinline__ uint4 combine_vec(uint4 a, uint4 b) {
  T* pa = reinterpret_cast<T*>(&a);
  const T* pb = reinterpret_cast<const T*>(&b);
#pragma unroll
  for (int i = 0; i < int(sizeof(uint4) / sizeof(T)); ++i) {
    if constexpr (std::is_same<T, int>::value)
      pa[i] = combine_int<OP>(pa[i], pb[i]);
    else
      pa[i] = from_f<T>(combine<OP>(to_f(pa[i]), to_f(pb[i])));
  }
  return a;
}

// Thread 0 records the first timeout of the launch in pinned host memory.
__device__ void report(const RingArgs& a, int r, int b, int t, int what,
                       u64 want, u64 seen) {
  if (atomicCAS(a.err_dev, 0, 1) != 0) return;
  volatile long long* h = a.err_host;
  h[1] = a.kind;
  h[2] = r;
  h[3] = b;
  h[4] = t;
  h[5] = what;
  h[6] = static_cast<long long>(want);
  h[7] = static_cast<long long>(seen);
  __threadfence_system();
  h[0] = 1;
  __threadfence_system();
}

// Thread 0 acquire-spins until *flag >= want, bounded by the timeout; the
// whole block learns the outcome at the barrier. False: the block exits.
// A WAIT_ARRIVALS flag is a tagged counter (see arrive): a timeout reports
// the arrivals wanted and those of this call seen, not the raw words.
__device__ bool wait_flag(const RingArgs& a, const u64* flag, u64 want, int r,
                          int b, int t, int what) {
  int ok = 1;
  if (threadIdx.x == 0) {
    const long long t0 = clock64();
    u64 seen;
    while ((seen = ld_acquire(flag)) < want) {
      if (clock64() - t0 > SPIN_TIMEOUT_CYCLES) {
        if (what == WAIT_ARRIVALS)
          report(a, r, b, t, what, want & 0xffffffffull,
                 (seen >> 32) == (want >> 32) ? seen & 0xffffffffull : 0);
        else
          report(a, r, b, t, what, want, seen);
        ok = 0;
        break;
      }
      __nanosleep(64);
    }
  }
  return __syncthreads_and(ok) != 0;
}

// Every thread's stores are ordered before thread 0's release of the flag.
__device__ __forceinline__ void signal_flag(u64* flag, u64 value) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) st_release(flag, value);
}

struct Block {
  int r, b, n, right, left;
  long long lo, hi;           // this block's vector range within a chunk
};

__device__ __forceinline__ Block block_of(const RingArgs& a) {
  Block k;
  k.b = blockIdx.x;
  k.r = a.rank0 + blockIdx.y;
  k.n = a.n;
  k.right = k.r + 1 == a.n ? 0 : k.r + 1;
  k.left = k.r == 0 ? a.n - 1 : k.r - 1;
  const long long per = (a.chunk_vecs + a.bpr - 1) / a.bpr;
  k.lo = min(a.chunk_vecs, per * k.b);
  k.hi = min(a.chunk_vecs, k.lo + per);
  return k;
}

__device__ __forceinline__ int flag_index(int b, int slot) {
  return b * 2 + slot;
}

// st(i, ld(i)) for this thread's share of [lo, hi), in units of what ld
// returns (a 16-byte vector, a float4, ...): four loaded before any is
// stored, so each thread keeps four loads in flight.
template <typename Ld, typename St>
__device__ __forceinline__ void each_vec(long long lo, long long hi, Ld ld,
                                         St st) {
  long long i = lo + threadIdx.x;
  for (; i + 3 * NT < hi; i += 4 * NT) {
    const auto v0 = ld(i), v1 = ld(i + NT), v2 = ld(i + 2 * NT),
               v3 = ld(i + 3 * NT);
    st(i, v0);
    st(i + NT, v1);
    st(i + 2 * NT, v2);
    st(i + 3 * NT, v3);
  }
  for (; i < hi; i += NT) st(i, ld(i));
}

// Step 4: wait until the left neighbour's hop-t payload is in our slot.
__device__ __forceinline__ bool hop_recv(const RingArgs& a, const Block& k,
                                         int t) {
  return wait_flag(a, a.recv[k.r] + flag_index(k.b, t & 1), a.base + t + 1,
                   k.r, k.b, t, WAIT_RECV);
}

// Step 6: the slot is drained; the left neighbour may refill it at t + 2.
__device__ __forceinline__ void hop_release(const RingArgs& a, const Block& k,
                                            int t, int total) {
  if (t < total - 2)
    signal_flag(a.cap[k.left] + flag_index(k.b, t & 1), a.base + t + 1);
}

// C1: one hop of the whole block, straight into the right neighbour's
// output (no slots): out[right] = in[r].
template <typename T>
__global__ void __launch_bounds__(NT)
ring_permute_kernel(const __grid_constant__ RingArgs a) {
  const Block k = block_of(a);
  const uint4* src = reinterpret_cast<const uint4*>(a.in[k.r]);
  uint4* dst = reinterpret_cast<uint4*>(a.out[k.right]);
  each_vec(k.lo, k.hi, [&](long long i) { return src[i]; },
           [&](long long i, uint4 v) { __stcg(dst + i, v); });
  signal_flag(a.recv[k.right] + flag_index(k.b, 0), a.base + 1);
  hop_recv(a, k, 0);
}

// An arrival on a counter word tagged with the call's epoch, (tag << 32) |
// arrivals: the max moves a word of an older call to (tag << 32) and is a
// no-op once the word carries this tag, so the word counts this call's
// arrivals however many calls had a block b. Never reset. The fence
// orders the block's stores, seen at the barrier before it, ahead of the
// arrival.
__device__ __forceinline__ void arrive(u64* word, u64 tag) {
  __threadfence();
  atomicMax(reinterpret_cast<unsigned long long*>(word), tag << 32);
  atomicAdd(reinterpret_cast<unsigned long long*>(word), 1ull);
}

// After a push: fence the block's stores, arrive on the receive word of
// block b of each of the n - 1 other ranks, and wait until all n - 1 have
// arrived on its own. One flag round per call, epoch base + 1.
__device__ void push_done(const RingArgs& a, const Block& k) {
  const u64 tag = (a.base + 1) & 0xffffffffull;
  __threadfence();
  __syncthreads();
  const int p = threadIdx.x;
  if (p < k.n && p != k.r) arrive(a.recv[p] + flag_index(k.b, 0), tag);
  wait_flag(a, a.recv[k.r] + flag_index(k.b, 0), (tag << 32) | (k.n - 1),
            k.r, k.b, 0, WAIT_ARRIVALS);
}

// C3: one read, n writes. Block (b, r) reads its range of in[r] once and
// stores each vector at r * chunk of every rank's output, its own
// included (peer stores through the pointer table, as C1's), then
// push_done: out[r] = (in[0], ..., in[n-1]).
template <typename T>
__global__ void __launch_bounds__(NT)
ring_allgather_kernel(const __grid_constant__ RingArgs a) {
  if (poisoned(a)) return;
  const Block k = block_of(a);
  const uint4* in = reinterpret_cast<const uint4*>(a.in[k.r]);
  const long long at = k.r * a.chunk_vecs;
  each_vec(k.lo, k.hi, [&](long long i) { return in[i]; },
           [&](long long i, uint4 v) {
             for (int j = 0, p = k.r; j < k.n; ++j, p = succ(p, k.n))
               __stcs(reinterpret_cast<uint4*>(a.out[p]) + at + i, v);
           });
  if (!a.per_rank) push_done(a, k);
}

// Fold U vectors i, i + NT, ... of chunk r (at: its offset) over the n
// inputs from rank `first` on: acc = in[first], then acc =
// T(combine(in[p], acc)) for p = first + 1, .., first - 1 (C4: first = r;
// C2: first = r + 1, so the fold ends with the owner's own element). Then
// C4 stores acc at chunk r of every rank's output, C2 once at out[r]. The
// next rank's U loads are issued before the current rank's combines, so
// 2U loads are in flight a thread (64-80 registers, 3-4 blocks a SM; U
// loads in flight and 40 registers left C4's f32 instantiations spilling).
template <typename T, int OP, bool PUSH, int U>
__device__ __forceinline__ void fold_store(const RingArgs& a, const Block& k,
                                           long long at, long long i) {
  const auto from = [&](int p) {
    return reinterpret_cast<const uint4*>(a.in[p]) + at + i;
  };
  const int first = PUSH ? k.r : succ(k.r, k.n);
  uint4 acc[U], v[U];
  int p = succ(first, k.n);
#pragma unroll
  for (int u = 0; u < U; ++u) {
    acc[u] = from(first)[u * NT];
    v[u] = from(p)[u * NT];
  }
  for (;;) {
    const int q = succ(p, k.n);
    uint4 w[U];
    if (q != first) {
#pragma unroll
      for (int u = 0; u < U; ++u) w[u] = from(q)[u * NT];
    }
#pragma unroll
    for (int u = 0; u < U; ++u) acc[u] = combine_vec<T, OP>(v[u], acc[u]);
    if (q == first) break;
#pragma unroll
    for (int u = 0; u < U; ++u) v[u] = w[u];
    p = q;
  }
  if constexpr (PUSH) {
    for (int j = 0, o = k.r; j < k.n; ++j, o = succ(o, k.n)) {
      uint4* y = reinterpret_cast<uint4*>(a.out[o]) + at + i;
#pragma unroll
      for (int u = 0; u < U; ++u) __stcs(y + u * NT, acc[u]);
    }
  } else {
    uint4* y = reinterpret_cast<uint4*>(a.out[k.r]) + i;
#pragma unroll
    for (int u = 0; u < U; ++u) __stcs(y + u * NT, acc[u]);
  }
}

// Block (b, r) folds range b of chunk r over the n inputs in the
// reference's order (see the header) and stores it (fold_store), then
// push_done (in one process; the rank form's completion is the host's).
template <typename T, int OP, bool PUSH>
__device__ __forceinline__ void fold_range(const RingArgs& a) {
  if (poisoned(a)) return;
  const Block k = block_of(a);
  const long long at = k.r * a.chunk_vecs;
  long long i = k.lo + threadIdx.x;
  for (; i + 3 * NT < k.hi; i += 4 * NT)
    fold_store<T, OP, PUSH, 4>(a, k, at, i);
  for (; i < k.hi; i += NT) fold_store<T, OP, PUSH, 1>(a, k, at, i);
  if (!a.per_rank) push_done(a, k);
}

// C2: one ordered reduce, stored once: out[r] = chunk r reduced in the
// reference's shifted order, from in[r + 1] to in[r].
template <typename T, int OP>
__global__ void __launch_bounds__(NT)
ring_reduce_scatter_kernel(const __grid_constant__ RingArgs a) {
  fold_range<T, OP, false>(a);
}

// C4: one ordered reduce, pushed to every rank: chunk r of every output =
// chunk r reduced from in[r] to in[r - 1].
template <typename T, int OP>
__global__ void __launch_bounds__(NT)
ring_allreduce_kernel(const __grid_constant__ RingArgs a) {
  fold_range<T, OP, true>(a);
}

// ---------------------------------------------------------------------------
// The int8 ring: C5 and C6 (float32 only).
// ---------------------------------------------------------------------------

constexpr int F4 = QGROUP / 4;         // float4 (and int8 words) per group

// max |x| over the four lanes of v, as the bits of |x| (they order like
// the floats, and a NaN's exceed every number's).
__device__ __forceinline__ unsigned abs_bits(float4 v) {
  return max(max(__float_as_uint(fabsf(v.x)), __float_as_uint(fabsf(v.y))),
             max(__float_as_uint(fabsf(v.z)), __float_as_uint(fabsf(v.w))));
}

// max |x| over this thread's float4s of [lo, hi) of src, as bits.
__device__ unsigned thread_absmax_bits(const float4* src, long long lo,
                                       long long hi) {
  unsigned m = 0;
  each_vec(lo, hi, [&](long long i) { return src[i]; },
           [&](long long, float4 v) { m = max(m, abs_bits(v)); });
  return m;
}

// The scale of a chunk whose max |x| has the bits m: max / 127 floored at
// 1e-30; a NaN max stays NaN, as jnp.maximum keeps it.
__device__ __forceinline__ float scale_of(unsigned m) {
  const float s = __fdiv_rn(__uint_as_float(m), QMAX);
  return s < SCALE_FLOOR ? SCALE_FLOOR : s;
}

// The threads' maxes m reduced over the block, in thread 0 (the other
// threads get their warp's).
__device__ __forceinline__ unsigned block_max(unsigned m) {
  __shared__ unsigned warp_max[NT / 32];
  m = __reduce_max_sync(0xffffffffu, m);
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0)
    for (int w = 1; w < NT / 32; ++w) m = max(m, warp_max[w]);
  return m;
}

// Thread 0's arrival at its rank's barrier counter for one flag round:
// every block adds 1 and block 0 MAX_BPR - bpr more, so round e of the
// kind's table is complete at e * MAX_BPR whatever bpr each launch had.
// The count stays in step with the epochs only if every launch of the
// kind arrives once per round, so C5's carried hops arrive too, without
// waiting.
__device__ __forceinline__ void arrive_barrier(const RingArgs& a,
                                               const Block& k) {
  atomicAdd(reinterpret_cast<unsigned long long*>(a.bar[k.r]),
            static_cast<unsigned long long>(k.b == 0 ? MAX_BPR - a.bpr + 1
                                                     : 1));
}

// The per-rank barrier of hop t: reduce the threads' maxes m over the
// block, publish it, wait for every block of the rank, read the rank's max
// and turn it into the scale. False: the block exits.
__device__ bool rank_scale(const RingArgs& a, const Block& k, int t,
                           unsigned m, float* scale) {
  __shared__ float s_scale;
  const unsigned bits = block_max(m);
  int ok = 1;
  if (threadIdx.x == 0) {
    u64* bar = a.bar[k.r];
    u64* word = bar + 1 + (t & 1);
    const u64 epoch = a.base + t + 1;
    const u64 tag = epoch & 0xffffffffull;
    atomicMax(reinterpret_cast<unsigned long long*>(word), (tag << 32) | bits);
    __threadfence();
    arrive_barrier(a, k);
    const u64 want = epoch * MAX_BPR;
    const long long t0 = clock64();
    u64 seen;
    while ((seen = ld_acquire(bar)) < want) {
      if (clock64() - t0 > SPIN_TIMEOUT_CYCLES) {
        report(a, k.r, k.b, t, WAIT_BARRIER, want, seen);
        ok = 0;
        break;
      }
      __nanosleep(64);
    }
    if (ok) {
      const u64 w = ld_acquire(word);
      if ((w >> 32) != tag) {
        report(a, k.r, k.b, t, WAIT_BARRIER, tag, w >> 32);
        ok = 0;
      }
      s_scale = scale_of(static_cast<unsigned>(w));
    }
  }
  if (!__syncthreads_and(ok)) return false;
  *scale = s_scale;
  return true;
}

// C5 in place, hop t > 0: the scale from the max that hop t - 1 folded
// into carry[t][r] as it wrote this hop's send chunk (the launch before on
// this stream, so the word is complete): no max pass, and an arrival at
// the barrier with no wait. Every thread reads the word; one not tagged t
// (not filled since hop 0's wrapper zeroed the table, or another hop's) is
// reported and the block exits.
__device__ bool carried_scale(const RingArgs& a, const Block& k, int t,
                              float* scale) {
  if (threadIdx.x == 0) arrive_barrier(a, k);
  const u64 w = __ldcg(a.carry + size_t(t) * k.n + k.r);
  if ((w >> 32) != u64(t)) {
    if (threadIdx.x == 0) report(a, k.r, k.b, t, WAIT_CARRY, t, w >> 32);
    return false;
  }
  *scale = scale_of(static_cast<unsigned>(w));
  return true;
}

// C5 in place: fold the block's max of what hop t - 1 wrote (the threads'
// m) into carry[t][r], tagged t, for hop t.
__device__ void carry_max(const RingArgs& a, const Block& k, int t,
                          unsigned m) {
  m = block_max(m);
  if (threadIdx.x == 0)
    atomicMax(reinterpret_cast<unsigned long long*>(a.carry) +
                  size_t(t) * k.n + k.r,
              (u64(t) << 32) | m);
}

__device__ __forceinline__ unsigned quantize1(float x, float scale) {
  const float r = rintf(__fdiv_rn(x, scale));
  return static_cast<unsigned>(static_cast<int>(fminf(fmaxf(r, -QMAX), QMAX))) &
         0xffu;
}

// Four f32 elements -> four int8 codes in one 32-bit word, lane i in byte i.
__device__ __forceinline__ unsigned quantize4(float4 v, float scale) {
  return quantize1(v.x, scale) | (quantize1(v.y, scale) << 8) |
         (quantize1(v.z, scale) << 16) | (quantize1(v.w, scale) << 24);
}

__device__ __forceinline__ float code(unsigned w, int i) {
  return static_cast<float>(static_cast<signed char>((w >> (8 * i)) & 0xff));
}

// What a quantized hop does with what arrives: overwrite with q * scale
// (C6's allgather sweep, C5 standalone), accumulate fma(q, scale, acc),
// one rounding (C6's reduce-scatter sweep), or add acc + q * scale with the
// product and the sum rounded apart (C5 in place, as the plain tensor add).
enum Land { LAND_SET, LAND_FMA, LAND_ADD };

// The four codes of w landed on acc as LAND says.
template <int LAND>
__device__ __forceinline__ float4 dequantize4(unsigned w, float scale,
                                              float4 acc) {
  if constexpr (LAND == LAND_FMA)
    return make_float4(__fmaf_rn(code(w, 0), scale, acc.x),
                       __fmaf_rn(code(w, 1), scale, acc.y),
                       __fmaf_rn(code(w, 2), scale, acc.z),
                       __fmaf_rn(code(w, 3), scale, acc.w));
  const float4 d =
      make_float4(__fmul_rn(code(w, 0), scale), __fmul_rn(code(w, 1), scale),
                  __fmul_rn(code(w, 2), scale), __fmul_rn(code(w, 3), scale));
  if constexpr (LAND == LAND_ADD)
    return make_float4(__fadd_rn(acc.x, d.x), __fadd_rn(acc.y, d.y),
                       __fadd_rn(acc.z, d.z), __fadd_rn(acc.w, d.w));
  return d;
}

// A payload word and the accumulator it lands on.
struct WordAcc {
  unsigned q;
  float4 acc;
};

// Step 2 of hop t: this block's range of send quantized with the rank's
// scale into the right neighbour's slot t % 2, and its copy of the scale
// beside it.
__device__ __forceinline__ void qsend(const RingArgs& a, const Block& k,
                                      int t, float scale, const float4* send) {
  const int slot = t & 1;
  const long long lo = k.lo * F4, hi = k.hi * F4, words = a.chunk_vecs * F4;
  unsigned* out = reinterpret_cast<unsigned*>(a.slot[k.right]) + slot * words;
  each_vec(lo, hi, [&](long long i) { return send[i]; },
           [&](long long i, float4 v) { __stcg(out + i, quantize4(v, scale)); });
  if (threadIdx.x == 0) __stcg(a.scale[k.right] + slot * MAX_BPR + k.b, scale);
}

// Step 5 of hop t: the left neighbour's payload in this rank's slot t % 2
// dequantized into dst (landed on cur, which may be dst, as LAND says).
// Sets m to this thread's max |dst| written: the next hop's max, when the
// next hop sends dst.
template <int LAND>
__device__ __forceinline__ void qrecv(const RingArgs& a, const Block& k,
                                      int t, const float4* cur, float4* dst,
                                      unsigned& m) {
  const int slot = t & 1;
  const long long lo = k.lo * F4, hi = k.hi * F4, words = a.chunk_vecs * F4;
  const unsigned* in = reinterpret_cast<const unsigned*>(a.slot[k.r]) +
                       slot * words;
  const float s = __ldcg(a.scale[k.r] + slot * MAX_BPR + k.b);
  m = 0;
  const auto put = [&](long long i, float4 v) {
    dst[i] = v;
    m = max(m, abs_bits(v));
  };
  if constexpr (LAND == LAND_SET)
    each_vec(lo, hi, [&](long long i) { return __ldcg(in + i); },
             [&](long long i, unsigned w) {
               put(i, dequantize4<LAND_SET>(w, s, float4{}));
             });
  else
    each_vec(lo, hi, [&](long long i) { return WordAcc{__ldcg(in + i), cur[i]}; },
             [&](long long i, WordAcc w) {
               put(i, dequantize4<LAND>(w.q, s, w.acc));
             });
}

// One quantized hop t in one launch: the capacity wait, qsend, the
// receive flag, the wait for the left neighbour's payload, qrecv and the
// capacity release (steps 1-6 of the header).
template <int LAND>
__device__ bool qhop(const RingArgs& a, const Block& k, int t, int total,
                     float scale, const float4* send, const float4* cur,
                     float4* dst, unsigned& m) {
  const int f = flag_index(k.b, t & 1);
  if (t >= 2 && !wait_flag(a, a.cap[k.r] + f, a.base + t - 1, k.r, k.b, t,
                           WAIT_CAP))
    return false;
  qsend(a, k, t, scale, send);
  signal_flag(a.recv[k.right] + f, a.base + t + 1);
  if (!hop_recv(a, k, t)) return false;
  qrecv<LAND>(a, k, t, cur, dst, m);
  hop_release(a, k, t, total);
  return true;
}

// C5, one hop in either form (see the header). QHOP: out[right] =
// dequant(quant(in[r])) with one scale over rank r's block, after a max
// pass. QRS_HOP: hop t = a.hop of the split-phase int8 reduce-scatter on
// in, n chunks a rank: chunk r - t - 1 goes right and what arrives is added
// onto chunk r - t - 2; the scale from a max pass at hop 0 and from the
// carried max after; the max of what it writes carried to hop t + 1.
__global__ void __launch_bounds__(NT)
ring_qhop_kernel(const __grid_constant__ RingArgs a) {
  const Block k = block_of(a);
  const long long lo = k.lo * F4, hi = k.hi * F4;
  float scale;
  unsigned m = 0;
  if (a.kind == QHOP) {
    const float4* in = reinterpret_cast<const float4*>(a.in[k.r]);
    m = thread_absmax_bits(in, lo, hi);
    if (rank_scale(a, k, 0, m, &scale))
      qhop<LAND_SET>(a, k, 0, 1, scale, in, nullptr,
                reinterpret_cast<float4*>(a.out[k.r]), m);
    return;
  }
  const int t = a.hop;
  float4* b = reinterpret_cast<float4*>(a.in[k.r]);
  const long long cf = a.chunk_vecs * F4;     // float4 per chunk
  const float4* send = b + mod(k.r - t - 1, k.n) * cf;
  float4* dst = b + mod(k.r - t - 2, k.n) * cf;
  if (t == 0) {
    if (!rank_scale(a, k, 0, thread_absmax_bits(send, lo, hi), &scale))
      return;
  } else if (!carried_scale(a, k, t, &scale)) {
    return;
  }
  if (qhop<LAND_ADD>(a, k, 0, 1, scale, send, dst, dst, m) && t + 2 < k.n)
    carry_max(a, k, t + 1, m);
}

// C6: the reference's schedule (quantized.py:83-94): a reduce-scatter sweep
// that accumulates, then an allgather sweep that overwrites, 2(n - 1) hops,
// each requantizing its send chunk with a fresh scale. Hop 0 reads its send
// chunk from in after a max pass; every later hop sends the chunk the hop
// before wrote, with the max taken as it was written (see the header). The
// reduce-scatter hops accumulate in[recv] into out[recv] (one buffer when
// in place), so out needs no copy of in.
__global__ void __launch_bounds__(NT)
ring_qallreduce_kernel(const __grid_constant__ RingArgs a) {
  const Block k = block_of(a);
  const float4* in = reinterpret_cast<const float4*>(a.in[k.r]);
  float4* out = reinterpret_cast<float4*>(a.out[k.r]);
  const long long cf = a.chunk_vecs * F4;     // float4 per chunk
  const int total = 2 * (k.n - 1);
  unsigned m = thread_absmax_bits(in + k.r * cf, k.lo * F4, k.hi * F4);
  float scale;
  int t = 0;
  for (int s = 0; s < k.n - 1; ++s, ++t) {
    const int send = mod(k.r - s, k.n), recv = mod(k.r - s - 1, k.n);
    if (!rank_scale(a, k, t, m, &scale) ||
        !qhop<LAND_FMA>(a, k, t, total, scale,
                        (s == 0 ? in : out) + send * cf, in + recv * cf,
                        out + recv * cf, m))
      return;
  }
  for (int s = 0; s < k.n - 1; ++s, ++t) {
    const int send = mod(k.r - s + 1, k.n), recv = mod(k.r - s, k.n);
    if (!rank_scale(a, k, t, m, &scale) ||
        !qhop<LAND_SET>(a, k, t, total, scale, out + send * cf, nullptr,
                        out + recv * cf, m))
      return;
  }
}

// C6, rank form: phase t (0 .. 2(n - 1)) of rank a.rank0, one launch a
// phase, in place on the rank's staging buffer (in == out). Phase t
// combines hop t - 1 from this rank's slot (t > 0; the max of what it
// writes, in registers, is hop t's), then, for t < 2(n - 1), takes hop
// t's scale at the rank's barrier (every block it waits on is in this
// launch) and sends hop t into the right neighbour's slot. Nothing here
// waits on another process: between phases the host orders the stream on
// the neighbours' receive and capacity words (see the rank form below).
// The schedule and the arithmetic are ring_qallreduce_kernel's.
__global__ void __launch_bounds__(NT)
ring_qallreduce_rank_kernel(const __grid_constant__ RingArgs a) {
  const Block k = block_of(a);
  const int n = k.n, total = 2 * (n - 1), t = a.hop;
  const float4* in = reinterpret_cast<const float4*>(a.in[k.r]);
  float4* out = reinterpret_cast<float4*>(a.out[k.r]);
  const long long cf = a.chunk_vecs * F4;     // float4 per chunk
  unsigned m = 0;
  if (t == 0) {
    m = thread_absmax_bits(in + k.r * cf, k.lo * F4, k.hi * F4);
  } else if (t - 1 < n - 1) {                 // reduce-scatter hop t - 1
    const int recv = mod(k.r - t, n);
    qrecv<LAND_FMA>(a, k, t - 1, in + recv * cf, out + recv * cf, m);
  } else {                                    // allgather hop t - 1
    const int recv = mod(k.r - (t - n), n);
    qrecv<LAND_SET>(a, k, t - 1, nullptr, out + recv * cf, m);
  }
  if (t == total) return;
  float scale;
  // After the barrier, so every block of the launch reaches it.
  if (!rank_scale(a, k, t, m, &scale) || poisoned(a)) return;
  const float4* send = t < n - 1
                           ? (t == 0 ? in : out) + mod(k.r - t, n) * cf
                           : out + mod(k.r - (t - n + 1) + 1, n) * cf;
  qsend(a, k, t, scale, send);
}

template <typename T>
const void* kernel_for(int kind, int op) {
  switch (kind) {
    case QHOP:
    case QRS_HOP:
    case QALLREDUCE:
      if (!std::is_same<T, float>::value || op != SUM) return nullptr;
      return kind == QALLREDUCE
                 ? reinterpret_cast<const void*>(ring_qallreduce_kernel)
                 : reinterpret_cast<const void*>(ring_qhop_kernel);
    case PERMUTE: return reinterpret_cast<const void*>(ring_permute_kernel<T>);
    case ALLGATHER:
      return reinterpret_cast<const void*>(ring_allgather_kernel<T>);
    case REDUCE_SCATTER:
      switch (op) {
        case SUM: return reinterpret_cast<const void*>(ring_reduce_scatter_kernel<T, SUM>);
        case MAX: return reinterpret_cast<const void*>(ring_reduce_scatter_kernel<T, MAX>);
        case MIN: return reinterpret_cast<const void*>(ring_reduce_scatter_kernel<T, MIN>);
        case PROD: return reinterpret_cast<const void*>(ring_reduce_scatter_kernel<T, PROD>);
      }
      return nullptr;
    case ALLREDUCE:
      switch (op) {
        case SUM: return reinterpret_cast<const void*>(ring_allreduce_kernel<T, SUM>);
        case MAX: return reinterpret_cast<const void*>(ring_allreduce_kernel<T, MAX>);
        case MIN: return reinterpret_cast<const void*>(ring_allreduce_kernel<T, MIN>);
        case PROD: return reinterpret_cast<const void*>(ring_allreduce_kernel<T, PROD>);
      }
      return nullptr;
  }
  return nullptr;
}

// The kernel for a dtype code (0 float32, 1 bfloat16, 2 float16, 3 int32);
// nullptr for a combination there is none for.
const void* kernel_of(int kind, int op, int dtype) {
  switch (dtype) {
    case 0: return kernel_for<float>(kind, op);
    case 1: return kernel_for<__nv_bfloat16>(kind, op);
    case 2: return kernel_for<__half>(kind, op);
    case 3: return kernel_for<int>(kind, op);
  }
  return nullptr;
}

bool quantized(int kind) {
  return kind == QHOP || kind == QALLREDUCE || kind == QRS_HOP;
}

// Bytes per element of a dtype code (0 float32, 1 bfloat16, 2 float16,
// 3 int32); 0 for an unknown code.
int elem_bytes(int dtype) {
  switch (dtype) {
    case 0: case 3: return 4;
    case 1: case 2: return 2;
  }
  return 0;
}

// Bytes of comm slots one rank needs for a call (see ring_slot_bytes).
long long rank_slot_bytes(int kind, long long chunk_elems) {
  if (!quantized(kind)) return 0;
  return 2 * chunk_elems + 2 * MAX_BPR * (long long)sizeof(float);
}

// How many blocks of `fn` the device holds at once (occupancy per SM times
// the SMs), asked of the runtime once per kernel and device.
cudaError_t resident_blocks(const void* fn, int dev, int* out) {
  constexpr int SLOTS = 64;
  static const void* fns[SLOTS];
  static int devs[SLOTS], counts[SLOTS];
  static int used = 0;
  static std::mutex lock;
  std::lock_guard<std::mutex> guard(lock);
  for (int i = 0; i < used; ++i)
    if (fns[i] == fn && devs[i] == dev) {
      *out = counts[i];
      return cudaSuccess;
    }
  int sms = 0, per_sm = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, NT, 0);
  if (err != cudaSuccess) return err;
  *out = per_sm * sms;
  if (used < SLOTS) {
    fns[used] = fn;
    devs[used] = dev;
    counts[used++] = *out;
  }
  return cudaSuccess;
}

}  // namespace

// Launch one ring collective on `stream`.
//   kind: 0 permute (C1), 1 reduce-scatter (C2), 2 allgather (C3),
//         3 allreduce (C4), 4 quantized hop (C5), 5 quantized allreduce
//         (C6), 6 in-place quantized reduce-scatter hop (C5's other form);
//   op: 0 sum, 1 max, 2 min, 3 prod (C2, C4; C5, C6 sum only);
//   dtype: 0 float32, 1 bfloat16, 2 float16, 3 int32 (C5, C6: float32
//   only).
//   in / out: rank r's block at base + r * stride (strides in elements;
//   C6 may run in place, in == out; C5 in place: in == out, the buffer);
//   chunk_elems: elements per chunk, the payload of one hop (C1, C5: the
//   whole block; C2, C4, C6, C5 in place: a block of n chunks; C3: the
//   input block);
//   slots: ring_slot_bytes(kind, n, chunk_elems) bytes; flags: n x 3 x
//   MAX_BPR x 2 u64 (receive flags, capacity flags, barrier words, per
//   rank); base: epoch base; err_dev: an int in device memory; err_host:
//   the device address of 8 int64 in pinned host memory;
//   hop, carry: C5 in place: the reduce-scatter's hop t (0 .. n - 2) and
//   its carry table, [n - 1][n] u64 zeroed before its hop 0 (other kinds:
//   0, null).
// Returns a cudaError_t; 0 when the launch was accepted.
extern "C" int ring_launch(int kind, int op, int dtype, int n, void* in,
                           long long in_stride, void* out,
                           long long out_stride, long long chunk_elems,
                           void* slots, void* flags, unsigned long long base,
                           void* err_dev, void* err_host, void* stream,
                           int hop, void* carry) {
  if (n < 2 || n > MAX_RANKS || chunk_elems < 1 || kind < 0 ||
      kind > QRS_HOP)
    return int(cudaErrorInvalidValue);
  if (kind == QRS_HOP &&
      (carry == nullptr || in != out || hop < 0 || hop > n - 2))
    return int(cudaErrorInvalidValue);
  const int elem = elem_bytes(dtype);
  if (elem == 0) return int(cudaErrorInvalidValue);
  const int vec = 16 / elem;
  const int unit = quantized(kind) ? QGROUP : vec;
  if (chunk_elems % unit || in_stride % vec || out_stride % vec)
    return int(cudaErrorInvalidValue);
  const void* fn = kernel_of(kind, op, dtype);
  if (fn == nullptr) return int(cudaErrorInvalidValue);

  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return int(err);
  int resident = 0;
  err = resident_blocks(fn, dev, &resident);
  if (err != cudaSuccess) return int(err);

  RingArgs a;
  a.n = n;
  a.kind = kind;
  a.rank0 = 0;
  a.per_rank = 0;
  a.poison = nullptr;
  a.chunk_vecs = chunk_elems / unit;
  a.base = base;
  a.hop = hop;
  a.carry = static_cast<u64*>(carry);
  a.err_dev = static_cast<int*>(err_dev);
  a.err_host = static_cast<long long*>(err_host);
  // As many blocks per rank as the payload wants, capped so that all
  // n * bpr blocks are resident at once.
  const long long cap = std::min<long long>(MAX_BPR, resident / n);
  if (cap < 1) return int(cudaErrorCooperativeLaunchTooLarge);
  const long long want =
      (a.chunk_vecs + MIN_VECS_PER_BLOCK - 1) / MIN_VECS_PER_BLOCK;
  a.bpr = int(std::max(1LL, std::min(cap, want)));

  const long long slot_bytes = rank_slot_bytes(kind, chunk_elems);
  u64* f = static_cast<u64*>(flags);
  for (int r = 0; r < MAX_RANKS; ++r) {
    const bool live = r < n;
    char* slot = live && slots ? static_cast<char*>(slots) + r * slot_bytes
                               : nullptr;
    u64* rf = live ? f + size_t(r) * FLAG_SECTIONS * MAX_BPR * 2 : nullptr;
    a.in[r] = live ? static_cast<char*>(in) + r * in_stride * elem : nullptr;
    a.out[r] = live ? static_cast<char*>(out) + r * out_stride * elem : nullptr;
    a.slot[r] = slot;
    a.scale[r] = slot && quantized(kind)
                     ? reinterpret_cast<float*>(slot + 2 * chunk_elems)
                     : nullptr;
    a.recv[r] = rf;
    a.cap[r] = live ? rf + MAX_BPR * 2 : nullptr;
    a.bar[r] = live ? rf + 2 * MAX_BPR * 2 : nullptr;
  }
  if (slot_bytes && slots == nullptr) return int(cudaErrorInvalidValue);

  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(fn, dim3(a.bpr, n), dim3(NT), args, 0,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return int(err);
  return int(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The rank form: one process per rank on one card (util/collective/
// process_ring.py fills the tables). Rank r launches grid (bpr, 1) whose
// blocks play rank r (rank0 = r) against a table of peer pointers opened
// through CUDA IPC: every rank's staging input and output, comm slots and
// in-kernel flag table. C2, C3 and C4 run their one-process bodies
// without the in-kernel completion round (per_rank = 1); C6 runs
// ring_qallreduce_rank_kernel once a phase. No kernel of this form waits
// on a flag that another process sets: the host orders each rank's
// stream on flag words that the peers' streams write (ring_stream_write /
// ring_stream_wait, the CUDA driver's stream memory operations), before and
// after the launches and between C6's phases. One card: every peer is the
// same device, so the stream operations' fence and .gpu-scope
// release/acquire inside a launch suffice; across cards (.sys scope) this
// form is untested. A rank whose wait expired sets every rank's poison
// word before it releases its own stream: the launches still queued
// anywhere then leave the peers' memory alone (see poisoned).
// Bound on the H100: bytes, as in one process, a rank's share: one rank's
// launch reads and writes (C one chunk of the rank's block) C4 2nC (chunk
// r of every rank's input, then it into every rank's output), C2 (n + 1)C,
// C3 (1 + n) shards, C6 its block in and out at the bound (19C in all at
// n = 4, as the one-launch form). The staging copies around the launch
// (the caller's tensor in, the result out) move as many bytes again; they
// are the price of buffers every peer can map once.
// ---------------------------------------------------------------------------

// Launch one rank's part of C2 (1), C3 (2), C4 (3) or C6 (5, phase `hop`
// of 2(n - 1) + 1) on `stream`: ins / outs / slots / tables hold n
// pointers each (slots: C6 only; tables: each rank's in-kernel flag table,
// FLAG_SECTIONS x MAX_BPR x 2 u64, C6 only); chunk_elems and the epoch
// base as in ring_launch (C6: base = calls so far x 2(n - 1)); poison is
// this rank's poison word (C2-C4 store nothing, C6 sends nothing, once it
// is set). Returns a cudaError_t; 0 when the launch was accepted.
extern "C" int ring_rank_launch(int kind, int op, int dtype, int n, int rank,
                                void** ins, void** outs, void** slots,
                                void** tables, long long chunk_elems,
                                unsigned long long base, int hop,
                                void* poison, void* err_dev, void* err_host,
                                void* stream) {
  if (n < 2 || n > MAX_RANKS || rank < 0 || rank >= n || chunk_elems < 1 ||
      !(kind == REDUCE_SCATTER || kind == ALLGATHER || kind == ALLREDUCE ||
        kind == QALLREDUCE))
    return int(cudaErrorInvalidValue);
  const bool q = kind == QALLREDUCE;
  if (q && (hop < 0 || hop > 2 * (n - 1) || slots == nullptr ||
            tables == nullptr || dtype != 0 || op != SUM))
    return int(cudaErrorInvalidValue);
  const int elem = elem_bytes(dtype);
  if (elem == 0) return int(cudaErrorInvalidValue);
  const int unit = q ? QGROUP : 16 / elem;
  if (chunk_elems % unit) return int(cudaErrorInvalidValue);
  const void* fn =
      q ? reinterpret_cast<const void*>(ring_qallreduce_rank_kernel)
        : kernel_of(kind, op, dtype);
  if (fn == nullptr) return int(cudaErrorInvalidValue);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return int(err);
  int resident = 0;
  err = resident_blocks(fn, dev, &resident);
  if (err != cudaSuccess) return int(err);

  RingArgs a;
  a.n = n;
  a.kind = kind;
  a.rank0 = rank;
  a.per_rank = 1;
  a.poison = static_cast<const u64*>(poison);
  a.chunk_vecs = chunk_elems / unit;
  a.base = base;
  a.hop = hop;
  a.carry = nullptr;
  a.err_dev = static_cast<int*>(err_dev);
  a.err_host = static_cast<long long*>(err_host);
  // One rank a launch: C6's rank barrier needs its bpr blocks resident.
  const long long cap = std::min<long long>(MAX_BPR, resident);
  if (cap < 1) return int(cudaErrorCooperativeLaunchTooLarge);
  const long long want =
      (a.chunk_vecs + MIN_VECS_PER_BLOCK - 1) / MIN_VECS_PER_BLOCK;
  a.bpr = int(std::max(1LL, std::min(cap, want)));
  for (int r = 0; r < MAX_RANKS; ++r) {
    const bool live = r < n;
    char* slot = live && q ? static_cast<char*>(slots[r]) : nullptr;
    u64* rf = live && tables ? static_cast<u64*>(tables[r]) : nullptr;
    a.in[r] = live ? static_cast<char*>(ins[r]) : nullptr;
    a.out[r] = live ? static_cast<char*>(outs[r]) : nullptr;
    a.slot[r] = slot;
    a.scale[r] = slot ? reinterpret_cast<float*>(slot + 2 * chunk_elems)
                      : nullptr;
    a.recv[r] = rf;
    a.cap[r] = rf ? rf + MAX_BPR * 2 : nullptr;
    a.bar[r] = rf ? rf + 2 * MAX_BPR * 2 : nullptr;
  }
  void* args[] = {&a};
  const dim3 grid(a.bpr, 1);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = q ? cudaLaunchCooperativeKernel(fn, grid, dim3(NT), args, 0, s)
          : cudaLaunchKernel(fn, grid, dim3(NT), args, 0, s);
  if (err != cudaSuccess) return int(err);
  return int(cudaGetLastError());
}

// Whether the device takes 64-bit stream memory operations (the rank
// form's transport): *out = the CUDA driver's attribute. Returns a CUresult.
extern "C" int ring_stream_mem_ops(int* out) {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || cudaFree(nullptr) != cudaSuccess)
    return int(CUDA_ERROR_NOT_INITIALIZED);
  CUdevice d;
  CUresult r = cuDeviceGet(&d, dev);
  if (r != CUDA_SUCCESS) return int(r);
  // The current attribute (CUDA 12), not the deprecated _V1 one, which
  // reads 0 where the v2 operations work.
  return int(cuDeviceGetAttribute(
      out, CU_DEVICE_ATTRIBUTE_CAN_USE_64_BIT_STREAM_MEM_OPS, d));
}

// Enqueue on `stream`, in order, a write of `value` to each of the count
// flag words at addrs (a peer's, through IPC, or this rank's own). The
// driver fences the stream's earlier work before each write. Returns a
// CUresult.
extern "C" int ring_stream_write(void* stream, void** addrs, int count,
                                 unsigned long long value) {
  for (int i = 0; i < count; ++i) {
    const CUresult r = cuStreamWriteValue64(
        static_cast<CUstream>(stream), reinterpret_cast<CUdeviceptr>(addrs[i]),
        value, CU_STREAM_WRITE_VALUE_DEFAULT);
    if (r != CUDA_SUCCESS) return int(r);
  }
  return 0;
}

// Enqueue on `stream` a wait until each of the count flag words at addrs
// (this rank's own) holds at least `value` (cyclic 64-bit comparison). A
// stream wait has no timeout: the host watches the call against its
// deadline and, on expiry, writes the awaited values itself
// (ring_stream_write on another stream). Returns a CUresult.
extern "C" int ring_stream_wait(void* stream, void** addrs, int count,
                                unsigned long long value) {
  for (int i = 0; i < count; ++i) {
    const CUresult r = cuStreamWaitValue64(
        static_cast<CUstream>(stream), reinterpret_cast<CUdeviceptr>(addrs[i]),
        value, CU_STREAM_WAIT_VALUE_GEQ);
    if (r != CUDA_SUCCESS) return int(r);
  }
  return 0;
}

extern "C" const char* ring_driver_error_string(int err) {
  const char* s = nullptr;
  if (cuGetErrorString(static_cast<CUresult>(err), &s) != CUDA_SUCCESS ||
      s == nullptr)
    return "unknown driver error";
  return s;
}

// Memory shared across processes: cudaMalloc'd outside torch's caching
// allocator, zeroed, and its IPC handle (ring_ipc_handle_bytes() bytes)
// written to handle. Returns a cudaError_t.
extern "C" int ring_ipc_alloc(long long bytes, void** ptr, void* handle) {
  cudaError_t err = cudaMalloc(ptr, static_cast<size_t>(bytes));
  if (err == cudaSuccess) err = cudaMemset(*ptr, 0, static_cast<size_t>(bytes));
  if (err == cudaSuccess) err = cudaDeviceSynchronize();
  if (err == cudaSuccess)
    err = cudaIpcGetMemHandle(static_cast<cudaIpcMemHandle_t*>(handle), *ptr);
  return int(err);
}

// A peer's memory from its handle (never this process's own).
extern "C" int ring_ipc_open(const void* handle, void** ptr) {
  cudaIpcMemHandle_t h;
  memcpy(&h, handle, sizeof(h));
  return int(cudaIpcOpenMemHandle(ptr, h, cudaIpcMemLazyEnablePeerAccess));
}

extern "C" int ring_ipc_close(void* ptr) {
  return int(cudaIpcCloseMemHandle(ptr));
}

extern "C" int ring_free(void* ptr) { return int(cudaFree(ptr)); }

extern "C" int ring_ipc_handle_bytes() {
  return int(sizeof(cudaIpcMemHandle_t));
}

// Stream-ordered copies (any direction: unified addressing) and zero
// fills of the staging buffers. Return a cudaError_t.
extern "C" int ring_copy(void* dst, const void* src, long long bytes,
                         void* stream) {
  return int(cudaMemcpyAsync(dst, src, static_cast<size_t>(bytes),
                             cudaMemcpyDefault,
                             static_cast<cudaStream_t>(stream)));
}

extern "C" int ring_zero(void* dst, long long bytes, void* stream) {
  return int(cudaMemsetAsync(dst, 0, static_cast<size_t>(bytes),
                             static_cast<cudaStream_t>(stream)));
}

// Bytes of comm slots a call needs for all n ranks: C1-C4 none; C5, C6
// two int8 chunks and 2 x MAX_BPR f32 scales per rank.
extern "C" long long ring_slot_bytes(int kind, int n, long long chunk_elems) {
  return n * rank_slot_bytes(kind, chunk_elems);
}

// Blocks of the kernel for (kind, op, dtype) resident on one SM at once,
// from the runtime's occupancy calculator: the launch caps n * bpr at this
// times the SMs. Returns a cudaError_t.
extern "C" int ring_blocks_per_sm(int kind, int op, int dtype, int* out) {
  const void* fn = kernel_of(kind, op, dtype);
  if (fn == nullptr) return int(cudaErrorInvalidValue);
  return int(cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, fn, NT, 0));
}

// The device address of pinned host memory (the timeout record).
extern "C" int ring_host_device_ptr(void* host, void** device) {
  return int(cudaHostGetDevicePointer(device, host, 0));
}

// Constants the Python side must agree with.
extern "C" int ring_max_ranks() { return MAX_RANKS; }
extern "C" int ring_max_blocks_per_rank() { return MAX_BPR; }
extern "C" int ring_flag_sections() { return FLAG_SECTIONS; }

extern "C" const char* ring_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
