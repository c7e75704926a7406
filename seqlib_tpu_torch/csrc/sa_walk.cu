// The LF walk of a sampled suffix array in one launch, bit-exact with the
// plain PyTorch loop seqlib_tpu_torch/ops/fm.py::_sa_walk.
//
// Replaces no TPU kernel: the JAX package walks LF in XLA
// (seqlib_tpu/ops/fm.py::sa_lookup).  The port's plain loop, run on the
// card, launches ~60 small operations a step and reads the device twice
// every 8 steps; on a loaded index (bwa's SA interval 32) that was half of
// the fused batch program's time.  This kernel does the whole locate of a
// batch in one launch, with no read by the host.
//
// What it computes: for each entry of a flat int64 rank array, -1 where
// the rank is < 0; else the rank r walks r <- LF(r) until
// r % sa_intv == 0 or r == primary, or until cap steps (the JAX package's
// 64 * sa_intv), and its text position is
// (r == primary ? 0 : sa[r / sa_intv]) + steps, a capped lane's too.
// LF(r) = L2[c] + 1 + checkpoint[c] + (c among the block's first
// p & 127 bases), p = r - (r > primary), c the BWT code at p: one block
// row of the occurrence table holds the code and the checkpoint, so a
// step reads one row (48 bytes narrow, 64 wide).
//
// What bounds it on an H100: each step's row address depends on the
// previous step, so a lane is a chain of dependent loads (a bacterial
// index, 3.5 MB of rows, sits in the 50 MB L2).  Three bounds, the
// largest wins: HBM, the rank array streamed once (8 bytes read and 8 or
// 16 written an entry) over 3.35 TB/s; L2, two 32-byte sectors a step (a
// 48- or 64-byte row spans two) and one a lane's SA sample, plus the HBM
// stream, which passes through L2, over L2's read bandwidth
// (``sa_l2_read`` below measures it); and latency, the longest lane's
// steps x one dependent load (K2's ``smem_load_chase`` measures it).  At
// the benchmark's batch (26.2 M entries, ~530,000 valid, 16.3 M steps,
// ~31 a lane, the longest ~360) the HBM stream is 0.42 GB and the rows'
// sectors 1.04 GB.  To reach the bytes bounds the card needs many chains
// in flight at once: at a few hundred ns and 64 bytes a step, L2's
// bandwidth wants tens of thousands.
//
// Design: a block of 128 threads owns a tile of 8192 consecutive entries.
// Phase 1 streams the tile (coalesced, 8 loads in flight a thread),
// writes -1 (and 0 steps) for the invalid entries and appends the valid
// ones' tile offsets to a queue in shared memory (a warp ballot, one
// shared atomic a warp).  Phase 2: each thread pulls a lane from the
// queue, walks it in registers, writes it, and pulls the next.  On the
// main path 2% of the entries are valid and they cluster (the first of
// each seed's 16 occurrence slots), so a warp over raw entries would hold
// one live lane among 31 finished ones; the queue gives every thread of a
// block a chain (~160 lanes a tile for 128 threads) and a thread one lane
// at a time: a second lane per thread would sit empty at this density.
// At 55 registers a thread (nvcc's report for the int32 instance; 48 for
// int64; no spill) and 16 KB of queue a block, 8 blocks share an SM, so
// one SM keeps several hundred chains in flight while other blocks stream
// their tile.
//
// With a counters pointer (the tracer on) each warp adds its lanes, its
// exact LF steps and its lanes that reached the cap to three 64-bit
// totals (one atomic per warp and total; sums in 64 bits, so no interval
// overflows them).
//
// Two instantiations, by rank type R.  int32 (sa_walk) reads the narrow
// index's 48-byte rows: 4 uint32 checkpoints, 8 BWT words.  int64
// (sa_walk_wide) reads the wide index's 64-byte rows: 4 int64
// checkpoints, then the same 8 words, for 2L texts of 2^31 or more.  Row
// addressing is size_t in both.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int THREADS = 128;
constexpr int PER = 64;                 // entries a thread streams
constexpr int TILE = THREADS * PER;     // entries a block owns (< 2^16)
constexpr int UNROLL = 8;               // rank loads in flight a thread
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ unsigned long long warp_sum(unsigned long long v) {
#pragma unroll
  for (int d = 16; d; d >>= 1) v += __shfl_down_sync(FULL, v, d);
  return v;
}

template <typename R>
struct Params {
  R primary, intv;
  R L2[4];
  long long cap;
};

// uint32 words a checkpoint row spans, and the word its BWT words start at
template <typename R> struct Row;
template <> struct Row<int32_t> { static constexpr int WORDS = 12, BWT = 4; };
template <> struct Row<int64_t> { static constexpr int WORDS = 16, BWT = 8; };

__device__ __forceinline__ void load_counts(const uint32_t* row,
                                            int32_t (&c)[4]) {
  const uint4 v = __ldg(reinterpret_cast<const uint4*>(row));
  c[0] = (int32_t)v.x; c[1] = (int32_t)v.y;
  c[2] = (int32_t)v.z; c[3] = (int32_t)v.w;
}
__device__ __forceinline__ void load_counts(const uint32_t* row,
                                            int64_t (&c)[4]) {
  const longlong2* r2 = reinterpret_cast<const longlong2*>(row);
  const longlong2 a = __ldg(r2), b = __ldg(r2 + 1);
  c[0] = a.x; c[1] = a.y; c[2] = b.x; c[3] = b.y;
}

// one LF step: the whole block row in three (four) independent 16-byte
// loads, then the code at p and its count in the block's prefix
template <typename R>
__device__ __forceinline__ R lf(const uint32_t* __restrict__ blocks, R r,
                                const Params<R>& p) {
  const R q = r - (r > p.primary ? 1 : 0);
  const uint32_t* row = blocks + (size_t)(q >> 7) * Row<R>::WORDS;
  R cnt[4];
  load_counts(row, cnt);
  const uint4* w4 = reinterpret_cast<const uint4*>(row + Row<R>::BWT);
  const uint4 a = __ldg(w4), b = __ldg(w4 + 1);
  const uint32_t w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  const int within = (int)(q & 127);
  uint32_t word = w[0];
#pragma unroll
  for (int j = 1; j < 8; ++j)
    if (j == (within >> 4)) word = w[j];
  const int c = (word >> (2 * (15 - (within & 15)))) & 3;
  const uint32_t pat = (uint32_t)c * 0x55555555u;
  int occ = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int tt = min(max(within - 16 * j, 0), 16);
    const uint32_t mask = tt ? 0xFFFFFFFFu << (32 - 2 * tt) : 0u;
    const uint32_t nx = ~(w[j] ^ pat);
    occ += __popc(nx & (nx >> 1) & 0x55555555u & mask);
  }
  R base = cnt[0], l2 = p.L2[0];
#pragma unroll
  for (int k = 1; k < 4; ++k)
    if (k == c) { base = cnt[k]; l2 = p.L2[k]; }
  return l2 + 1 + base + (R)occ;
}

template <typename R>
__global__ void __launch_bounds__(THREADS) sa_walk_kernel(
    const uint32_t* __restrict__ blocks, const int64_t* __restrict__ sa,
    const int64_t* __restrict__ ranks, long long n, Params<R> p,
    int64_t* __restrict__ pos, int64_t* __restrict__ steps,
    unsigned long long* __restrict__ counters) {
  __shared__ uint16_t queue[TILE];
  __shared__ int q_len, q_head;
  const int t = threadIdx.x, lane = t & 31;
  const unsigned below = (1u << lane) - 1u;
  const long long tile0 = (long long)blockIdx.x * TILE;
  if (t == 0) { q_len = 0; q_head = 0; }
  __syncthreads();

  // phase 1: stream the tile; invalid entries out, valid ones queued
  for (int j0 = 0; j0 < PER; j0 += UNROLL) {
    long long rv[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long i = tile0 + (long long)(j0 + u) * THREADS + t;
      rv[u] = i < n ? __ldg(ranks + i) : -1;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int off = (j0 + u) * THREADS + t;
      const long long i = tile0 + off;
      const bool valid = rv[u] >= 0;
      if (!valid && i < n) {
        pos[i] = -1;
        if (steps) steps[i] = 0;
      }
      const unsigned m = __ballot_sync(FULL, valid);
      if (m) {
        int base = 0;
        if (lane == 0) base = atomicAdd(&q_len, __popc(m));
        base = __shfl_sync(FULL, base, 0);
        if (valid) queue[base + __popc(m & below)] = (uint16_t)off;
      }
    }
  }
  __syncthreads();

  // phase 2: a thread walks one queued lane at a time
  const int len = q_len;
  unsigned long long n_lanes = 0, n_steps = 0, n_capped = 0;
  for (;;) {
    const int k = atomicAdd(&q_head, 1);
    if (k >= len) break;
    const long long i = tile0 + queue[k];
    R r = (R)__ldg(ranks + i);
    long long s = 0;
    bool done = r % p.intv == 0 || r == p.primary;
    while (!done && s < p.cap) {
      r = lf<R>(blocks, r, p);
      ++s;
      done = r % p.intv == 0 || r == p.primary;
    }
    const int64_t at = r == p.primary ? 0 : __ldg(sa + r / p.intv);
    pos[i] = at + s;
    if (steps) steps[i] = s;
    ++n_lanes;
    n_steps += (unsigned long long)s;
    n_capped += s == p.cap ? 1u : 0u;
  }
  if (counters) {
    n_lanes = warp_sum(n_lanes);
    n_steps = warp_sum(n_steps);
    n_capped = warp_sum(n_capped);
    if (lane == 0) {
      if (n_lanes) atomicAdd(counters + 0, n_lanes);
      if (n_steps) atomicAdd(counters + 1, n_steps);
      if (n_capped) atomicAdd(counters + 2, n_capped);
    }
  }
}

// The read bandwidth of L2 behind the walk's L2 bound: the grid reads the
// whole table (n16 uint4s, small enough to stay in L2) reps times,
// through L2 only (__ldcg: no L1 hit on a repeat); one store if the xor
// of all it read has a value it never has in practice, so that no load
// is dropped.
__global__ void __launch_bounds__(256) l2_read_kernel(
    const uint4* __restrict__ table, unsigned n16, int reps,
    unsigned* __restrict__ out) {
  const unsigned stride = gridDim.x * blockDim.x;
  unsigned acc = 0;
#pragma unroll 4
  for (int k = 0; k < reps; ++k)
    for (unsigned i = blockIdx.x * blockDim.x + threadIdx.x; i < n16;
         i += stride) {
      const uint4 v = __ldcg(table + i);
      acc ^= v.x ^ v.y ^ v.z ^ v.w;
    }
  if (acc == 0x9e3779b9u) out[0] = acc;
}

template <typename R>
int launch(const void* blocks, const void* sa, const void* ranks,
           long long n, R intv, long long cap, R primary, const R* L2,
           void* pos, void* steps, void* counters, void* stream) {
  if (intv < 1 || cap < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  Params<R> p;
  p.primary = primary;
  for (int c = 0; c < 4; ++c) p.L2[c] = L2[c];
  p.intv = intv;
  p.cap = cap;
  const long long grid = (n + TILE - 1) / TILE;
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  sa_walk_kernel<R><<<(unsigned)grid, THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(blocks), static_cast<const int64_t*>(sa),
      static_cast<const int64_t*>(ranks), n, p, static_cast<int64_t*>(pos),
      static_cast<int64_t*>(steps),
      static_cast<unsigned long long*>(counters));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// steps and counters may be null; counters, when given, are three int64
// totals (lanes, LF steps, lanes that reached the cap) the launch adds to
extern "C" int sa_walk(const void* blocks, const void* sa, const void* ranks,
                       long long n, int intv, long long cap, int primary,
                       const int* L2, void* pos, void* steps, void* counters,
                       void* stream) {
  const int32_t l2[4] = {L2[0], L2[1], L2[2], L2[3]};
  return launch<int32_t>(blocks, sa, ranks, n, intv, cap, primary, l2, pos,
                         steps, counters, stream);
}

// the wide index: int64 rows, primary and L2
extern "C" int sa_walk_wide(const void* blocks, const void* sa,
                            const void* ranks, long long n, long long intv,
                            long long cap, long long primary,
                            const long long* L2, void* pos, void* steps,
                            void* counters, void* stream) {
  const int64_t l2[4] = {L2[0], L2[1], L2[2], L2[3]};
  return launch<int64_t>(blocks, sa, ranks, n, (int64_t)intv, cap,
                         (int64_t)primary, l2, pos, steps, counters, stream);
}

// the L2 read-bandwidth probe: `blocks` x 256 threads read the n16 uint4s
// of `table` reps times; not a kernel of the alignment path
extern "C" int sa_l2_read(const void* table, long long n16, int reps,
                          int blocks, void* out, void* stream) {
  if (n16 <= 0 || n16 > 0xffffffffLL || reps < 0 || blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  l2_read_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(table), (unsigned)n16, reps,
      static_cast<unsigned*>(out));
  return static_cast<int>(cudaGetLastError());
}
