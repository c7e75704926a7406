// A probe of Hopper's DPX instructions, for the rectangle kernels'
// design and bound (bench_sw.dpx_probe): how many clocks a scheduler
// takes to issue one warp instruction of each operation the DP cells are
// built from, at full occupancy and in one dependent chain, and what the
// 16-bit pair forms do at their edges (does an add wrap or saturate, what
// the predicates of __vibmax_s16x2 say, how PRMT replicates a sign).
// Not a port of a TPU kernel; nothing of the port calls it.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

__device__ __forceinline__ unsigned prmt(unsigned a, unsigned b,
                                         unsigned sel) {
  unsigned r;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(sel));
  return r;
}

// one step of the probe, a chain a -> a: 0 __viaddmax_s16x2, 1
// __viaddmax_s32, 2 __vibmax_s16x2 with a select on each predicate (a
// pair of cells' running max and first column), 3 PRMT
template <int OP>
__device__ __forceinline__ unsigned op(unsigned a, unsigned b, unsigned c) {
  if constexpr (OP == 0) {
    return __viaddmax_s16x2(a, b, c);
  } else if constexpr (OP == 1) {
    return (unsigned)__viaddmax_s32((int)a, (int)b, (int)c);
  } else if constexpr (OP == 2) {
    bool hi, lo;
    const unsigned m = __vibmax_s16x2(a, b, &hi, &lo);
    return (hi ? m : c) ^ (lo ? 0u : 1u);
  } else {
    return prmt(a, b, a);
  }
}

// CH independent chains a thread (CH = 8: throughput, 1: latency); each
// warp's first thread writes the clocks its loop took
template <int OP, int CH>
__global__ void probe_kernel(unsigned long long* clocks, unsigned* sink,
                             int iters, unsigned b, unsigned c) {
  unsigned a[CH];
#pragma unroll
  for (int k = 0; k < CH; ++k) a[k] = threadIdx.x * 0x00010003u + k;
  __syncwarp();
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int k = 0; k < CH; ++k) a[k] = op<OP>(a[k], b, c);
  }
  unsigned x = 0;
#pragma unroll
  for (int k = 0; k < CH; ++k) x ^= a[k];
  __syncwarp();
  const long long t1 = clock64();
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if ((threadIdx.x & 31) == 0) clocks[warp] = (unsigned long long)(t1 - t0);
  if (x == 0x9e3779b9u) sink[0] = x;  // keeps the chains alive
}

template <int OP>
void launch_probe(int ch, int blocks, int threads, unsigned long long* clk,
                  unsigned* sink, int iters, unsigned b, unsigned c,
                  cudaStream_t st) {
  if (ch == 1)
    probe_kernel<OP, 1><<<blocks, threads, 0, st>>>(clk, sink, iters, b, c);
  else
    probe_kernel<OP, 8><<<blocks, threads, 0, st>>>(clk, sink, iters, b, c);
}

// edge cases of the pair forms, one value each
__global__ void semantics_kernel(unsigned* out) {
  if (threadIdx.x != 0 || blockIdx.x != 0) return;
  // high half 32767 + 1 against -5, low half 1 + 1 against -5
  out[0] = __viaddmax_s16x2(0x7fff0001u, 0x00010001u, 0xfffbfffbu);
  // high (5, 3), low (1, 2): max (5, 2); hi = 5 >= 3, lo = 1 >= 2
  bool hi = false, lo = true;
  out[1] = __vibmax_s16x2(0x00050001u, 0x00030002u, &hi, &lo);
  out[2] = (hi ? 2u : 0u) | (lo ? 1u : 0u);
  // equal halves: does the predicate say a >= b?
  out[3] = 0;
  __vibmax_s16x2(0x00040004u, 0x00040004u, &hi, &lo);
  out[3] = (hi ? 2u : 0u) | (lo ? 1u : 0u);
  // the plain pair max: -32768 against 32767 and 5 against 3
  out[4] = __vmaxs2(0x80000005u, 0x7fff0003u);
  // byte 1 (0xfc), its sign, byte 0 (0x01), its sign: 0x0001fffc
  out[5] = prmt(0xfcfcfc01u, 0xfcfcfcfcu, 0x8091u);
  // -32768 - 1 against -32768: wraps to 32767 or saturates at -32768
  out[6] = __viaddmax_s16x2(0x80008000u, 0xffffffffu, 0x80008000u);
  // a = (1, 1) against b = (0, 0): a >= b in both halves
  __vibmax_s16x2(0x00010001u, 0u, &hi, &lo);
  out[7] = (hi ? 2u : 0u) | (lo ? 1u : 0u);
}

}  // namespace

// clocks: uint64 [blocks * threads / 32]; op 0-3 as above; ch 1 or 8
extern "C" int dpx_probe(void* clocks, void* sink, int op, int ch,
                         int blocks, int threads, int iters, void* stream) {
  auto* clk = static_cast<unsigned long long*>(clocks);
  auto* snk = static_cast<unsigned*>(sink);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned b = 0x00010001u, c = 0x00050003u;
  switch (op) {
    case 0: launch_probe<0>(ch, blocks, threads, clk, snk, iters, b, c, st);
            break;
    case 1: launch_probe<1>(ch, blocks, threads, clk, snk, iters, b, c, st);
            break;
    case 2: launch_probe<2>(ch, blocks, threads, clk, snk, iters, b, c, st);
            break;
    case 3: launch_probe<3>(ch, blocks, threads, clk, snk, iters, b, c, st);
            break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// out: uint32 [8], semantics_kernel's values
extern "C" int dpx_semantics(void* out, void* stream) {
  semantics_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned*>(out));
  return static_cast<int>(cudaGetLastError());
}
