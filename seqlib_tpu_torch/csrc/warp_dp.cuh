// Warp-level pieces shared by the extension kernels (K1 in
// sw_extend.cu, K3-K5 in sw_rect.cu): they reduce a lane's per-thread
// results and write its five outputs.

#pragma once

#include <cuda_runtime.h>
#include <cstdint>
#include <cstdlib>

namespace {

constexpr int NEG = -0x40000000;  // -inf surrogate that survives additions
constexpr unsigned FULL = 0xffffffffu;

// (v, idx) <- the larger v, then the smaller idx, over the warp
__device__ __forceinline__ void warp_argmax(int& v, int& idx) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const int ov = __shfl_xor_sync(FULL, v, off);
    const int oi = __shfl_xor_sync(FULL, idx, off);
    if (ov > v || (ov == v && oi < idx)) {
      v = ov;
      idx = oi;
    }
  }
}

// one lane's five outputs of out int32 [5, M] from its best cell (score,
// row, column), gscore and gtle
__device__ __forceinline__ void write_lane(int32_t* __restrict__ out, int M,
                                           int lane, int best, int bi,
                                           int bj, int gscore, int gtle) {
  const bool found = best > 0;
  out[lane] = found ? best : 0;
  out[M + lane] = found ? bi + 1 : 0;
  out[2 * M + lane] = found ? bj : 0;
  out[3 * M + lane] = gscore;
  out[4 * M + lane] = gtle;
}

// the warp-per-lane epilogue: reduce the per-thread best cells (highest
// score, then earliest row, then smallest column) and write the outputs
__device__ __forceinline__ void warp_finish(int32_t* __restrict__ out,
                                            int M, int lane, int best,
                                            int bi, int bj, int gscore,
                                            int gtle) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const int ob = __shfl_xor_sync(FULL, best, off);
    const int oi = __shfl_xor_sync(FULL, bi, off);
    const int oj = __shfl_xor_sync(FULL, bj, off);
    if (ob > best || (ob == best && (oi < bi || (oi == bi && oj < bj)))) {
      best = ob;
      bi = oi;
      bj = oj;
    }
  }
  if ((threadIdx.x & 31) == 0)
    write_lane(out, M, lane, best, bi, bj, gscore, gtle);
}

// z-drop decision for one computed row (K1: identical on every thread
// of the warp once the row max has been reduced; K3-K5: on the lane's
// owner thread)
__device__ __forceinline__ bool zdrop_stop(int i, int m, int mj, int& zbest,
                                           int& zbi, int& zbj, int e_del,
                                           int e_ins, int zdrop) {
  const bool better = m > zbest;
  const int di = i - zbi, dj = mj - zbj;
  const int gap = abs(di - dj);
  const int pen = (di > dj ? e_del : e_ins) * gap;
  const bool stop = (!better && zbest - m - pen > zdrop) || m <= 0;
  if (better) {
    zbest = m;
    zbi = i;
    zbj = mj;
  }
  return stop;
}

}  // namespace
