// Kernel K1: banded affine-gap seed extension (bwa ksw_extend under the
// strict band |j - R| <= w), bit-exact with the plain PyTorch version
// seqlib_tpu_torch/ops/sw.py::extend_batch(band=w, zdrop).
//
// Replaces: seqlib_tpu/ops/sw_pallas.py::_extend_kernel_banded (the TPU
// kernel behind extend_batch_pallas_banded / extend_batch_adaptive).
//
// What bounds it on an H100: not bytes (a lane reads ~0.5 KB of query and
// target and writes 20 B) and not the >= 8 int32 operations per band cell
// (a main-path call needs ~1e7 cells: well under a microsecond of the
// card's integer rate), but latency.  Each DP row depends on the one
// before, and within a row the E (deletion) term of a cell depends on
// every cell to its left, so a lane is a chain of rows x (dependent steps
// per row), and a call lasts as long as its longest lane.  The main path
// calls it with 3072 lanes of 2w + 1 <= 65 cells a row, or with a few
// dozen to a few hundred lanes at w = 100.  With this design a row costs
// about twelve dependent shuffles plus two S-long serial passes.
//
// Design: one warp per lane, four lanes per 128-thread block, so that
// even a 65-lane call spreads over 17 SMs and a 3072-lane call puts ~6
// warps on every SM.  The band is kept in relative-diagonal coordinates:
// cell j of row R sits at slot rd = j - R + w, 0 <= rd <= 2w, so the
// diagonal predecessor of slot rd is the previous row's slot rd and the
// vertical one is slot rd + 1.  Slot 2w + 1 and every slot above it is a
// permanent NEG sentinel.  Thread t holds slots [t*S, t*S + S) of H and F
// in registers (S a template parameter, the smallest instance with
// 32*S >= 2w + 2); a strip's last slot takes its vertical predecessor
// from thread t + 1's first slot by one shuffle before the row is
// overwritten.  E is the running max of hnd + e_del*j: a serial max
// inside the strip plus a 5-step exclusive warp prefix-max of the strip
// maxima, seeded in thread 0 with the left-of-band term
// NEG + e_del*(lo - 1) (the plain version's NEG columns left of the
// band).  Only the live columns [max(0, R - w), min(R + w, tlen)] are
// computed; every other slot is NEG, and only live slots and the sentinel
// are ever read.  The lane's query and target codes are staged in shared
// memory once, so a row's query code is a broadcast.  Long lanes (the
// long-read path gives a lane up to L - 1 query rows and L + w + 1 target
// columns) may not fit: when four lanes' codes exceed the card's
// per-block shared memory (227 KB on an H100, four 28 kb lanes), the
// kernel is instantiated to read them from global memory through the
// read-only cache instead (a row reads one query code and the 2w + 1
// target codes of its band, contiguous across the warp, so the loads
// stay coalesced); the launcher picks the layout by shape.  Control flow is
// the same in all 32 threads (rows, z-drop exit), so there is no
// divergence inside a lane.
//
// Ties (those of the plain version): the best cell is the highest score,
// then the earliest row, then the smallest column: each thread keeps its
// own with a strict '>' in row-major order, then one lexicographic warp
// reduction.  The z-drop row max (over live columns j >= 1, from -1) and
// gscore/gtle take a (max, smallest column) reduction; gscore/gtle then
// apply the edge rules of a last row that is NEG outside [lo, hi].

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

#include "warp_dp.cuh"

namespace {

constexpr int MAXW = 128;
constexpr int WARPS = 4;  // lanes (warps) per block

struct Params {
  const int8_t* query;
  const int32_t* qlen;
  const int8_t* target;
  const int32_t* tlen;
  const int32_t* h0;
  int32_t* out;
  int M, Lq, Lt, w;
  int o_del, e_del, o_ins, e_ins, match, mismatch, zdrop;
  int lq_pad, lt_pad;  // a warp's shared-memory bytes for query, target
};

template <int S, bool STAGED>
__global__ void __launch_bounds__(WARPS * 32) band_warp_kernel(Params p) {
  extern __shared__ __align__(16) int8_t smem[];
  const int warp = threadIdx.x >> 5;
  const int t = threadIdx.x & 31;
  const int lane = blockIdx.x * WARPS + warp;
  if (lane >= p.M) return;  // the whole warp leaves together
  const int w = p.w;
  const int ql = p.qlen[lane];
  const int tl = min(p.tlen[lane], p.Lt);
  const int h0 = p.h0[lane];
  const int rows = min(ql, p.Lq);
  const int oe_ins = p.o_ins + p.e_ins;

  // the lane's codes: staged once per warp (STAGED), or read from global
  // memory through the read-only cache
  const int8_t* q = p.query + (size_t)lane * p.Lq;
  const int8_t* tg = p.target + (size_t)lane * p.Lt;
  int8_t* sq = smem + warp * (p.lq_pad + p.lt_pad);
  int8_t* st = sq + p.lq_pad;
  if constexpr (STAGED) {
    for (int x = t; x < rows; x += 32) sq[x] = q[x];
    for (int x = t; x < tl; x += 32) st[x] = tg[x];
    __syncwarp();
  }
  auto qcode = [&](int i) -> int {
    if constexpr (STAGED) return sq[i]; else return __ldg(q + i);
  };
  auto tcode = [&](int j) -> int {
    if constexpr (STAGED) return st[j]; else return __ldg(tg + j);
  };

  // row 0 (R = 0): cell j at slot j + w for 0 <= j <= min(w, tl)
  const int r0 = t * S;
  int H[S], F[S];
#pragma unroll
  for (int k = 0; k < S; ++k) {
    const int j = r0 + k - w;
    int v = NEG;
    if (j >= 0 && j <= w && j <= tl) {
      v = j == 0 ? h0 : h0 - (p.o_del + p.e_del * j);
      if (j > 0 && v < 0) v = NEG;
    }
    H[k] = v;
    F[k] = NEG;
  }

  int best = 0, bi = 0, bj = 0;       // best cell (score > 0 only)
  int zbest = h0, zbi = 0, zbj = 0;   // z-drop reference cell
  int gscore = NEG, gtle = 0;         // not captured: last row not reached
  for (int i = 0; i < rows; ++i) {
    const int R = i + 1;
    const int base = R - w;           // column of slot 0
    const int lo = max(0, base);
    const int hi = min(R + w, tl);
    const int qi = qcode(i);
    // vertical predecessor of the strip's last slot (previous row)
    int hv = __shfl_down_sync(FULL, H[0], 1);
    int fv = __shfl_down_sync(FULL, F[0], 1);
    if (t == 31) {
      hv = NEG;
      fv = NEG;
    }
    // pass 1: F and H without E; the strip's max of hnd + e_del*j
    int g = INT_MIN;
#pragma unroll
    for (int k = 0; k < S; ++k) {
      const int j = base + r0 + k;
      const bool live = j >= lo && j <= hi;
      const int hup = k + 1 < S ? H[k + 1] : hv;
      const int fup = k + 1 < S ? F[k + 1] : fv;
      const int f = max(hup - oe_ins, fup - p.e_ins);
      int hnd;
      if (j >= 1) {
        const int tc = live ? tcode(j - 1) : 4;
        const int sc = (tc == qi && tc < 4 && qi < 4) ? p.match
                                                      : -p.mismatch;
        hnd = max(H[k] + sc, f);      // diagonal: the same slot
      } else {
        hnd = max(f, NEG);
      }
      H[k] = live ? hnd : NEG;
      F[k] = live ? f : NEG;
      if (live) g = max(g, hnd + p.e_del * j);
    }
    // E carry into the strip: the left-of-band term, then the exclusive
    // prefix max of the strip maxima
    int incl = g;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(FULL, incl, d);
      if (t >= d) incl = max(incl, v);
    }
    const int excl = __shfl_up_sync(FULL, incl, 1);
    const int seed = lo > 0 ? NEG + p.e_del * (lo - 1) : NEG;
    int run = t == 0 ? seed : max(excl, seed);
    // pass 2: E, H, and the row's reductions
    const bool last = i == ql - 1;
    int rowmax = -1, mj = 0, gmx = INT_MIN, gix = 0;
#pragma unroll
    for (int k = 0; k < S; ++k) {
      const int j = base + r0 + k;
      if (j >= lo && j <= hi) {
        const int hnd = H[k];
        const int E = run - p.o_del - p.e_del * j;
        run = max(run, hnd + p.e_del * j);
        const int h = max(hnd, E);
        H[k] = h;
        if (j >= 1) {
          if (h > best) { best = h; bi = i; bj = j; }
          if (h > rowmax) { rowmax = h; mj = j; }
        }
        if (last && h > gmx) { gmx = h; gix = j; }
      }
    }
    if (last) {
      warp_argmax(gmx, gix);
      // the plain row is NEG outside [lo, hi]; its first such column
      const int nl = (lo > 0 || hi < 0) ? 0 : (hi < p.Lt ? hi + 1 : -1);
      if (nl < 0 || gmx > NEG) {
        gscore = gmx;
        gtle = gix;
      } else if (gmx == NEG) {
        gscore = NEG;
        gtle = min(gix, nl);
      } else {
        gscore = NEG;
        gtle = nl;
      }
    }
    if (p.zdrop > 0) {
      warp_argmax(rowmax, mj);
      if (zdrop_stop(i, rowmax, mj, zbest, zbi, zbj, p.e_del, p.e_ins,
                     p.zdrop))
        break;
    }
  }
  warp_finish(p.out, p.M, lane, best, bi, bj, gscore, gtle);
}

template <int S, bool STAGED>
int launch_layout(const Params& p, size_t smem, cudaStream_t st) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        band_warp_kernel<S, STAGED>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int blocks = (p.M + WARPS - 1) / WARPS;
  band_warp_kernel<S, STAGED><<<blocks, WARPS * 32, smem, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// stage the codes when four lanes' worth fits the card's per-block
// shared memory, else read them from global memory
template <int S>
int launch(const Params& p, cudaStream_t st) {
  const size_t smem = (size_t)WARPS * (p.lq_pad + p.lt_pad);
  int dev = 0, limit = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&limit,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (smem <= (size_t)limit) return launch_layout<S, true>(p, smem, st);
  return launch_layout<S, false>(p, 0, st);
}

}  // namespace

extern "C" int sw_extend_max_band() { return MAXW; }

// out: int32 [5, M] = score, qle, tle, gscore, gtle.  1 <= w <= MAXW.
extern "C" int sw_extend_banded(const void* query, const void* qlen,
                                const void* target, const void* tlen,
                                const void* h0, void* out, int M, int Lq,
                                int Lt, int w, int o_del, int e_del,
                                int o_ins, int e_ins, int match,
                                int mismatch, int zdrop, void* stream) {
  if (w < 1 || w > MAXW) return static_cast<int>(cudaErrorInvalidValue);
  if (M <= 0) return static_cast<int>(cudaGetLastError());
  Params p;
  p.query = static_cast<const int8_t*>(query);
  p.qlen = static_cast<const int32_t*>(qlen);
  p.target = static_cast<const int8_t*>(target);
  p.tlen = static_cast<const int32_t*>(tlen);
  p.h0 = static_cast<const int32_t*>(h0);
  p.out = static_cast<int32_t*>(out);
  p.M = M; p.Lq = Lq; p.Lt = Lt; p.w = w;
  p.o_del = o_del; p.e_del = e_del; p.o_ins = o_ins; p.e_ins = e_ins;
  p.match = match; p.mismatch = mismatch; p.zdrop = zdrop;
  p.lq_pad = (Lq + 15) & ~15;
  p.lt_pad = (Lt + 15) & ~15;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // slots per thread: the smallest instance with 32*S >= 2w + 2
  const int need = (2 * w + 2 + 31) / 32;
  if (need <= 1) return launch<1>(p, st);
  if (need <= 2) return launch<2>(p, st);
  if (need <= 3) return launch<3>(p, st);
  if (need <= 5) return launch<5>(p, st);
  if (need <= 7) return launch<7>(p, st);
  return launch<9>(p, st);
}
