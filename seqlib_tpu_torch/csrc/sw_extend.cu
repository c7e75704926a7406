// Kernel K1: banded affine-gap seed extension (bwa ksw_extend under the
// strict band |j - R| <= w), bit-exact with the plain PyTorch version
// seqlib_tpu_torch/ops/sw.py::extend_batch(band=w, zdrop).
//
// Replaces: seqlib_tpu/ops/sw_pallas.py::_extend_kernel_banded (the TPU
// kernel behind extend_batch_pallas_banded / extend_batch_adaptive).
//
// What bounds it on an H100: not bytes (a lane reads ~0.5 KB of query and
// target and writes 20 B) but the dependent integer work of the DP: each
// band cell is ~15 int32 operations, and the E (deletion) chain makes
// every cell of a row depend on the cell to its left.  At the main path's
// shapes (M = 3072 lanes, 150 bp, w = 100) a call is ~1e8 cells.
//
// Design: one thread per lane runs ksw_extend's row loop over the band in
// relative-diagonal coordinates rd = j - R + w.  In those coordinates the
// diagonal predecessor of cell rd is the previous row's cell rd and the
// vertical one is rd + 1, so each row is updated in place with one
// ascending sweep (H and F live in two 2w+2 local arrays, index 2w+1 a
// permanent NEG sentinel) and E is a running max carried along the sweep
// (no scan, no shuffles).  Only the live cells [max(0, R-w),
// min(R+w, tlen)] are computed; every other cell of the plain version's
// full row is exactly NEG there (or never observable), and the kernel
// reproduces the few places where those NEG cells reach an output: the
// E running max entering the band from the left, the vertical move
// into the band's right edge, and gscore/gtle taken over the whole row.
// Ties keep the earliest row, then the smallest column (strict '>' in
// row-major order).  This is the simple, correct version: lanes are
// latency-bound (one warp holds 32 lanes, ~0.5 warp per SM at M = 3072).
// A warp-per-lane layout with a shuffle prefix-max for E is the next
// step.

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int NEG = -0x40000000;
constexpr int MAXW = 128;

__global__ void sw_extend_banded_kernel(
    const int8_t* __restrict__ query, const int32_t* __restrict__ qlen,
    const int8_t* __restrict__ target, const int32_t* __restrict__ tlen,
    const int32_t* __restrict__ h0v, int32_t* __restrict__ out, int M,
    int Lq, int Lt, int w, int o_del, int e_del, int o_ins, int e_ins,
    int match, int mismatch, int zdrop) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= M) return;
  int H[2 * MAXW + 2];
  int F[2 * MAXW + 2];
  const int8_t* q = query + (size_t)lane * Lq;
  const int8_t* t = target + (size_t)lane * Lt;
  const int ql = qlen[lane];
  const int tl = min(tlen[lane], Lt);
  const int h0 = h0v[lane];
  const int oe_ins = o_ins + e_ins;

  for (int r = 0; r < 2 * w + 2; ++r) {
    H[r] = NEG;
    F[r] = NEG;
  }
  // row 0 (R = 0): cell j lives at rd = j + w; band j <= w, target j <= tl
  for (int j = 0; j <= min(w, tl); ++j) {
    int v = j == 0 ? h0 : h0 - (o_del + e_del * j);
    H[j + w] = (j > 0 && v < 0) ? NEG : v;
  }

  int best = 0, bi = 0, bj = 0;            // best cell (score > 0 only)
  int zbest = h0, zbi = 0, zbj = 0;        // z-drop reference cell
  int gscore = NEG, gtle = 0;              // not captured: all-NEG row
  const int rows = min(ql, Lq);
  for (int i = 0; i < rows; ++i) {
    const int R = i + 1;
    const int base = R - w;                // j = base + rd
    const int lo = max(0, base);
    const int hi = min(R + w, tl);
    const int qi = q[i];
    const bool last = (i == ql - 1);
    // max over columns left of the band of (NEG + e_del * j')
    int run = lo > 0 ? NEG + e_del * (lo - 1) : INT_MIN;
    int rowmax = -1, mj = 0;
    int gmax = INT_MIN, gidx = 0;
    for (int j = lo; j <= hi; ++j) {
      const int rd = j - base;
      // vertical move: previous row's cell at this column is rd + 1
      const int Fv = max(H[rd + 1] - oe_ins, F[rd + 1] - e_ins);
      int hnd;
      if (j >= 1) {
        const int tc = t[j - 1];
        const int sc = (tc == qi && tc < 4 && qi < 4) ? match : -mismatch;
        hnd = max(H[rd] + sc, Fv);       // diagonal move: same rd
      } else {
        hnd = max(Fv, NEG);
      }
      const int E = j == 0 ? NEG - o_del : run - o_del - e_del * j;
      run = max(run, hnd + e_del * j);
      const int h = max(hnd, E);
      H[rd] = h;
      F[rd] = Fv;
      if (j >= 1) {
        if (h > best) { best = h; bi = i; bj = j; }
        if (h > rowmax) { rowmax = h; mj = j; }
      }
      if (last && h > gmax) { gmax = h; gidx = j; }
    }
    if (last) {
      // the plain row is NEG outside [lo, hi]; first such column
      const int nl = (lo > 0 || hi < 0) ? 0 : (hi < Lt ? hi + 1 : -1);
      if (nl < 0 || gmax > NEG) {
        gscore = gmax; gtle = gidx;
      } else if (gmax == NEG) {
        gscore = NEG; gtle = min(gidx, nl);
      } else {
        gscore = NEG; gtle = nl;
      }
    }
    if (zdrop > 0) {
      const int m = rowmax;
      const bool better = m > zbest;
      const int di = i - zbi, dj = mj - zbj;
      const int gap = abs(di - dj);
      const int pen = (di > dj ? e_del : e_ins) * gap;
      const bool stop = (!better && zbest - m - pen > zdrop) || m <= 0;
      if (better) { zbest = m; zbi = i; zbj = mj; }
      if (stop) break;
    }
  }
  const bool found = best > 0;
  out[lane] = found ? best : 0;
  out[M + lane] = found ? bi + 1 : 0;
  out[2 * M + lane] = found ? bj : 0;
  out[3 * M + lane] = gscore;
  out[4 * M + lane] = gtle;
}

}  // namespace

extern "C" int sw_extend_max_band() { return MAXW; }

// out: int32 [5, M] = score, qle, tle, gscore, gtle.
extern "C" int sw_extend_banded(const void* query, const void* qlen,
                                const void* target, const void* tlen,
                                const void* h0, void* out, int M, int Lq,
                                int Lt, int w, int o_del, int e_del,
                                int o_ins, int e_ins, int match,
                                int mismatch, int zdrop, void* stream) {
  if (M > 0) {
    const int threads = 64;
    const int blocks = (M + threads - 1) / threads;
    sw_extend_banded_kernel<<<blocks, threads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int8_t*>(query),
        static_cast<const int32_t*>(qlen),
        static_cast<const int8_t*>(target),
        static_cast<const int32_t*>(tlen),
        static_cast<const int32_t*>(h0), static_cast<int32_t*>(out), M, Lq,
        Lt, w, o_del, e_del, o_ins, e_ins, match, mismatch, zdrop);
  }
  return static_cast<int>(cudaGetLastError());
}
