// Kernels K3, K4 and K5: full-rectangle affine-gap seed extension (bwa
// ksw_extend with no band, optional z-drop), three Hopper layouts of one
// function.  Each is bit-exact with the plain PyTorch version
// seqlib_tpu_torch/ops/sw.py::extend_rect (extend_batch(band=0) with the
// dead-row convention: a lane whose last query row is never computed
// reports gscore = NEG, gtle = 0).
//
// Replaces:
//   K3 sw_extend_rect             seqlib_tpu/ops/sw_pallas.py::_extend_kernel
//   K4 sw_extend_rect_blocked     scripts/sw_variant_sweep.py::make_kernel
//                                 (blocked E scan)
//   K5 sw_extend_rect_interleaved scripts/sw_variant_sweep.py::make_kernel_v4
//                                 (NCH interleaved row chains)
//
// What bounds them on an H100: not bytes (a lane reads Lq + Lt code bytes
// and writes 20 B) but the dependent integer work of the DP, ~14 int32
// operations per cell, with the E (deletion) recurrence making each cell
// of a row depend on every cell to its left.  At the extension bench's
// shape (1024 lanes, 150 x 251 cells) a call is at most 38.6 M cells.
//
// The three designs map the TPU kernels' ideas onto a warp:
// * K3: one warp per lane.  Thread t owns the contiguous strip of columns
//   [t*S, t*S + S) in registers (S = ceil((Lt+1)/32), a template).  The
//   diagonal input at a strip's left edge comes from the neighbour thread
//   by __shfl_up_sync, F stays in registers, and E is a serial running
//   max inside the strip plus a 5-step warp exclusive prefix-max of the
//   strip maxima as the carry (the TPU kernel's log-step shift-max scan,
//   run over 32 strips instead of TW sublanes).
// * K4: one warp per lane, columns interleaved: column j lives in thread
//   j % 32, register slot j / 32.  Each 32-column block's E prefix-max is
//   a 5-step __shfl_up_sync scan (K4's within-32 scan) and the carry from
//   block to block is a serial running max over the slots (K4's small
//   carry array), so a row is one pass over the slots.
// * K5: one thread per NCH lanes (a template, 2 or 3).  The thread sweeps
//   its lanes' rows left to right in one loop, the lanes' dependent
//   chains interleaved so they overlap (K5's interleaved chains become
//   instruction-level parallelism); E is K1's serial running max.  Row
//   state is a wrapper-allocated scratch area in device memory,
//   thread-interleaved so a warp's accesses coalesce (served from L1/L2).
//
// Shared semantics (those of the plain version):
// * row 0: H(0,0) = h0, H(0,j) = h0 - o_del - e_del*j, NEG where < 0;
// * columns j > tlen are NEG (dead); nothing flows leftwards, so the
//   live columns never read them;
// * best cell: highest score, then earliest row, then smallest column
//   (per thread a strict '>' in row-major order, then a lexicographic
//   warp reduction); score <= 0 reports (0, 0, 0);
// * z-drop (zdrop > 0): the row max over columns >= 1 (clamped at -1)
//   and its smallest column; a lane stops when it drops more than zdrop
//   below the best (ksw_extend's gap-corrected test) or when the row
//   max is <= 0;
// * gscore/gtle: max of the last query row (i = qlen - 1) over all
//   Lt + 1 columns and its smallest column, or (NEG, 0) when that row is
//   never computed (qlen = 0, qlen > Lq, or stopped before it).

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

#include "warp_dp.cuh"

namespace {

constexpr int MAX_SLOTS = 32;  // columns per lane <= 32 * 32 = 1024

struct Params {
  const int8_t* query;
  const int32_t* qlen;
  const int8_t* target;
  const int32_t* tlen;
  const int32_t* h0;
  int32_t* out;
  int M, Lq, Lt;
  int o_del, e_del, o_ins, e_ins, match, mismatch, zdrop;
};

__device__ __forceinline__ int subst(int tc, int qi, int match,
                                     int mismatch) {
  return (tc == qi && tc < 4 && qi < 4) ? match : -mismatch;
}

__device__ __forceinline__ int row0(int j, int h0, int tl, int o_del,
                                    int e_del) {
  int v = j == 0 ? h0 : h0 - (o_del + e_del * j);
  if (j > 0 && v < 0) v = NEG;
  return j > tl ? NEG : v;
}

// ---------------------------------------------------------------------------
// K3: warp per lane, contiguous strips
// ---------------------------------------------------------------------------

template <int S>
__global__ void __launch_bounds__(128) rect_strip_kernel(Params p) {
  const int lane = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int t = threadIdx.x & 31;
  if (lane >= p.M) return;  // the whole warp leaves together
  const int8_t* q = p.query + (size_t)lane * p.Lq;
  const int8_t* tg = p.target + (size_t)lane * p.Lt;
  const int ql = p.qlen[lane];
  const int tl = min(p.tlen[lane], p.Lt);
  const int h0 = p.h0[lane];
  const int oe_ins = p.o_ins + p.e_ins;
  const int j0 = t * S;

  int H[S], F[S], tc[S];
#pragma unroll
  for (int k = 0; k < S; ++k) {
    const int j = j0 + k;
    tc[k] = (j >= 1 && j <= p.Lt) ? tg[j - 1] : 4;
    H[k] = row0(j, h0, tl, p.o_del, p.e_del);
    F[k] = NEG;
  }

  int best = 0, bi = 0, bj = 0;
  int zbest = h0, zbi = 0, zbj = 0;
  int gscore = NEG, gtle = 0;
  const int rows = min(ql, p.Lq);
  for (int i = 0; i < rows; ++i) {
    const int qi = q[i];
    // H(i-1, j0-1): the left neighbour's last column (none for j = 0)
    int diag = __shfl_up_sync(FULL, H[S - 1], 1);
    if (t == 0) diag = NEG;
    // pass 1: F and the H candidate without E; the strip's max of
    // hnd(j) + e_del*j
    int gmax = NEG;
#pragma unroll
    for (int k = 0; k < S; ++k) {
      const int j = j0 + k;
      const int hp = H[k];
      const int f = max(hp - oe_ins, F[k] - p.e_ins);
      const int hnd = j >= 1
          ? max(diag + subst(tc[k], qi, p.match, p.mismatch), f)
          : max(f, NEG);
      diag = hp;
      F[k] = f;
      H[k] = hnd;
      gmax = max(gmax, hnd + p.e_del * j);
    }
    // exclusive prefix max of the strip maxima
    int incl = gmax;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(FULL, incl, d);
      if (t >= d) incl = max(incl, v);
    }
    int run = __shfl_up_sync(FULL, incl, 1);
    if (t == 0) run = NEG;
    // pass 2: E, H, and the row's reductions
    const bool last = i == ql - 1;
    int rowmax = -1, mj = 0, gmx = INT_MIN, gix = 0;
#pragma unroll
    for (int k = 0; k < S; ++k) {
      const int j = j0 + k;
      const int hnd = H[k];
      const int E = run - p.o_del - p.e_del * j;
      run = max(run, hnd + p.e_del * j);
      int h = max(hnd, E);
      if (j > tl) h = NEG;
      H[k] = h;
      if (j >= 1) {
        if (h > best) { best = h; bi = i; bj = j; }
        if (h > rowmax) { rowmax = h; mj = j; }
      }
      if (last && j <= p.Lt && h > gmx) { gmx = h; gix = j; }
    }
    if (last) {
      warp_argmax(gmx, gix);
      gscore = gmx;
      gtle = gix;
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

// ---------------------------------------------------------------------------
// K4: warp per lane, interleaved columns, blocked E scan
// ---------------------------------------------------------------------------

template <int S>
__global__ void __launch_bounds__(128) rect_blocked_kernel(Params p) {
  const int lane = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int t = threadIdx.x & 31;
  if (lane >= p.M) return;
  const int8_t* q = p.query + (size_t)lane * p.Lq;
  const int8_t* tg = p.target + (size_t)lane * p.Lt;
  const int ql = p.qlen[lane];
  const int tl = min(p.tlen[lane], p.Lt);
  const int h0 = p.h0[lane];
  const int oe_ins = p.o_ins + p.e_ins;
  const int left = (t + 31) & 31;

  int H[S], F[S], tc[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int j = 32 * s + t;
    tc[s] = (j >= 1 && j <= p.Lt) ? tg[j - 1] : 4;
    H[s] = row0(j, h0, tl, p.o_del, p.e_del);
    F[s] = NEG;
  }

  int best = 0, bi = 0, bj = 0;
  int zbest = h0, zbi = 0, zbj = 0;
  int gscore = NEG, gtle = 0;
  const int rows = min(ql, p.Lq);
  for (int i = 0; i < rows; ++i) {
    const int qi = q[i];
    const bool last = i == ql - 1;
    int prev = NEG;   // thread 0: H(i-1, 32s - 1), from thread 31
    int carry = NEG;  // max of hnd(j') + e_del*j' over earlier blocks
    int rowmax = -1, mj = 0, gmx = INT_MIN, gix = 0;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int j = 32 * s + t;
      const int hp = H[s];
      // H(i-1, j-1): thread t-1's slot s, or thread 31's slot s-1
      const int r = __shfl_sync(FULL, hp, left);
      const int diag = t == 0 ? prev : r;
      prev = r;
      const int f = max(hp - oe_ins, F[s] - p.e_ins);
      const int hnd = j >= 1
          ? max(diag + subst(tc[s], qi, p.match, p.mismatch), f)
          : max(f, NEG);
      F[s] = f;
      // within-block inclusive prefix max, then exclusive + carry
      int incl = hnd + p.e_del * j;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int v = __shfl_up_sync(FULL, incl, d);
        if (t >= d) incl = max(incl, v);
      }
      int excl = __shfl_up_sync(FULL, incl, 1);
      if (t == 0) excl = NEG;
      const int E = max(carry, excl) - p.o_del - p.e_del * j;
      carry = max(carry, __shfl_sync(FULL, incl, 31));
      int h = max(hnd, E);
      if (j > tl) h = NEG;
      H[s] = h;
      if (j >= 1) {
        if (h > best) { best = h; bi = i; bj = j; }
        if (h > rowmax) { rowmax = h; mj = j; }
      }
      if (last && j <= p.Lt && h > gmx) { gmx = h; gix = j; }
    }
    if (last) {
      warp_argmax(gmx, gix);
      gscore = gmx;
      gtle = gix;
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

// ---------------------------------------------------------------------------
// K5: one thread per NCH lanes, interleaved serial sweeps
// ---------------------------------------------------------------------------

template <int NCH>
__global__ void __launch_bounds__(128) rect_interleaved_kernel(
    Params p, int32_t* __restrict__ scratch, int T) {
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= T) return;
  const int TW = p.Lt + 1;
  const int oe_ins = p.o_ins + p.e_ins;
  // lane c of this thread is tid + c*T; its H row at
  // scratch[(2c*TW + j)*T + tid], its F row at scratch[((2c+1)*TW + j)*T + tid]
  int lane[NCH], ql[NCH], tl[NCH], rows[NCH];
  int best[NCH], bi[NCH], bj[NCH], zbest[NCH], zbi[NCH], zbj[NCH];
  int gscore[NCH], gtle[NCH];
  bool live[NCH];
  int maxrows = 0, jmax = 0;
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
    lane[c] = tid + c * T;
    const bool ok = lane[c] < p.M;
    const int lc = ok ? lane[c] : 0;
    ql[c] = ok ? p.qlen[lc] : 0;
    tl[c] = min(p.tlen[lc], p.Lt);
    rows[c] = ok ? min(ql[c], p.Lq) : 0;
    const int h0 = p.h0[lc];
    best[c] = 0; bi[c] = 0; bj[c] = 0;
    zbest[c] = h0; zbi[c] = 0; zbj[c] = 0;
    gscore[c] = NEG; gtle[c] = 0;
    live[c] = rows[c] > 0;
    maxrows = max(maxrows, rows[c]);
    jmax = max(jmax, tl[c]);
    int32_t* Hc = scratch + (size_t)(2 * c) * TW * T + tid;
    int32_t* Fc = scratch + (size_t)(2 * c + 1) * TW * T + tid;
    for (int j = 0; j <= p.Lt; ++j) {
      Hc[(size_t)j * T] = row0(j, h0, tl[c], p.o_del, p.e_del);
      Fc[(size_t)j * T] = NEG;
    }
  }
  for (int i = 0; i < maxrows; ++i) {
    bool any = false;
    int qi[NCH], diag[NCH], run[NCH], rowmax[NCH], mj[NCH], gmx[NCH],
        gix[NCH];
    const int8_t* tg[NCH];
    int32_t* Hc[NCH];
    int32_t* Fc[NCH];
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      live[c] = live[c] && i < rows[c];
      any = any || live[c];
      const int lc = lane[c] < p.M ? lane[c] : 0;
      qi[c] = live[c] ? p.query[(size_t)lc * p.Lq + i] : 4;
      tg[c] = p.target + (size_t)lc * p.Lt;
      Hc[c] = scratch + (size_t)(2 * c) * TW * T + tid;
      Fc[c] = scratch + (size_t)(2 * c + 1) * TW * T + tid;
      diag[c] = NEG;
      run[c] = NEG;
      rowmax[c] = -1; mj[c] = 0;
      gmx[c] = INT_MIN; gix[c] = 0;
    }
    if (!any) break;
    // a lane that is no longer live keeps sweeping (its state is never
    // read again); only its outputs are guarded
    for (int j = 0; j <= jmax; ++j) {
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        const size_t a = (size_t)j * T;
        const int hp = Hc[c][a];
        const int f = max(hp - oe_ins, Fc[c][a] - p.e_ins);
        const int hnd = j >= 1
            ? max(diag[c] + subst(tg[c][j - 1], qi[c], p.match,
                                  p.mismatch), f)
            : max(f, NEG);
        diag[c] = hp;
        const int E = run[c] - p.o_del - p.e_del * j;
        run[c] = max(run[c], hnd + p.e_del * j);
        int h = max(hnd, E);
        if (j > tl[c]) h = NEG;
        Hc[c][a] = h;
        Fc[c][a] = f;
        if (live[c]) {
          if (j >= 1) {
            if (h > best[c]) { best[c] = h; bi[c] = i; bj[c] = j; }
            if (h > rowmax[c]) { rowmax[c] = h; mj[c] = j; }
          }
          if (h > gmx[c]) { gmx[c] = h; gix[c] = j; }
        }
      }
    }
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      if (!live[c]) continue;
      if (i == ql[c] - 1) {
        // columns (jmax, Lt] are NEG and never the smallest argmax
        // unless the whole row is NEG, where column 0 wins anyway
        gscore[c] = gmx[c];
        gtle[c] = gix[c];
      }
      if (p.zdrop > 0 &&
          zdrop_stop(i, rowmax[c], mj[c], zbest[c], zbi[c], zbj[c],
                     p.e_del, p.e_ins, p.zdrop))
        live[c] = false;
    }
  }
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
    if (lane[c] >= p.M) continue;
    const bool found = best[c] > 0;
    p.out[lane[c]] = found ? best[c] : 0;
    p.out[p.M + lane[c]] = found ? bi[c] + 1 : 0;
    p.out[2 * p.M + lane[c]] = found ? bj[c] : 0;
    p.out[3 * p.M + lane[c]] = gscore[c];
    p.out[4 * p.M + lane[c]] = gtle[c];
  }
}

Params make_params(const void* query, const void* qlen, const void* target,
                   const void* tlen, const void* h0, void* out, int M,
                   int Lq, int Lt, int o_del, int e_del, int o_ins,
                   int e_ins, int match, int mismatch, int zdrop) {
  Params p;
  p.query = static_cast<const int8_t*>(query);
  p.qlen = static_cast<const int32_t*>(qlen);
  p.target = static_cast<const int8_t*>(target);
  p.tlen = static_cast<const int32_t*>(tlen);
  p.h0 = static_cast<const int32_t*>(h0);
  p.out = static_cast<int32_t*>(out);
  p.M = M; p.Lq = Lq; p.Lt = Lt;
  p.o_del = o_del; p.e_del = e_del; p.o_ins = o_ins; p.e_ins = e_ins;
  p.match = match; p.mismatch = mismatch; p.zdrop = zdrop;
  return p;
}

// register slots per thread for Lt + 1 columns: 4, 8, 16 or 32
int slots_for(int Lt) {
  const int need = (Lt + 1 + 31) / 32;
  int s = 4;
  while (s < need) s *= 2;
  return s;
}

}  // namespace

extern "C" int sw_rect_max_width() { return 32 * MAX_SLOTS - 1; }

// out: int32 [5, M] = score, qle, tle, gscore, gtle.  Lt <= 1023.
extern "C" int sw_extend_rect(const void* query, const void* qlen,
                              const void* target, const void* tlen,
                              const void* h0, void* out, int M, int Lq,
                              int Lt, int o_del, int e_del, int o_ins,
                              int e_ins, int match, int mismatch, int zdrop,
                              void* stream) {
  if (M > 0) {
    const Params p = make_params(query, qlen, target, tlen, h0, out, M, Lq,
                                 Lt, o_del, e_del, o_ins, e_ins, match,
                                 mismatch, zdrop);
    const int threads = 128;
    const int blocks = (int)(((long long)M * 32 + threads - 1) / threads);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (slots_for(Lt)) {
      case 4: rect_strip_kernel<4><<<blocks, threads, 0, st>>>(p); break;
      case 8: rect_strip_kernel<8><<<blocks, threads, 0, st>>>(p); break;
      case 16: rect_strip_kernel<16><<<blocks, threads, 0, st>>>(p); break;
      default: rect_strip_kernel<32><<<blocks, threads, 0, st>>>(p); break;
    }
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sw_extend_rect_blocked(const void* query, const void* qlen,
                                      const void* target, const void* tlen,
                                      const void* h0, void* out, int M,
                                      int Lq, int Lt, int o_del, int e_del,
                                      int o_ins, int e_ins, int match,
                                      int mismatch, int zdrop, void* stream) {
  if (M > 0) {
    const Params p = make_params(query, qlen, target, tlen, h0, out, M, Lq,
                                 Lt, o_del, e_del, o_ins, e_ins, match,
                                 mismatch, zdrop);
    const int threads = 128;
    const int blocks = (int)(((long long)M * 32 + threads - 1) / threads);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (slots_for(Lt)) {
      case 4: rect_blocked_kernel<4><<<blocks, threads, 0, st>>>(p); break;
      case 8: rect_blocked_kernel<8><<<blocks, threads, 0, st>>>(p); break;
      case 16: rect_blocked_kernel<16><<<blocks, threads, 0, st>>>(p); break;
      default: rect_blocked_kernel<32><<<blocks, threads, 0, st>>>(p); break;
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// scratch: int32 [nch * 2 * (Lt + 1) * ceil(M / nch)]; nch in {2, 3}.
extern "C" int sw_extend_rect_interleaved(
    const void* query, const void* qlen, const void* target,
    const void* tlen, const void* h0, void* out, void* scratch, int M,
    int Lq, int Lt, int nch, int o_del, int e_del, int o_ins, int e_ins,
    int match, int mismatch, int zdrop, void* stream) {
  if (nch != 2 && nch != 3) return static_cast<int>(cudaErrorInvalidValue);
  if (M > 0) {
    const Params p = make_params(query, qlen, target, tlen, h0, out, M, Lq,
                                 Lt, o_del, e_del, o_ins, e_ins, match,
                                 mismatch, zdrop);
    const int T = (M + nch - 1) / nch;
    const int threads = 128;
    const int blocks = (T + threads - 1) / threads;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    int32_t* sc = static_cast<int32_t*>(scratch);
    if (nch == 2)
      rect_interleaved_kernel<2><<<blocks, threads, 0, st>>>(p, sc, T);
    else
      rect_interleaved_kernel<3><<<blocks, threads, 0, st>>>(p, sc, T);
  }
  return static_cast<int>(cudaGetLastError());
}
