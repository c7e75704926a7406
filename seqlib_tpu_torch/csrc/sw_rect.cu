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
// and writes 20 B) but the dependent integer work of the DP, at least 8
// int32 instructions per cell (bench_sw.OPS_PER_CELL), with the E
// (deletion) recurrence making each cell of a row depend on every cell
// to its left.  At the extension bench's shape (1024 lanes, 150 x 251
// cells) a call is at most 38.6 M cells, and z-drop stops most lanes
// early (6.8 M cells needed), so a call lasts about as long as its
// longest lane's dependent chain.
//
// The designs, all three a pipelined-row wavefront (pipe_rect below): a
// lane gets a segment of P threads, each owning a contiguous strip of S
// columns in registers, and thread t computes row i - t while thread 0
// computes row i: the E carry, the left edge's H and the row's running
// maxima pass one thread to the right each step by independent
// shuffles, so no row pays a warp scan or a warp argmax; the lane's
// last live thread sees each row complete, in order, and alone keeps
// the best cell, gscore and the z-drop test.  Each step costs one
// shuffle latency plus S cells of ~11-13 int32 instructions (Hopper's
// DPX add-max, __viaddmax_s32, for F, H and E), and a lane takes its
// rows + P - 1 steps (+1 for the stop to reach every thread).
// * K4 (the TPU kernel's blocked scan, which kept the whole row in one
//   core's lanes) takes P = 32, a warp per lane.
// * K5 (the TPU kernel's NCH independent row chains interleaved in one
//   core) takes P = 32 / nch: nch lanes side by side in a warp, with no
//   state outside registers.
// * K3 (the TPU kernel's rows in order, E by a log-step prefix max)
//   chooses its segment per call (k3_shape: P - 1 fill steps a lane
//   against S serial cells a step against the warps each scheduler
//   carries) and runs in K4's or K5's kernel: at the bench's 1024 lanes
//   of 150 x 250, P = 16 and S = 16.  A form with two lanes in each
//   register (s16x2 DPX) lost to it at that batch size (PERF.md §6).
//
// Shared semantics (those of the plain version):
// * row 0: H(0,0) = h0, H(0,j) = h0 - o_del - e_del*j, NEG where < 0;
// * columns j > tlen are NEG (dead); nothing flows leftwards, so the
//   live columns never read them;
// * best cell: highest score, then earliest row, then smallest column
//   (a strict '>' over the row maxima, which arrive in row order);
//   score <= 0 reports (0, 0, 0);
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
constexpr int NEG16 = -16384;  // extend_rect: a gscore at or below is dead

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

__device__ __forceinline__ int row0(int j, int h0, int tl, int o_del,
                                    int e_del) {
  int v = j == 0 ? h0 : h0 - (o_del + e_del * j);
  if (j > 0 && v < 0) v = NEG;
  return j > tl ? NEG : v;
}

// ---------------------------------------------------------------------------
// K3, K4 and K5: pipelined-row wavefront
// ---------------------------------------------------------------------------

// One lane on a segment of P consecutive threads of a warp (32 / P
// segments per warp; threads past the last whole segment idle).  Thread
// tt of the segment owns the columns [tt*S, tt*S + S) and at step k
// computes row i = k - tt, so the segment works on P rows at once, each
// thread one row behind its left neighbour.  H(i-1, .) and F(i-1, .) are
// the thread's own registers from the step before; the left edge of row
// i comes from thread tt-1, which finished it one step earlier, by one
// shuffle per value (none depends on another):
// * H(i, j0-1), kept for the next step's diagonal input;
// * E(i, j0), the deletion score entering the strip, carried as
//   u = E + o_del + e_del so that a cell's H and the next column's E
//   are one DPX add-max each;
// * the row's running (max, smallest column) over columns 1..j0-1, and
//   H(i, 0) (column 0 counts for gscore, not for the row max).
// The thread that owns column tl (tlast; threads past it hold dead
// columns only and compute nothing) so sees every row complete, in
// order, tlast steps after thread 0 started it.  It alone keeps the best
// cell (from the row maxima, strict '>'), gscore/gtle of row qlen - 1
// and the z-drop state; when it stops the lane, the cells of later rows
// that its left neighbours computed meanwhile are dropped, since no
// other thread accumulates anything.  Its word (stopped or finished)
// is broadcast with one shuffle and read one step later, so neither
// the broadcast nor the warp vote waits in the step's dependent chain;
// the carries are shuffled before the owner's row-end work, which
// overlaps their latency.
// the segment's thread that owns column tl (its last live thread): a row
// of a lane of tlen tl ends there, tlast steps after thread 0 starts it
__host__ __device__ __forceinline__ int pipe_last(int tl, int P, int S) {
  const int t = (tl > 0 ? tl : 0) / S;
  return t < P - 1 ? t : P - 1;
}

template <int P, int S>
__device__ __forceinline__ void pipe_rect(const Params& p, int lane) {
  static_assert(P >= 1 && P <= 32 && S >= 1 && S <= 32, "segment shape");
  const int t = threadIdx.x & 31;
  const int tt = t % P;
  const int seg0 = t - tt;
  const bool ok = seg0 + P <= 32 && lane < p.M;
  const int lc = ok ? lane : 0;
  const int ql = ok ? p.qlen[lc] : 0;
  const int tl = ok ? min(p.tlen[lc], p.Lt) : 0;
  const int h0 = ok ? p.h0[lc] : 0;
  const int rows = max(min(ql, p.Lq), 0);
  const int j0 = tt * S;
  const int tlast = pipe_last(tl, P, S);
  const int own = seg0 + tlast;
  const bool live = ok && tt <= tlast;
  const int8_t* q = p.query + (size_t)lc * p.Lq;
  const int8_t* tg = p.target + (size_t)lc * p.Lt;
  const int oe_ins = p.o_ins + p.e_ins, oe_del = p.o_del + p.e_del;
  const int u_left = NEG + p.e_del;  // E(i, 0) + o_del + e_del
  const int src = t > 0 ? t - 1 : 0;

  // H and F of the row last computed; cap: INT_MAX on live columns, NEG
  // on dead ones (j > tl), which only the reductions read: a dead cell
  // feeds dead cells alone (below, to the right), so H is not masked
  int H[S], F[S], tc[S], cap[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int j = j0 + s;
    tc[s] = (live && j >= 1 && j <= p.Lt) ? tg[j - 1] : 4;
    H[s] = row0(j, h0, tl, p.o_del, p.e_del);
    F[s] = NEG;
    cap[s] = j <= tl ? INT_MAX : NEG;
  }
  // from the left neighbour: hl = H(i, j0-1) of the row computed next,
  // hd = H(i-1, j0-1); uin = E(i, j0) + o_del + e_del; (gin, gjin) = max
  // over columns 1..j0-1 and its smallest column; c0in = H(i, 0)
  int hl = tt == 0 ? NEG : row0(j0 - 1, h0, tl, p.o_del, p.e_del);
  int hd = hl;
  int uin = u_left, gin = INT_MIN, gjin = 0, c0in = NEG;
  // the owner's state
  int best = 0, bi = 0, bj = 0;
  int zbest = h0, zbi = 0, zbj = 0;
  int gscore = NEG, gtle = 0;
  bool oend = false;  // owner: stopped by z-drop or past the last row
  bool done = !ok || rows == 0, heard = false;
  int qn = live && rows > 0 ? q[0] : 0;

  for (int k = 0;; ++k) {
    const int i = k - tt;
    const int qi = qn;
    if (live && i + 1 >= 0 && i + 1 < rows) qn = q[i + 1];
    const bool run = !done && live && i >= 0 && i < rows;
    int uout = uin, gout = gin, gjout = gjin, c0out = c0in;
    if (run) {
      const int qx = qi < 4 ? qi : INT_MAX;  // N never matches
      int diag = hd, u = uin, m = INT_MIN, mi = 0;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        // f = max(hp - o_ins - e_ins, F - e_ins); hnd = max(diag + sc, f)
        // (column 0: max(f, NEG)); with u = E + o_del + e_del,
        // h = max(hnd, E) and the next column's u = max(u - e_del, hnd)
        const int hp = H[s];
        const int f = __viaddmax_s32(hp, -oe_ins, F[s] - p.e_ins);
        int hnd = __viaddmax_s32(
            diag, tc[s] == qx ? p.match : -p.mismatch, f);
        if (s == 0 && tt == 0) hnd = max(f, NEG);
        diag = hp;
        const int h = __viaddmax_s32(u, -oe_del, hnd);
        u = __viaddmax_s32(u, -p.e_del, hnd);
        H[s] = h;
        F[s] = f;
        // the strip's max over live columns >= 1, its first slot
        bool keep;
        m = __vibmax_s32(m, s == 0 && tt == 0 ? INT_MIN : min(h, cap[s]),
                         &keep);
        mi = keep ? mi : s;
      }
      if (m > gin) {
        gout = m;
        gjout = j0 + mi;
      }
      uout = u;
      if (tt == 0) c0out = H[0];
    }
    done = done || heard;  // the owner's word from the step before
    const bool all = __all_sync(FULL, done);
    hd = hl;
    hl = __shfl_sync(FULL, H[S - 1], src);
    uin = __shfl_sync(FULL, uout, src);
    gin = __shfl_sync(FULL, gout, src);
    gjin = __shfl_sync(FULL, gjout, src);
    c0in = __shfl_sync(FULL, c0out, src);
    if (tt == 0) {
      hl = NEG;
      uin = u_left;
      gin = INT_MIN;
    }
    if (run && tt == tlast && !oend) {
      // row i is complete here: (rowmax, mj) clamped at -1 as the plain
      // version's z-drop row max
      const int rm = gout > -1 ? gout : -1;
      const int rj = gout > -1 ? gjout : 0;
      if (rm > best) {
        best = rm;
        bi = i;
        bj = rj;
      }
      if (i == ql - 1) {
        gscore = c0out >= gout ? c0out : gout;
        gtle = c0out >= gout ? 0 : gjout;
      }
      oend = i == rows - 1 ||
             (p.zdrop > 0 && zdrop_stop(i, rm, rj, zbest, zbi, zbj,
                                        p.e_del, p.e_ins, p.zdrop));
    }
    heard = __shfl_sync(FULL, oend, own);
    if (all) break;
  }
  if (ok && tt == tlast) {
    // a row with no live column (tlen < 0) is all dead: the plain
    // version's rule for it
    const bool dead = gscore <= NEG16;
    write_lane(p.out, p.M, lane, best, bi, bj, dead ? NEG : gscore,
               dead ? 0 : gtle);
  }
}

// K4: one lane per warp (P = 32); K3 at P = 32
template <int S>
__global__ void __launch_bounds__(128) rect_blocked_kernel(Params p) {
  pipe_rect<32, S>(p, (blockIdx.x * blockDim.x + threadIdx.x) >> 5);
}

// K5: 32 / P lanes per warp, side by side (P = 32 / nch); K3 at P = 8, 16
template <int P, int S>
__global__ void __launch_bounds__(128) rect_interleaved_kernel(Params p) {
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  pipe_rect<P, S>(p, warp * (32 / P) + (threadIdx.x & 31) / P);
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

// register slots per thread for Lt + 1 columns over P threads: the
// smallest of 4, 8, 16, 32 with P * S >= Lt + 1, or 0 if none is
int slots_for(int Lt, int P = 32) {
  int s = 4;
  while (s < 32 && s * P < Lt + 1) s *= 2;
  return s * P >= Lt + 1 ? s : 0;
}

// the pipelined kernels' segment shape for targets of Lt columns: P
// threads a lane (K4, nch = 1: 32; K5: 32 / nch, widened to 16, then 32,
// threads while Lt + 1 columns do not fit in P threads of 32 slots) and
// S slots a thread
void pipe_shape(int Lt, int nch, int& P, int& S) {
  P = 32 / nch;
  while (slots_for(Lt, P) == 0) P = P < 16 ? 16 : 32;
  S = slots_for(Lt, P);
}

// the kernels' Hopper facts: 4 schedulers an SM, each issuing an int32
// (or DPX) warp instruction every 2 clocks, 16 lanes a clock
int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess || n <= 0) {
      cudaGetLastError();  // not sticky: leave no error for the launch
      n = 132;
    }
  }
  return n;
}

// K3's segment shape for M lanes of Lq x Lt: P threads (8, 16 or 32)
// and S = slots_for(Lt, P), the one of least estimated time.  A lane
// takes up to Lq + P steps (its rows, unknown before the run, at most
// Lq, and the pipeline's fill), a step about 12 S + 59 warp instructions
// (the SASS count of the step loop, 251 at S = 16, PERF.md), and a
// scheduler with more than one warp issues for all of them: the estimate
// trades P - 1 fill steps a lane, S serial cells a step and the warps
// each of the 4 * SMs schedulers carries.
void k3_shape(int M, int Lq, int Lt, int& P, int& S) {
  const double schedulers = 4.0 * sm_count();
  double best = -1;
  P = 32;
  S = slots_for(Lt, 32);
  for (int cand = 8; cand <= 32; cand *= 2) {
    const int s = slots_for(Lt, cand);
    if (s == 0) continue;
    const double warps = (double)((M + 32 / cand - 1) / (32 / cand));
    const double load = warps > schedulers ? warps / schedulers : 1.0;
    const double cost = (double)(Lq + cand) * (12 * s + 59) * load;
    if (best < 0 || cost < best) {
      best = cost;
      P = cand;
      S = s;
    }
  }
}

void launch_blocked(int S, int blocks, cudaStream_t st, const Params& p) {
  switch (S) {
    case 4: rect_blocked_kernel<4><<<blocks, 128, 0, st>>>(p); break;
    case 8: rect_blocked_kernel<8><<<blocks, 128, 0, st>>>(p); break;
    case 16: rect_blocked_kernel<16><<<blocks, 128, 0, st>>>(p); break;
    default: rect_blocked_kernel<32><<<blocks, 128, 0, st>>>(p); break;
  }
}

template <int P>
void launch_interleaved(int S, int blocks, cudaStream_t st, const Params& p) {
  switch (S) {
    case 4: rect_interleaved_kernel<P, 4><<<blocks, 128, 0, st>>>(p); break;
    case 8: rect_interleaved_kernel<P, 8><<<blocks, 128, 0, st>>>(p); break;
    case 16: rect_interleaved_kernel<P, 16><<<blocks, 128, 0, st>>>(p); break;
    default: rect_interleaved_kernel<P, 32><<<blocks, 128, 0, st>>>(p); break;
  }
}

// K3 on k3_shape's segment, in K4's kernel (P = 32) or K5's (P = 8, 16)
void launch_k3(int M, int Lq, int Lt, cudaStream_t st, const Params& p) {
  int P, S;
  k3_shape(M, Lq, Lt, P, S);
  const long long warps = (M + 32 / P - 1) / (32 / P);
  const int blocks = (int)((warps * 32 + 127) / 128);
  if (P == 8)
    launch_interleaved<8>(S, blocks, st, p);
  else if (P == 16)
    launch_interleaved<16>(S, blocks, st, p);
  else
    launch_blocked(S, blocks, st, p);
}

}  // namespace

extern "C" int sw_rect_max_width() { return 32 * MAX_SLOTS - 1; }

// K4 (nch = 1) and K5 (nch 2, 3) on targets of Lt columns: the index of
// the thread of its segment where a lane of tlen tl ends each row, so the
// lane takes its rows + that many steps of the pipeline; -1 for a shape
// the launchers refuse
extern "C" int sw_rect_pipe_last(int Lt, int nch, int tl) {
  if (nch < 1 || nch > 3 || Lt < 0 || Lt > 32 * MAX_SLOTS - 1) return -1;
  int P, S;
  pipe_shape(Lt, nch, P, S);
  return pipe_last(tl < Lt ? tl : Lt, P, S);
}

// K3's segment for M lanes of Lq x Lt: P * 64 + S (P threads a segment,
// S slots a thread); -1 for a shape the launcher refuses
extern "C" int sw_rect_k3_shape(int M, int Lq, int Lt) {
  if (Lt < 0 || Lt > 32 * MAX_SLOTS - 1) return -1;
  int P, S;
  k3_shape(M, Lq, Lt, P, S);
  return P * 64 + S;
}

// K3: out int32 [5, M] = score, qle, tle, gscore, gtle.  Lt <= 1023.
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
    launch_k3(M, Lq, Lt, static_cast<cudaStream_t>(stream), p);
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
    int P, S;
    pipe_shape(Lt, 1, P, S);
    launch_blocked(S, blocks, st, p);
  }
  return static_cast<int>(cudaGetLastError());
}

// nch in {2, 3}: lanes side by side in a warp, P = 32 / nch threads each;
// a target too wide for P threads of 32 slots takes 16, then 32, threads
// a lane (fewer lanes a warp), so every Lt <= 1023 runs.
extern "C" int sw_extend_rect_interleaved(
    const void* query, const void* qlen, const void* target,
    const void* tlen, const void* h0, void* out, int M, int Lq, int Lt,
    int nch, int o_del, int e_del, int o_ins, int e_ins, int match,
    int mismatch, int zdrop, void* stream) {
  if (nch != 2 && nch != 3) return static_cast<int>(cudaErrorInvalidValue);
  if (M > 0) {
    const Params p = make_params(query, qlen, target, tlen, h0, out, M, Lq,
                                 Lt, o_del, e_del, o_ins, e_ins, match,
                                 mismatch, zdrop);
    int P, S;
    pipe_shape(Lt, nch, P, S);
    const long long warps = (M + 32 / P - 1) / (32 / P);
    const int blocks = (int)((warps * 32 + 127) / 128);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (P == 10)
      launch_interleaved<10>(S, blocks, st, p);
    else if (P == 16)
      launch_interleaved<16>(S, blocks, st, p);
    else
      rect_interleaved_kernel<32, 32><<<blocks, 128, 0, st>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}
