// The banded global DP and its traceback in one launch, bit-exact with the
// plain PyTorch route seqlib_tpu_torch/align/device_pipeline.py::
// global_and_traceback (ops/sw.py::global_batch, then the torch walk).
//
// Replaces no TPU kernel: the JAX package runs this stage in XLA
// (seqlib_tpu/ops/sw.py::global_batch, align/device_pipeline.py::
// global_and_traceback).  The port's plain route, run on the card, is two
// Python loops of small operations: ~55 a query row for the DP, ~40 a
// traceback step, and one device read every 8 steps.  At the benchmark's
// 65,536-read batches that was ~20,000 launches and 22 device reads a
// batch, and 85% of the fused program's device time (453-772 ms a batch,
// against a bound of about 1 ms: 8 int32 operations and one direction byte
// a band cell, roofline.global_dp_bound_ms).  This kernel does the stage
// of a batch in one launch, with no read by the host.
//
// What it computes, per row r of M: H/E/F over query rows i < min(ql, Lq)
// and target columns 0..Lt, the plain version's surrogates and all:
//   - row 0 is H = 0, -(o_del + e_del*j), NEG past tl; F = NEG;
//   - M = H(i-1, j-1) + (q[i] == t[j-1] < 4 ? match : -mismatch);
//     F = max(H(i-1, j) - o_ins - e_ins, F(i-1, j) - e_ins), never masked;
//     hnd = max(M, F), column 0's hnd -(o_ins + e_ins*(i+1));
//     E(j) = max_{j'<j}(hnd(j') + e_del*j') - o_del - e_del*j (NEG - o_del
//     at column 0); H = max(hnd, E), then NEG outside j <= tl and
//     |j - (i+1)| <= band;
//   - each cell's direction code: the H source (M, then E, then F; column
//     0 always F) | E-extend | F-extend | mismatch bits, the same values
//     and tie order as ops/sw.py;
//   - score = H(last row, clamp(tl, 0, Lt)); then the walk from (ql, tl)
//     to (0, 0) with the plain walk's state machine, at most
//     T = (2(Lq + Lt) + 7) / 4 * 4 steps, and NM;
//   - the walk's ops as CIGAR runs: a run ends where the op changes, and
//     the OP_NONE steps (a state change inside the walk) neither end a
//     run nor count, as the plain route's run-length encoding of its step
//     codes.  A run is one int32 word, the op in the top 2 bits and the
//     length in the low 30, and a row's runs come out in forward 2L
//     order (the reverse of the walk's).
// A row whose end cell lies outside the band gets the same NEG-derived
// score, runs and NM as the plain version: nothing is "repaired".
//
// Design: one warp per row (K1's shape, csrc/sw_extend.cu), four warps a
// block.  Thread t holds a strip of S consecutive columns of H and F in
// registers, S the smallest instance with 32*S >= Lt + 1 (4, 8, 10 -- the
// fused path's Lt = 288 -- or 16).  A DP row is two passes over the strip
// and one warp scan: pass 1 computes F, M and hnd (the diagonal of the
// strip's first column comes from thread t - 1 by one shuffle); E is the
// exclusive warp prefix-max of hnd + e_del*j, exactly the plain
// _row_scan_E; pass 2 computes E, H and the code.  The E-extend bit of
// column j, E(j-1) - e_del >= E(j), is the same comparison as "the running
// max before column j-1 is at least column j-1's term", so it falls out of
// pass 2 with one shuffle for the strip's first column.  A target wider
// than 512 columns (long reads, the wide band) takes the chunked instance:
// the row is swept in chunks of 512 columns, H and F kept in a global row
// buffer of the warp's own, with the diagonal, E's running max and the
// E-extend bit carried from chunk to chunk.  The query code of a row is a
// shuffle of a register that holds 32 rows; the target codes of a strip
// stay in registers for the whole row (in the chunked instance they are
// reloaded a chunk, through L1).  No shared memory.
//
// Direction codes go to a slab in device memory: the warp's own, one byte
// a cell, rows i < min(ql, Lq) of 32*S*chunks bytes, laid out
// [chunk][slot][thread] so that each store of a pass is 32 contiguous
// bytes.  The grid is persistent: as many warps as the card holds at once
// (W = min(M, SMs x resident blocks x 4)), warp w taking rows w, w + W,
// ...  So the slab is W x Lq x 32*S bytes whatever M is (189 MB at the
// fused shape against the plain route's M x 46 KB, 2.3 GB at its row
// cap), and the caching allocator reuses it from call to call.  The same
// warp then walks its slab from (ql, tl) to (0, 0): the walk is serial,
// one dependent byte load a step, and runs in lockstep on all 32 threads
// (the load a broadcast), while the card's other warps run their DP.
//
// Runs: every op of the walk passes through thread 0, which keeps the
// open run and writes each finished one from the end of the row's slot
// backwards, so that the slot's last n words are the row's n runs in
// forward order, and then writes n.  Each M, D or I step moves (i, j)
// one cell nearer (0, 0), so a row whose lengths lie inside its windows
// (0 <= ql <= Lq, 0 <= tl <= Lt, as every caller's) has at most ql + tl
// runs, and a slot of Lq + Lt words holds them all (a row outside its
// windows keeps the first Lq + Lt runs its walk emits).  A second launch (global_dp_gather:
// a warp a row) copies the slots' runs to one flat array at the offsets
// the caller scanned from the counts, so the host reads only the runs.
//
// With a totals pointer (the tracer on) each warp takes the max of its
// rows' DP rows and exact walk steps and the sum of their runs, then one
// atomic per total: the tracer's global_dp.dp_rows_run, traceback.steps
// and traceback.runs.  The plain route rounds its traceback.steps up to a
// multiple of 8 (it looks every 8 steps); the kernel's is the exact
// longest walk.

#include <cuda_runtime.h>
#include <algorithm>
#include <climits>
#include <cstdint>
#include <cstdlib>

namespace {

constexpr int NEG = -0x40000000;  // -inf surrogate that survives additions
constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = 4;          // rows (warps) a block
constexpr int CHUNK_SLOTS = 16;   // S of the chunked instance: 512 columns
// direction codes (ops/sw.py)
constexpr int DIR_M = 0, DIR_E = 1, DIR_F = 2;
constexpr int BIT_EEXT = 4, BIT_FEXT = 8, BIT_MIS = 16;
constexpr int BIT_MGE = 128;      // scratch: M >= F at the cell, never stored
// walk ops (align/device_pipeline.py)
constexpr int OP_M = 0, OP_D = 1, OP_I = 2, OP_NONE = 3;
// a query code of 4 or more matches nothing, nor does a target code of 4
// or more, nor a slot with no target column
constexpr int Q_NONE = -1;
constexpr int T_NONE = -2;
constexpr int GATHER_BLOCKS = 4096;  // blocks of the gather's grid, at most

// a CIGAR run as one word: the op in the top 2 bits, the length below
__device__ __forceinline__ int32_t run_word(int op, int len) {
  return (int32_t)(((unsigned)op << 30) | (unsigned)len);
}

struct Params {
  const uint8_t* q;
  const int32_t* ql;
  const uint8_t* t;
  const int32_t* tl;
  int32_t* score;
  int32_t* nm;
  long long* counts;  // runs a row
  int32_t* runs;      // a slot of R words a row
  unsigned long long* totals;  // [dp rows, walk steps, runs] or null
  uint8_t* slab;
  int32_t* buf;
  size_t slab_warp;  // bytes of a warp's slab: Lq x stride
  int buf_warp;      // int32 of a warp's row buffer (chunked instance)
  int stride;        // bytes of a slab row: chunks x 32 x S
  int M, Lq, Lt, band, warps, nch, T, R;
  int o_del, e_del, o_ins, e_ins, match, mismatch;
};

// what one chunk of a DP row hands the next, to its right
struct Carry {
  int hdiag;   // the previous row's H in the column left of the chunk
  int run;     // max of hnd + e_del*j over the columns left of the chunk
  int eext;    // the E-extend bit of the chunk's first column
  bool first;  // the chunk starts at column 0
};

// one chunk of DP row i (columns c0 + t*S + k): H and F hold the previous
// row on entry and this row on exit; cd gets the direction codes
template <int S>
__device__ __forceinline__ void dp_chunk(int (&H)[S], int (&F)[S],
                                         int (&cd)[S], const int (&tc)[S],
                                         int qe, int i, int c0, int tl,
                                         const Params& p, Carry& c) {
  const int t = threadIdx.x & 31;
  const int j0 = c0 + t * S;
  const int oe_ins = p.o_ins + p.e_ins;
  int diag = __shfl_up_sync(FULL, H[S - 1], 1);
  const int hlast = __shfl_sync(FULL, H[S - 1], 31);
  if (t == 0) diag = c.hdiag;
  // pass 1: F, M, hnd; the strip's max of hnd + e_del*j
  int g = INT_MIN;
#pragma unroll
  for (int k = 0; k < S; ++k) {
    const int j = j0 + k;
    const int old = H[k];
    const bool mt = tc[k] == qe;
    const int mv = diag + (mt ? p.match : -p.mismatch);
    const int fo = old - oe_ins, fx = F[k] - p.e_ins;
    const int fn = max(fo, fx);
    int code = fx >= fo ? BIT_FEXT : 0;
    int hnd;
    if (k == 0 && j0 == 0) {
      hnd = -(p.o_ins + p.e_ins * (i + 1));
    } else {
      hnd = max(mv, fn);
      code |= (mt ? 0 : BIT_MIS) | (mv >= fn ? BIT_MGE : 0);
    }
    F[k] = fn;
    H[k] = hnd;
    cd[k] = code;
    g = max(g, hnd + p.e_del * j);
    diag = old;
  }
  // E's running max entering the strip: the exclusive warp prefix max
  int incl = g;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(FULL, incl, d);
    if (t >= d) incl = max(incl, v);
  }
  const int excl = __shfl_up_sync(FULL, incl, 1);
  const int total = __shfl_sync(FULL, incl, 31);
  int run = t == 0 ? c.run : (c.first ? excl : max(excl, c.run));
  // pass 2: E, H, the H source; bit k + 1 of eb is column j0 + k + 1's
  // E-extend bit (E(j-1) - e_del >= E(j) is run(j-1) >= term(j-1))
  unsigned eb = 0;
#pragma unroll
  for (int k = 0; k < S; ++k) {
    const int j = j0 + k;
    const int hnd = H[k];
    const int term = hnd + p.e_del * j;
    const int e = run - p.o_del - p.e_del * j;
    if (run >= term) eb |= 2u << k;
    run = max(run, term);
    const int code = cd[k];
    int src = ((code & BIT_MGE) && hnd >= e) ? DIR_M
                                             : (e >= hnd ? DIR_E : DIR_F);
    if (k == 0 && j0 == 0) src = DIR_F;
    cd[k] = (code & ~BIT_MGE) | src;
    const int hn = max(hnd, e);
    H[k] = (j <= tl && abs(j - (i + 1)) <= p.band) ? hn : NEG;
  }
  const unsigned up = __shfl_up_sync(FULL, eb >> S, 1) & 1u;
  const unsigned next = __shfl_sync(FULL, eb >> S, 31) & 1u;
  eb |= t == 0 ? (unsigned)c.eext : up;
#pragma unroll
  for (int k = 0; k < S; ++k)
    if ((eb >> k) & 1u) cd[k] |= BIT_EEXT;
  c.hdiag = hlast;
  c.run = c.first ? total : max(total, c.run);
  c.eext = (int)next;
  c.first = false;
}

template <int S, bool CHUNKED>
__global__ void __launch_bounds__(WARPS * 32) global_dp_kernel(Params p) {
  const int t = threadIdx.x & 31;
  const int w = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (w >= p.warps) return;  // the whole warp leaves together
  constexpr int CW = 32 * S;  // columns a chunk
  const int nch = CHUNKED ? p.nch : 1;
  uint8_t* slab = p.slab + (size_t)w * p.slab_warp;
  int32_t* bh = CHUNKED ? p.buf + (size_t)w * p.buf_warp : nullptr;
  int32_t* bf = CHUNKED ? bh + (size_t)nch * CW : nullptr;
  unsigned long long most_rows = 0, most_steps = 0, all_runs = 0;
  const int e0 = NEG >= NEG - p.o_del;  // column 0's E-extend bit

  for (int r = w; r < p.M; r += p.warps) {
    __syncwarp();  // the last row's walk has read the slab
    const int ql = p.ql[r], tl = p.tl[r];
    const int rows = max(0, min(ql, p.Lq));
    const size_t qo = (size_t)r * p.Lq, to = (size_t)r * p.Lt;
    int H[S], F[S], cd[S], tc[S];

    // row 0 of the DP, and the strip's target codes
    for (int ch = 0; ch < nch; ++ch) {
      const int c0 = ch * CW;
#pragma unroll
      for (int k = 0; k < S; ++k) {
        const int j = c0 + t * S + k;
        const int v = j == 0 ? 0 : -(p.o_del + p.e_del * j);
        H[k] = j <= tl ? v : NEG;
        F[k] = NEG;
        int x = T_NONE;
        if (j >= 1 && j <= p.Lt) {
          const int y = p.t[to + j - 1];
          if (y < 4) x = y;
        }
        tc[k] = x;
        if (CHUNKED) {
          bh[(ch * S + k) * 32 + t] = H[k];
          bf[(ch * S + k) * 32 + t] = F[k];
        }
      }
    }

    int qv = 4;
    for (int i = 0; i < rows; ++i) {
      if ((i & 31) == 0)
        qv = i + t < p.Lq ? p.q[qo + i + t] : 4;
      const int qi = __shfl_sync(FULL, qv, i & 31);
      const int qe = qi < 4 ? qi : Q_NONE;
      Carry c{NEG, NEG, e0, true};
      uint8_t* srow = slab + (size_t)i * p.stride;
      for (int ch = 0; ch < nch; ++ch) {
        const int c0 = ch * CW;
        if (CHUNKED) {
#pragma unroll
          for (int k = 0; k < S; ++k) {
            const int j = c0 + t * S + k;
            H[k] = bh[(ch * S + k) * 32 + t];
            F[k] = bf[(ch * S + k) * 32 + t];
            int x = T_NONE;
            if (j >= 1 && j <= p.Lt) {
              const int y = p.t[to + j - 1];
              if (y < 4) x = y;
            }
            tc[k] = x;
          }
        }
        dp_chunk<S>(H, F, cd, tc, qe, i, c0, tl, p, c);
#pragma unroll
        for (int k = 0; k < S; ++k) {
          if (CHUNKED) {
            bh[(ch * S + k) * 32 + t] = H[k];
            bf[(ch * S + k) * 32 + t] = F[k];
          }
          srow[c0 + k * 32 + t] = (uint8_t)cd[k];
        }
      }
    }

    // the score: H of the last row in column clamp(tl, 0, Lt)
    const int cs = min(max(tl, 0), p.Lt);
    if (CHUNKED) {
      __syncwarp();
      if (t == 0) {
        const int ch = cs / CW, jj = cs - ch * CW;
        p.score[r] = bh[(ch * S + jj % S) * 32 + jj / S];
      }
    } else {
#pragma unroll
      for (int k = 0; k < S; ++k)
        if (t * S + k == cs) p.score[r] = H[k];
    }

    // the walk, in lockstep on every thread; thread 0 writes the runs,
    // from the end of the row's slot backwards
    __syncwarp();
    int i = ql, j = tl, state = 0, nm = 0, s = 0;
    int cur = OP_NONE, len = 0, n = 0;
    int32_t* slot_end = p.runs + (size_t)(r + 1) * p.R;
    for (; s < p.T; ++s) {
      if (i == 0 && j == 0) break;
      int op;
      if (i == 0 && j > 0) {
        op = OP_D; ++nm; --j;
      } else if (j == 0 && i > 0) {
        op = OP_I; ++nm; --i;
      } else {
        // the plain walk's clamped gather; a row it never computed reads 0
        const int rr = min(max(i - 1, 0), p.Lq - 1);
        const int cc = min(max(j, 0), p.Lt);
        int code = 0;
        if (rr >= 0 && rr < rows) {
          const int ch = cc / CW, jj = cc - ch * CW;
          code = slab[(size_t)rr * p.stride + ch * CW + (jj % S) * 32
                      + jj / S];
        }
        if (state == 0) {
          const int src = code & 3;
          if (src == DIR_M) {
            op = OP_M; nm += (code & BIT_MIS) ? 1 : 0; --i; --j;
          } else {
            op = OP_NONE; state = src == DIR_E ? 1 : 2;
          }
        } else if (state == 1) {
          op = OP_D; ++nm; --j;
          if (!(code & BIT_EEXT)) state = 0;
        } else {
          op = OP_I; ++nm; --i;
          if (!(code & BIT_FEXT)) state = 0;
        }
      }
      if (op == OP_NONE) continue;
      if (op == cur) {
        ++len;
        continue;
      }
      if (len) {
        if (t == 0 && n < p.R) slot_end[-1 - n] = run_word(cur, len);
        ++n;
      }
      cur = op;
      len = 1;
    }
    if (len) {
      if (t == 0 && n < p.R) slot_end[-1 - n] = run_word(cur, len);
      ++n;
    }
    n = min(n, p.R);
    if (t == 0) {
      p.nm[r] = nm;
      p.counts[r] = n;
    }
    most_rows = max(most_rows, (unsigned long long)rows);
    most_steps = max(most_steps, (unsigned long long)s);
    all_runs += (unsigned long long)n;
  }
  if (p.totals && t == 0) {
    atomicMax(p.totals, most_rows);
    atomicMax(p.totals + 1, most_steps);
    atomicAdd(p.totals + 2, all_runs);
  }
}

// row r's runs, the last (off[r + 1] - off[r]) words of its slot of R, to
// out[off[r]...]: a warp a row, a grid-stride loop over the rows
__global__ void __launch_bounds__(WARPS * 32)
gather_runs_kernel(const int32_t* __restrict__ slots,
                   const long long* __restrict__ off,
                   int32_t* __restrict__ out, int M, int R) {
  const int t = threadIdx.x & 31;
  const int stride = gridDim.x * WARPS;
  for (int r = blockIdx.x * WARPS + (threadIdx.x >> 5); r < M; r += stride) {
    const long long o = off[r];
    const int n = (int)(off[r + 1] - o);
    const int32_t* src = slots + (size_t)(r + 1) * R - n;
    for (int k = t; k < n; k += 32) out[o + k] = src[k];
  }
}

template <int S, bool CHUNKED>
int resident_warps(int* warps) {
  int dev = 0, sms = 0, blocks = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, global_dp_kernel<S, CHUNKED>, WARPS * 32, 0);
  *warps = sms * (blocks > 0 ? blocks : 1) * WARPS;
  return static_cast<int>(e);
}

template <int S, bool CHUNKED>
int launch(const Params& p, cudaStream_t st) {
  const int blocks = (p.warps + WARPS - 1) / WARPS;
  global_dp_kernel<S, CHUNKED><<<blocks, WARPS * 32, 0, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// the instance a target of Lt columns takes: 32*S >= Lt + 1, else chunks
// of 32 * CHUNK_SLOTS columns
struct Shape {
  int S, nch;
  bool chunked;
};

Shape shape_of(int Lt) {
  const int cols = Lt + 1;
  if (cols <= 128) return {4, 1, false};
  if (cols <= 256) return {8, 1, false};
  if (cols <= 320) return {10, 1, false};
  if (cols <= 512) return {16, 1, false};
  const int cw = 32 * CHUNK_SLOTS;
  return {CHUNK_SLOTS, (cols + cw - 1) / cw, true};
}

int resident_of(const Shape& sh, int* warps) {
  if (sh.chunked) return resident_warps<CHUNK_SLOTS, true>(warps);
  switch (sh.S) {
    case 4: return resident_warps<4, false>(warps);
    case 8: return resident_warps<8, false>(warps);
    case 10: return resident_warps<10, false>(warps);
    default: return resident_warps<16, false>(warps);
  }
}

int launch_of(const Shape& sh, const Params& p, cudaStream_t st) {
  if (sh.chunked) return launch<CHUNK_SLOTS, true>(p, st);
  switch (sh.S) {
    case 4: return launch<4, false>(p, st);
    case 8: return launch<8, false>(p, st);
    case 10: return launch<10, false>(p, st);
    default: return launch<16, false>(p, st);
  }
}

}  // namespace

// out (int64 [5]) for a call of query width Lq and target width Lt: slots
// a thread (S), chunks a row, slab bytes a row, the warps the card holds
// at once in that instance, int32 of a warp's row buffer (0 unless
// chunked).  The caller launches min(M, warps) warps and gives each a slab
// of Lq x (slab bytes a row) and a row buffer.
extern "C" int global_dp_plan(int Lq, int Lt, long long* out) {
  if (Lq < 0 || Lt < 0) return static_cast<int>(cudaErrorInvalidValue);
  const Shape sh = shape_of(Lt);
  int warps = 0;
  const int rc = resident_of(sh, &warps);
  if (rc != 0) return rc;
  out[0] = sh.S;
  out[1] = sh.nch;
  out[2] = (long long)sh.nch * 32 * sh.S;
  out[3] = warps;
  out[4] = sh.chunked ? 2LL * sh.nch * 32 * sh.S : 0;
  return 0;
}

// score, nm: int32 [M]; counts: int64 [M], each row's runs; runs: int32
// [M, Lq + Lt], a slot a row whose last counts[r] words are row r's runs;
// totals: uint64 [3] (zeroed) or null; slab: warps x Lq x (slab bytes a
// row); buf: warps x (row buffer int32), or null when not chunked.  q, t:
// uint8 codes [M, Lq], [M, Lt].
extern "C" int global_dp(const void* q, const void* ql, const void* t,
                         const void* tl, void* score, void* nm, void* counts,
                         void* runs, void* totals, void* slab, void* buf,
                         int M, int Lq, int Lt, int band, int o_del, int e_del,
                         int o_ins, int e_ins, int match, int mismatch,
                         int warps, void* stream) {
  if (M < 0 || Lq < 0 || Lt < 0 || warps < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0 || warps == 0) return static_cast<int>(cudaGetLastError());
  const Shape sh = shape_of(Lt);
  Params p;
  p.q = static_cast<const uint8_t*>(q);
  p.ql = static_cast<const int32_t*>(ql);
  p.t = static_cast<const uint8_t*>(t);
  p.tl = static_cast<const int32_t*>(tl);
  p.score = static_cast<int32_t*>(score);
  p.nm = static_cast<int32_t*>(nm);
  p.counts = static_cast<long long*>(counts);
  p.runs = static_cast<int32_t*>(runs);
  p.totals = static_cast<unsigned long long*>(totals);
  p.slab = static_cast<uint8_t*>(slab);
  p.buf = static_cast<int32_t*>(buf);
  p.stride = sh.nch * 32 * sh.S;
  p.slab_warp = (size_t)Lq * p.stride;
  p.buf_warp = sh.chunked ? 2 * sh.nch * 32 * sh.S : 0;
  p.M = M; p.Lq = Lq; p.Lt = Lt; p.band = band; p.warps = warps;
  p.nch = sh.nch;
  p.T = (2 * (Lq + Lt) + 7) / 4 * 4;
  p.R = Lq + Lt;
  p.o_del = o_del; p.e_del = e_del; p.o_ins = o_ins; p.e_ins = e_ins;
  p.match = match; p.mismatch = mismatch;
  return launch_of(sh, p, static_cast<cudaStream_t>(stream));
}

// slots: int32 [M, R] as global_dp left them; off: int64 [M + 1], the
// exclusive scan of its counts (off[0] = 0); out: int32 [off[M]] or more.
// Copies each row's runs to out[off[r]...], rows ascending.
extern "C" int global_dp_gather(const void* slots, const void* off, void* out,
                                int M, int R, void* stream) {
  if (M < 0 || R < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0) return static_cast<int>(cudaGetLastError());
  const int blocks = std::min((M + WARPS - 1) / WARPS, GATHER_BLOCKS);
  gather_runs_kernel<<<blocks, WARPS * 32, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(slots), static_cast<const long long*>(off),
      static_cast<int32_t*>(out), M, R);
  return static_cast<int>(cudaGetLastError());
}
