// Kernel K2: the whole SMEM seed machine in one launch, bit-exact with
// the plain PyTorch version seqlib_tpu_torch/ops/fm.py::_smem_machine.
//
// Replaces: seqlib_tpu/ops/fm_pallas.py::_step_kernel (one lockstep step
// of bwa's bwt_smem1 / mem_collect_intv per lane, one pallas_call per
// step, with the block-row gather left to XLA between steps), and covers
// the XLA machine's full contract as well: the fused third pass
// (bwt_seed_strategy1, p3_*) and the re-seed call (max_rounds = 1,
// min_intv = occ + 1).
//
// What bounds it on an H100: latency of dependent random loads.  Every
// machine step is one FMD bi-extension = two 48-byte occurrence-block
// rows at ranks that depend on the previous step (two more when the
// read's third-pass scan extends in the same step), so a read is a chain
// of dependent load rounds over a few hundred steps (the FM-index of a
// bacterial genome, ~3.5 MB of blocks for 9 Mbp of 2L text, sits in the
// 50 MB L2 after the first touches).  Bytes and integer operations are
// both small.  One such dependent load takes ~150 ns (measured with
// smem_load_chase below); the longest read's step count times that is
// the call's dependent-load bound.  With this design a call takes about
// as long as its longest read alone, and a step about six such loads:
// the step's serial shuffles and integer work cost more than its load.
//
// Design: one warp per read, four reads per 128-thread block, so a
// 4096-read call is 1024 blocks and each SM holds enough warps to hide
// one another's load and shuffle latency.  Every thread of the warp holds
// the read's scalar machine state (main machine and pass 3), so control
// flow is warp-uniform: reads in different modes are in different warps
// and never serialise each other's branches.  Each step first settles
// what it will extend (pass 3's INIT, the main machine's FWD or BWD
// interval, selected by mode), then computes every rank it needs in ONE
// load round: up to 4 ranks x 8 BWT words = 32 (rank, word) pairs, one
// per thread.  Thread 8r + w loads word w of rank r's block row (and the
// row's 4 checkpoints, a broadcast within the group), counts the four
// 2-bit codes in the word's prefix into the bytes of one uint32 (a word
// holds <= 16 of each code, a block <= 128), and three xor shuffles
// within the 8-thread group sum the words; then the counts the step's
// selected code needs are broadcast.  The circular interval stack lives
// in registers, slot c in thread c (push: a write by thread sn % C; pop:
// a shuffle from thread bj % C), and the read's codes are staged in
// shared memory, so no state goes through local memory.  Reads too long
// for four of them to fit the card's per-block shared memory (227 KB on
// an H100: reads over ~58 kb) are read from global memory through the
// read-only cache instead, by an instance the launcher picks by shape; a
// step reads one or two codes, so this adds one cached load to a step.
// Seeds and pass-3 hits are written by thread 0, at the same rows and in
// the same order as the plain version.  A read stops after step_cap steps; one
// still busy then counts in n_dropped, as in the plain version.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int M_INIT = 0, M_FWD = 1, M_BWD = 2, M_DONE = 3;
constexpr int MAXC = 16;
constexpr int WARPS = 4;  // reads (warps) per block
constexpr unsigned FULL = 0xffffffffu;

struct Params {
  int L, primary, S, C, min_seed_len, max_rounds, step_cap, P3,
      p3_max_intv;
  int L2[5];
  int l_pad;  // a warp's shared-memory bytes for the read
};

// counts of the four 2-bit codes among the first tt (0..16) bases of one
// BWT word (first base in the top bits), one byte per code
__device__ __forceinline__ uint32_t word_counts(uint32_t word, int tt) {
  if (tt <= 0) return 0u;
  const uint32_t mask = 0xFFFFFFFFu << (32 - 2 * tt);
  uint32_t packed = 0u;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const uint32_t nx = ~(word ^ (uint32_t)(c * 0x55555555u));
    packed |= (uint32_t)__popc(nx & (nx >> 1) & 0x55555555u & mask)
              << (8 * c);
  }
  return packed;
}

template <bool STAGED>
__global__ void __launch_bounds__(WARPS * 32) smem_warp_kernel(
    const uint32_t* __restrict__ blocks, const uint8_t* __restrict__ reads,
    const int32_t* __restrict__ lens_v, const int32_t* __restrict__ x0_v,
    const int32_t* __restrict__ min_intv_v,
    const uint8_t* __restrict__ active_v, int B, Params p,
    int32_t* __restrict__ o_qb, int32_t* __restrict__ o_qe,
    int32_t* __restrict__ o_il, int32_t* __restrict__ o_isz,
    int32_t* __restrict__ o_n, int32_t* __restrict__ o_drop,
    int32_t* __restrict__ p_qb, int32_t* __restrict__ p_qe,
    int32_t* __restrict__ p_il, int32_t* __restrict__ p_isz,
    int32_t* __restrict__ p_n) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int warp = threadIdx.x >> 5;
  const int t = threadIdx.x & 31;
  const int b = blockIdx.x * WARPS + warp;
  if (b >= B) return;  // the whole warp leaves together
  const int L = p.L, C = p.C, S = p.S, P3 = p.P3;

  // the read's codes, staged once per warp (STAGED); zeroed output rows
  uint8_t* rd = smem + warp * p.l_pad;
  const uint8_t* src = reads + (size_t)b * L;
  if constexpr (STAGED) {
    for (int x = t; x < L; x += 32) rd[x] = src[x];
  }
  int32_t* qb_o = o_qb + (size_t)b * S;
  int32_t* qe_o = o_qe + (size_t)b * S;
  int32_t* il_o = o_il + (size_t)b * S;
  int32_t* isz_o = o_isz + (size_t)b * S;
  for (int j = t; j < S; j += 32) {
    qb_o[j] = 0; qe_o[j] = 0; il_o[j] = 0; isz_o[j] = 0;
  }
  int32_t *pqb_o = nullptr, *pqe_o = nullptr, *pil_o = nullptr,
          *pisz_o = nullptr;
  if (P3) {
    pqb_o = p_qb + (size_t)b * P3;
    pqe_o = p_qe + (size_t)b * P3;
    pil_o = p_il + (size_t)b * P3;
    pisz_o = p_isz + (size_t)b * P3;
    for (int j = t; j < P3; j += 32) {
      pqb_o[j] = 0; pqe_o[j] = 0; pil_o[j] = 0; pisz_o[j] = 0;
    }
  }
  __syncwarp();  // the zeroes land before thread 0's seeds
  auto fetch = [&](int pos) -> int {
    const int x = min(max(pos, 0), L - 1);
    if constexpr (STAGED) return rd[x]; else return __ldg(src + x);
  };

  const int len = lens_v[b];
  const int min_intv = min_intv_v[b];
  int x = x0_v[b];
  int mode = (active_v[b] && x < len) ? M_INIT : M_DONE;
  int nx = 0, i = 0, k = 0, l = 0, s = 0, end = 0, sn = 0;
  int bj = 0, bk = 0, bl = 0, bs = 0, be = 0, last_i = 0, rounds = 0;
  int n = 0, nfull = 0;
  int sk = 0, sl = 0, ss = 0, se = 0;  // stack slot t (t < C)
  int px = 0, pi = 0, pk = 0, pl = 0, ps = 0, pn = 0;
  bool pneed = true, pdone = !P3 || len <= 0;
  const int rank_id = t >> 3;  // the rank this thread helps compute
  const int wi = t & 7;        // the BWT word of its block row

  for (int it = 0; it < p.step_cap; ++it) {
    if (mode == M_DONE && pdone) break;
    const bool is_fwd = mode == M_FWD;
    const bool is_bwd = mode == M_BWD;
    const int ip = i;

    // ---- pass-3 scan (bwt_seed_strategy1): INIT, then its extension --
    const bool p_live = !pdone;
    bool p_ext = false;
    int pch = 4;
    if (p_live) {
      if (pneed) {                       // INIT: start a seed at px
        const int pc0 = fetch(px);
        if (pc0 < 4) {
          pk = p.L2[pc0] + 1;
          pl = p.L2[3 - pc0] + 1;
          ps = p.L2[pc0 + 1] - p.L2[pc0];
          pi = px + 1;
          pneed = false;
        } else {
          px = px + 1;
        }
      }
      if (!pneed) {
        p_ext = true;
        pch = pi < len ? fetch(pi) : 4;
      }
    }
    const bool p_rank = p_ext && pch < 4;
    const int pcc = min(max(3 - pch, 0), 3);

    // ---- SMEM machine: the FWD or BWD bi-extension's inputs ----------
    int ch = 4;
    if ((is_fwd && ip < len) || (is_bwd && ip >= 0)) ch = fetch(ip);
    const bool ch_ok = ch < 4;
    const bool m_rank = (is_fwd || is_bwd) && ch_ok;
    // FWD extends (l, k, s) and swaps; BWD extends (bk, bl, bs)
    const int ma = is_fwd ? l : bk;
    const int mb = is_fwd ? k : bl;
    const int msz = is_fwd ? s : bs;
    const int mcc = is_fwd ? min(max(3 - ch, 0), 3) : min(ch, 3);

    // ---- one load round for every rank of the step ------------------
    // ranks 0, 1: main at ma, ma + msz; ranks 2, 3: pass 3 at pl, pl + ps
    int mK = 0, mL = 0, mS = 0, pK = 0, pL = 0, pS = 0;
    if (m_rank || p_rank) {
      const bool need = rank_id < 2 ? m_rank : p_rank;
      const int pos = rank_id == 0 ? ma
                    : rank_id == 1 ? ma + msz
                    : rank_id == 2 ? pl : pl + ps;
      const int kk = pos - (pos > p.primary ? 1 : 0);
      const int tt = min(max((kk & 127) - 16 * wi, 0), 16);
      uint4 c4 = make_uint4(0u, 0u, 0u, 0u);
      uint32_t word = 0u;
      if (need) {
        const uint32_t* row = blocks + (size_t)(kk >> 7) * 12;
        c4 = __ldg(reinterpret_cast<const uint4*>(row));
        if (tt > 0) word = __ldg(row + 4 + wi);
      }
      uint32_t packed = word_counts(word, tt);
      packed += __shfl_xor_sync(FULL, packed, 4, 8);
      packed += __shfl_xor_sync(FULL, packed, 2, 8);
      packed += __shfl_xor_sync(FULL, packed, 1, 8);
      const int cnt[4] = {(int)(c4.x + (packed & 0xFFu)),
                          (int)(c4.y + ((packed >> 8) & 0xFFu)),
                          (int)(c4.z + ((packed >> 16) & 0xFFu)),
                          (int)(c4.w + (packed >> 24))};
      // the selected code's count and the counts of the codes above it
      const int cc = rank_id < 2 ? mcc : pcc;
      int sel = 0, above = 0;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (c == cc) sel = cnt[c];
        if (c > cc) above += cnt[c];
      }
      const int tk = __shfl_sync(FULL, sel, 0);
      const int tl = __shfl_sync(FULL, sel, 8);
      const int ak = __shfl_sync(FULL, above, 0);
      const int al = __shfl_sync(FULL, above, 8);
      const int ptk = __shfl_sync(FULL, sel, 16);
      const int ptl = __shfl_sync(FULL, sel, 24);
      const int pak = __shfl_sync(FULL, above, 16);
      const int pal = __shfl_sync(FULL, above, 24);
      // FMD backward extension of (a, b, sz) by code cc: K, L, S
      const int m_sent = (ma <= p.primary && p.primary < ma + msz) ? 1 : 0;
      mK = p.L2[mcc] + 1 + tk;
      mS = tl - tk;
      mL = mb + m_sent + (al - ak);
      const int p_sent = (pl <= p.primary && p.primary < pl + ps) ? 1 : 0;
      pK = p.L2[pcc] + 1 + ptk;
      pS = ptl - ptk;
      pL = pk + p_sent + (pal - pak);
    }

    // ---- pass-3 update ------------------------------------------------
    if (p_live) {
      if (p_ext) {
        int restart = 0;
        const int pnk = pL, pnl = pK, pns = pS;
        if (pch < 4) {
          const bool hit = pns < p.p3_max_intv && pi - px >= p.min_seed_len;
          if (hit) {
            if (pns > 0 && pn < P3) {
              if (t == 0) {
                pqb_o[pn] = px; pqe_o[pn] = pi + 1;
                pil_o[pn] = pnk; pisz_o[pn] = pns;
              }
              ++pn;
            }
            restart = 1;
          }
        } else {
          restart = 1;                   // N at pi, or pi past the read
        }
        if (restart) {
          px = pi + 1;
          pneed = true;
        } else {
          pk = pnk; pl = pnl; ps = pns;
          pi = pi + 1;
        }
      }
      if (pneed && px >= len) pdone = true;
    }

    // ---- SMEM machine: FWD / BWD step --------------------------------
    const int nk = is_fwd ? mL : mK;
    const int nl = is_fwd ? mK : mL;
    const int ns = mS;
    // FWD reads
    const bool f_ok = is_fwd && ch_ok;
    const bool changed = f_ok && ns != s;
    const bool die = changed && ns < min_intv;
    const bool hit_end = is_fwd && !ch_ok;
    if (changed || hit_end) {            // push the old interval
      if (t == sn % C) { sk = k; sl = l; ss = s; se = end; }
      ++sn;
    }
    if (f_ok && !die) { k = nk; l = nl; s = ns; end = ip + 1; }
    const bool fwd_dead = die || hit_end;
    if (fwd_dead) nx = end;
    // BWD reads
    const bool b_die = is_bwd && (!ch_ok || ns < min_intv);
    const bool b_adv = is_bwd && !b_die;
    const int e_start = ip + 1;
    const bool want = b_die && (be - e_start >= p.min_seed_len) &&
                      (e_start < last_i + 1);
    if (want) {
      if (n < S) {
        if (t == 0) {
          qb_o[n] = e_start; qe_o[n] = be; il_o[n] = bk; isz_o[n] = bs;
        }
        ++n;
        last_i = ip;
      } else {
        ++nfull;
      }
    }
    const int bj1 = bj - 1;
    const bool bwd_done = b_die && (bj1 < 0 || bj1 < sn - C);
    const bool to_entry = b_die && !bwd_done;
    if (bwd_done) { ++rounds; x = nx; }
    if (is_fwd || to_entry)
      i = (f_ok && !fwd_dead) ? ip + 1 : x - 1;
    else if (b_adv)
      i = ip - 1;
    bj = fwd_dead ? sn - 1 : (b_die ? bj1 : bj);
    if (fwd_dead || to_entry) {          // pop: stack slot bj % C
      const int slot = max(bj, 0) % C;
      bk = __shfl_sync(FULL, sk, slot);
      bl = __shfl_sync(FULL, sl, slot);
      bs = __shfl_sync(FULL, ss, slot);
      be = __shfl_sync(FULL, se, slot);
    } else if (b_adv) {
      bk = nk; bl = nl; bs = ns;
    }
    if (fwd_dead) { last_i = 1 << 30; mode = M_BWD; }
    else if (bwd_done) mode = rounds >= p.max_rounds ? M_DONE : M_INIT;

    // ---- INIT fold-in: start the next round in the same step ----------
    if (mode == M_INIT) {
      if (x >= len) {
        mode = M_DONE;
      } else {
        const int c0 = fetch(x);
        const int c0c = min(c0, 3);
        const int s0 = p.L2[c0c + 1] - p.L2[c0c];
        if (c0 < 4 && s0 >= min_intv && s0 > 0) {
          mode = M_FWD;
          k = p.L2[c0c] + 1;
          l = p.L2[3 - c0c] + 1;
          s = s0;
          end = x + 1;
          i = x + 1;
          sn = 0;
        } else {                         // invalid pivot: consumes a round
          x = x + 1;
          ++rounds;
          if (rounds >= p.max_rounds) mode = M_DONE;
        }
      }
    }
  }
  if (t == 0) {
    o_n[b] = n;
    o_drop[b] = nfull + (mode != M_DONE ? 1 : 0);
    if (P3) p_n[b] = pn;
  }
}

// Latency probe for K2's dependent-load bound: one thread follows n
// dependent loads through a table with the rank's row stride and load
// path (__ldg); word 0 of row r holds the next row.
__global__ void load_chase_kernel(const int32_t* __restrict__ table,
                                  int stride, int n, int32_t* out) {
  int r = 0;
  for (int j = 0; j < n; ++j) r = __ldg(table + (size_t)r * stride);
  out[0] = r;
}

}  // namespace

extern "C" int smem_machine_max_stack() { return MAXC; }

extern "C" int smem_load_chase(const void* table, int stride, int n,
                               void* out, void* stream) {
  load_chase_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(table), stride, n,
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int smem_machine(const void* blocks, const void* reads,
                            const void* lens, const void* x0,
                            const void* min_intv, const void* active, int B,
                            int L, int primary, const int* L2, int S, int C,
                            int min_seed_len, int max_rounds, int step_cap,
                            int P3, int p3_max_intv, void* qb, void* qe,
                            void* il, void* isz, void* n_seeds,
                            void* n_dropped, void* pqb, void* pqe, void* pil,
                            void* pisz, void* pn, void* stream) {
  if (C < 1 || C > MAXC) return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0) return static_cast<int>(cudaGetLastError());
  Params p;
  p.L = L; p.primary = primary; p.S = S; p.C = C;
  p.min_seed_len = min_seed_len; p.max_rounds = max_rounds;
  p.step_cap = step_cap; p.P3 = P3; p.p3_max_intv = p3_max_intv;
  for (int c = 0; c < 5; ++c) p.L2[c] = L2[c];
  p.l_pad = (L + 15) & ~15;
  // stage the reads when four of them fit the card's per-block shared
  // memory, else read them from global memory
  size_t smem = (size_t)WARPS * p.l_pad;
  int dev = 0, limit = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&limit,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const bool staged = smem <= (size_t)limit;
  auto kernel = staged ? smem_warp_kernel<true> : smem_warp_kernel<false>;
  if (!staged) smem = 0;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int grid = (B + WARPS - 1) / WARPS;
  kernel<<<grid, WARPS * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(blocks),
      static_cast<const uint8_t*>(reads),
      static_cast<const int32_t*>(lens), static_cast<const int32_t*>(x0),
      static_cast<const int32_t*>(min_intv),
      static_cast<const uint8_t*>(active), B, p,
      static_cast<int32_t*>(qb), static_cast<int32_t*>(qe),
      static_cast<int32_t*>(il), static_cast<int32_t*>(isz),
      static_cast<int32_t*>(n_seeds), static_cast<int32_t*>(n_dropped),
      static_cast<int32_t*>(pqb), static_cast<int32_t*>(pqe),
      static_cast<int32_t*>(pil), static_cast<int32_t*>(pisz),
      static_cast<int32_t*>(pn));
  return static_cast<int>(cudaGetLastError());
}
