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
// rows at ranks that depend on the previous step, so a lane is a chain of
// ~2 dependent loads per step over a few hundred steps (the FM-index of
// a bacterial genome, ~3.5 MB of blocks for 9 Mbp of 2L text, sits in
// the 50 MB L2 after the first touches).  Bytes and integer operations
// are both small.  On an H100 SXM one such dependent load takes ~150 ns
// (measured with smem_load_chase below), while a step of the longest
// lane takes ~2.5 us: the divergent step body, not the load alone, sets
// the time.
//
// Design: one thread per lane runs its INIT/FWD/BWD/DONE machine to
// completion (and its pass-3 scan beside it) with all state in
// registers and the C-entry circular stack in local memory; a rank is
// the block's 4 checkpoints plus __popc over the 2-bit-matched words of
// the block prefix.  There is no per-step launch and no per-step global
// state traffic: seeds are written straight to the output rows.  A lane
// stops after step_cap steps; a lane still busy then counts in
// n_dropped, as in the plain version.  Known weakness: B = 4096 lanes
// fill few of the 132 SMs and each step waits on a load; interleaving
// several lanes per thread to hide that latency is later work.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int M_INIT = 0, M_FWD = 1, M_BWD = 2, M_DONE = 3;
constexpr int MAXC = 16;

struct Params {
  int L, primary, S, C, min_seed_len, max_rounds, step_cap, P3,
      p3_max_intv;
  int L2[5];
};

// counts of all four codes in bwt[0 .. k) (k already sentinel-adjusted)
__device__ __forceinline__ void rank4(const uint32_t* __restrict__ blocks,
                                      int k, int cnt[4]) {
  const uint4* row = reinterpret_cast<const uint4*>(blocks + (size_t)(k >> 7) * 12);
  const uint4 c4 = __ldg(row);
  const uint4 w0 = __ldg(row + 1);
  const uint4 w1 = __ldg(row + 2);
  const uint32_t words[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
  cnt[0] = (int)c4.x; cnt[1] = (int)c4.y; cnt[2] = (int)c4.z; cnt[3] = (int)c4.w;
  const int within = k & 127;
#pragma unroll
  for (int w = 0; w < 8; ++w) {
    const int tt = min(max(within - 16 * w, 0), 16);
    if (tt > 0) {
      const uint32_t mask = 0xFFFFFFFFu << (32 - 2 * tt);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const uint32_t nx = ~(words[w] ^ (uint32_t)(c * 0x55555555u));
        cnt[c] += __popc(nx & (nx >> 1) & 0x55555555u & mask);
      }
    }
  }
}

__device__ __forceinline__ void rank4_full(const uint32_t* blocks,
                                           const Params& p, int k,
                                           int cnt[4]) {
  rank4(blocks, k - (k > p.primary ? 1 : 0), cnt);
}

// FMD backward extension of (k, l, s) by all 4 codes
__device__ __forceinline__ void bi_extend_back(const uint32_t* blocks,
                                               const Params& p, int k,
                                               int l, int s, int K4[4],
                                               int L4[4], int S4[4]) {
  int tk[4], tl[4];
  rank4_full(blocks, p, k, tk);
  rank4_full(blocks, p, k + s, tl);
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    S4[c] = tl[c] - tk[c];
    K4[c] = p.L2[c] + 1 + tk[c];
  }
  const int has_sent = (k <= p.primary && p.primary < k + s) ? 1 : 0;
  L4[3] = l + has_sent;
  L4[2] = L4[3] + S4[3];
  L4[1] = L4[2] + S4[2];
  L4[0] = L4[1] + S4[1];
}

__global__ void smem_machine_kernel(
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
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int L = p.L, C = p.C, S = p.S, P3 = p.P3;
  const uint8_t* rd = reads + (size_t)b * L;
  const int len = lens_v[b];
  const int min_intv = min_intv_v[b];
  int32_t* qb_o = o_qb + (size_t)b * S;
  int32_t* qe_o = o_qe + (size_t)b * S;
  int32_t* il_o = o_il + (size_t)b * S;
  int32_t* isz_o = o_isz + (size_t)b * S;
  for (int j = 0; j < S; ++j) { qb_o[j] = 0; qe_o[j] = 0; il_o[j] = 0; isz_o[j] = 0; }
  int32_t *pqb_o = nullptr, *pqe_o = nullptr, *pil_o = nullptr, *pisz_o = nullptr;
  if (P3) {
    pqb_o = p_qb + (size_t)b * P3;
    pqe_o = p_qe + (size_t)b * P3;
    pil_o = p_il + (size_t)b * P3;
    pisz_o = p_isz + (size_t)b * P3;
    for (int j = 0; j < P3; ++j) { pqb_o[j] = 0; pqe_o[j] = 0; pil_o[j] = 0; pisz_o[j] = 0; }
  }
  auto fetch = [&](int pos) -> int { return rd[min(max(pos, 0), L - 1)]; };

  int x = x0_v[b];
  int mode = (active_v[b] && x < len) ? M_INIT : M_DONE;
  int nx = 0, i = 0, k = 0, l = 0, s = 0, end = 0, sn = 0;
  int bj = 0, bk = 0, bl = 0, bs = 0, be = 0, last_i = 0, rounds = 0;
  int n = 0, nfull = 0;
  int sk[MAXC], sl[MAXC], ss[MAXC], se[MAXC];
  for (int c = 0; c < C; ++c) { sk[c] = 0; sl[c] = 0; ss[c] = 0; se[c] = 0; }
  int px = 0, pi = 0, pk = 0, pl = 0, ps = 0, pn = 0;
  bool pneed = true, pdone = !P3 || len <= 0;

  for (int it = 0; it < p.step_cap; ++it) {
    if (mode == M_DONE && pdone) break;
    const bool is_fwd = mode == M_FWD;
    const bool is_bwd = mode == M_BWD;
    const int ip = i;

    // ---- pass-3 scan (bwt_seed_strategy1) ----------------------------
    if (!pdone) {
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
      if (!pneed) {                      // one forward extension
        const int pch = pi < len ? fetch(pi) : 4;
        int restart = 0, pnk = 0, pnl = 0, pns = 0;
        if (pch < 4) {
          int K4[4], L4[4], S4[4];
          bi_extend_back(blocks, p, pl, pk, ps, K4, L4, S4);
          const int pcc = 3 - pch;
          pnk = L4[pcc]; pnl = K4[pcc]; pns = S4[pcc];
          const bool hit = pns < p.p3_max_intv && pi - px >= p.min_seed_len;
          if (hit) {
            if (pns > 0 && pn < P3) {
              pqb_o[pn] = px; pqe_o[pn] = pi + 1;
              pil_o[pn] = pnk; pisz_o[pn] = pns;
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
    int ch = 4;
    if ((is_fwd && ip < len) || (is_bwd && ip >= 0)) ch = fetch(ip);
    const bool ch_ok = ch < 4;
    int nk = 0, nl = 0, ns = 0;
    if (is_fwd || is_bwd) {
      int K4[4], L4[4], S4[4];
      if (is_fwd) {
        bi_extend_back(blocks, p, l, k, s, K4, L4, S4);
        const int cc = min(max(3 - ch, 0), 3);
        nk = L4[cc]; nl = K4[cc]; ns = S4[cc];
      } else {
        bi_extend_back(blocks, p, bk, bl, bs, K4, L4, S4);
        const int cc = min(ch, 3);
        nk = K4[cc]; nl = L4[cc]; ns = S4[cc];
      }
    }
    // FWD lanes
    const bool f_ok = is_fwd && ch_ok;
    const bool changed = f_ok && ns != s;
    const bool die = changed && ns < min_intv;
    const bool hit_end = is_fwd && !ch_ok;
    if (changed || hit_end) {            // push the old interval
      const int slot = sn % C;
      sk[slot] = k; sl[slot] = l; ss[slot] = s; se[slot] = end;
      ++sn;
    }
    if (f_ok && !die) { k = nk; l = nl; s = ns; end = ip + 1; }
    const bool fwd_dead = die || hit_end;
    if (fwd_dead) nx = end;
    // BWD lanes
    const bool b_die = is_bwd && (!ch_ok || ns < min_intv);
    const bool b_adv = is_bwd && !b_die;
    const int e_start = ip + 1;
    const bool want = b_die && (be - e_start >= p.min_seed_len) &&
                      (e_start < last_i + 1);
    if (want) {
      if (n < S) {
        qb_o[n] = e_start; qe_o[n] = be; il_o[n] = bk; isz_o[n] = bs;
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
    if (fwd_dead || to_entry) {
      const int slot = max(bj, 0) % C;
      bk = sk[slot]; bl = sl[slot]; bs = ss[slot]; be = se[slot];
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
  o_n[b] = n;
  o_drop[b] = nfull + (mode != M_DONE ? 1 : 0);
  if (P3) p_n[b] = pn;
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
  Params p;
  p.L = L; p.primary = primary; p.S = S; p.C = C;
  p.min_seed_len = min_seed_len; p.max_rounds = max_rounds;
  p.step_cap = step_cap; p.P3 = P3; p.p3_max_intv = p3_max_intv;
  for (int c = 0; c < 5; ++c) p.L2[c] = L2[c];
  if (B > 0) {
    const int threads = 64;
    const int grid = (B + threads - 1) / threads;
    smem_machine_kernel<<<grid, threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
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
  }
  return static_cast<int>(cudaGetLastError());
}
