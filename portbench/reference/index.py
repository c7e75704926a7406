"""The reference's own FM-index of a deployment's genome, and bwa's
index files written from it (what ``bwa index`` would have left on a
user's disk, SA sampled every 32 ranks).

The arrays are those of ``bwamem.index.fmindex.FMIndex.construct``
(the frozen copy of the port's construction), computed on the card
where there is one: the suffix array by prefix doubling, the BWT, the
occurrence checkpoints and the packed words of bwa's interleaved .bwt
body, in PyTorch instead of numpy over the 2L text (on a 200 Mbp text
numpy's interleaving took some 10 s a pass, and the copy made two)."""

from __future__ import annotations

import numpy as np
import torch

from .bwamem.index.bwa_files import (OCC_INTERVAL, write_amb, write_ann,
                                     write_bwt, write_pac, write_sa)
from .bwamem.index.fmindex import FMIndex, split_occ
from .bwamem.index.pack import both_strands, pack_sequences
from .bwamem.sa import suffix_array_t

_SHIFTS = torch.arange(15, -1, -1, dtype=torch.int64) * 2


def interleave_occ_t(bwt: torch.Tensor) -> torch.Tensor:
    """``bwa_files.interleave_occ`` of uint8 BWT codes on their device:
    int64 [nb * 16 + 8] holding the uint32 words."""
    n = bwt.numel()
    dev = bwt.device
    nb = (n + OCC_INTERVAL - 1) // OCC_INTERVAL
    padded = torch.zeros(nb * OCC_INTERVAL, dtype=torch.uint8, device=dev)
    padded[:n] = bwt
    blocks = padded.view(nb, OCC_INTERVAL)
    counts = torch.stack([(blocks == c).sum(1) for c in range(4)], 1)
    counts[-1, 0] -= nb * OCC_INTERVAL - n      # the padding's zeros
    cum = torch.zeros((nb + 1, 4), dtype=torch.int64, device=dev)
    cum[1:] = torch.cumsum(counts, 0)
    q = padded.view(nb, 8, 16).to(torch.int64)
    words = (q << _SHIFTS.to(dev)).sum(-1)
    halves = torch.stack([cum & 0xFFFFFFFF, cum >> 32], 2).view(nb + 1, 8)
    out = torch.empty(nb * 16 + 8, dtype=torch.int64, device=dev)
    body = out[:nb * 16].view(nb, 16)
    body[:, :8] = halves[:-1]
    body[:, 8:] = words
    out[nb * 16:] = halves[-1]
    return out


def build(contigs, device=None) -> FMIndex:
    """The reference's index (full SA) of [(name, ACGT string)], as
    ``FMIndex.construct`` makes it; keeps the interleaved .bwt body for
    ``write_bwa_files``."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    idx = FMIndex()
    idx.ref = pack_sequences(contigs)
    text = both_strands(idx.ref.codes)
    idx.seq_len = n = text.size
    t = torch.from_numpy(text).to(device)
    sa = suffix_array_t(t + 1)
    idx.primary = int(torch.nonzero(sa == 0)[0, 0])
    idx.L2[1:] = np.cumsum(torch.bincount(t, minlength=4)[:4].cpu().numpy())
    bwt = t[sa[sa > 0] - 1]
    inter = interleave_occ_t(bwt).cpu().numpy().astype(np.uint32)
    del t
    idx.bwt = bwt.cpu().numpy()
    idx.cp_counts, idx.bwt_words = split_occ(inter, n)
    idx._set_sa_full(sa.cpu().numpy())
    idx.interleaved = inter
    return idx


def write_bwa_files(idx: FMIndex, prefix: str) -> None:
    """``prefix``.{pac, ann, amb, bwt, sa}, bwa's formats (the frozen
    copy's writers)."""
    L2 = idx.L2.astype(np.uint64)
    write_pac(prefix + ".pac", idx.ref.codes)
    write_ann(prefix + ".ann", idx.ref)
    write_amb(prefix + ".amb", idx.ref)
    write_bwt(prefix + ".bwt", idx.primary, L2, idx.interleaved)
    write_sa(prefix + ".sa", idx.primary, L2, idx.sa_intv, idx.seq_len,
             idx.sa_samples)
