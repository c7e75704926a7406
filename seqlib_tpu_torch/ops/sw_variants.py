"""Kernels K4 and K5: the rectangle-extension variants of the sweep
(counterpart of scripts/sw_variant_sweep.py's ``extend_v3`` and
``extend_v4``).

Both compute ``ops.sw.extend_rect`` (full-rectangle ``ksw_extend``), the
function of kernel K3, in other Hopper layouts (``csrc/sw_rect.cu``):

* ``extend_v3`` -> K4, a pipelined-row wavefront on a warp per lane:
  thread t owns a strip of columns and computes row i - t while thread
  0 computes row i, the E carry and the row maxima passing one thread
  to the right each step;
* ``extend_v4`` -> K5, the same wavefront on 32 // ``nch`` threads per
  lane (``nch`` 2 or 3), so a warp carries ``nch`` lanes side by side.

On CPU tensors each runs the plain version ``ops.sw.extend_rect``; on
CUDA tensors it launches its kernel or raises.  ``extend_v4`` takes
only ``zdrop > 0``: the sweep calls it at 100, and its TPU kernel runs
the z-drop test unconditionally, so at ``zdrop = 0`` it computes
something else (ROADMAP.md's reference watch-list).
"""

from __future__ import annotations

from .sw import extend_rect
from .sw_cuda import launch_rect


def extend_v3(query, qlen, target, tlen, h0,
              o_del: int = 6, e_del: int = 1, o_ins: int = 6,
              e_ins: int = 1, match: int = 1, mismatch: int = 4,
              zdrop: int = 100):
    """``extend_rect``: kernel K4 on CUDA, plain on CPU."""
    kw = dict(o_del=o_del, e_del=e_del, o_ins=o_ins, e_ins=e_ins,
              match=match, mismatch=mismatch, zdrop=zdrop)
    if not query.is_cuda:
        return extend_rect(query, qlen, target, tlen, h0, **kw)
    return launch_rect("sw_extend_rect_blocked", query, qlen, target, tlen,
                       h0, **kw)


def extend_v4(query, qlen, target, tlen, h0, nch: int = 2,
              o_del: int = 6, e_del: int = 1, o_ins: int = 6,
              e_ins: int = 1, match: int = 1, mismatch: int = 4,
              zdrop: int = 100):
    """``extend_rect`` for ``zdrop > 0``: kernel K5 with ``nch`` lanes
    per thread on CUDA, plain on CPU."""
    if zdrop <= 0:
        raise ValueError("extend_v4: zdrop must be > 0 (its TPU kernel "
                         "always runs the z-drop test)")
    if nch not in (2, 3):
        raise ValueError("extend_v4: nch must be 2 or 3")
    kw = dict(o_del=o_del, e_del=e_del, o_ins=o_ins, e_ins=e_ins,
              match=match, mismatch=mismatch, zdrop=zdrop)
    if not query.is_cuda:
        return extend_rect(query, qlen, target, tlen, h0, **kw)
    return launch_rect("sw_extend_rect_interleaved", query, qlen, target,
                       tlen, h0, nch=nch, **kw)
