"""The extension the port's adaptive-band wrapper
(``seqlib_tpu_torch/ops/sw_cuda.py::extend_batch_adaptive``) is defined
to equal: one plain banded pass, ``sw.extend_batch(band=band)``."""

from __future__ import annotations

from .sw import extend_batch


def extend_batch_adaptive(query, qlen, target, tlen, h0, band: int = 100,
                          **kw):
    """``extend_batch(band=band)``; ``kw`` holds the scoring options."""
    return extend_batch(query, qlen, target, tlen, h0, band=band, **kw)
