"""Frozen copy of part of seqlib_tpu_torch/ops."""
