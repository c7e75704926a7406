"""Device ops: FM-index rank/locate, SMEM seeding, affine DP
(counterpart of seqlib_tpu.ops)."""
