"""Record serialisation (counterpart of seqlib_tpu.io)."""

from .bam import encode_record  # noqa: F401
