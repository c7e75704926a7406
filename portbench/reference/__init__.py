"""The plain reference that decides ``correct``.

``bwamem/`` aligns by bwa mem's classic per-read route on plain PyTorch
operations (``bwamem/align/aligner.py``): the seed scan, locate, chaining
and extension with the plain versions of kernels K1 and K2, then one
read at a time on the host dedup, primary marking, float64 MAPQ, the
global DP of each region kept and the records, encoded in Python.  The
port's timed path is its fused batch program (dedup, primary marking
and DP-row compaction on the device under a batch-wide row budget,
MAPQ and records column-wise in numpy and C++), which the reference
does not contain.  Its modules began as copies of the port's plain code
and are frozen here; two parts are its own: the suffix array by prefix
doubling (``bwamem/sa.py``, in place of the port's SA-IS in C++) and
the extension that the port's adaptive-band wrapper is defined to equal
(``bwamem/ops/sw_plain.py``).  It imports nothing of the port, of JAX
or of the JAX package, and takes nothing the port made: it builds its
own index from the genome and aligns the reads again.  ``records``
compares what the port emitted with it."""
