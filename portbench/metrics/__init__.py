"""Per-layer metrics, one reader a file, named as the metric.

A reader module has ``read(ctx) -> float | None`` (None: nothing to
read in this run, and the metric is left out of the line) and may have
``probe(cell)``, a context manager entered around a traced pass, with
``SYNC = True`` when the probe synchronises the card (it then runs in a
pass of its own, away from the profiler's).  ``ctx`` holds the cell,
the profiler's ``trace.Trace``, the batches a pass ran and each
metric's probe object by name."""
