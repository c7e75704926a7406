"""Device events (kernels and copies) that torch.profiler records in the
traced pass, over the batches it ran."""


def read(ctx):
    return len(ctx.trace.events) / ctx.batches if ctx.trace.events else None
