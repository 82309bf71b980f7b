"""upscale.dense_launches: launches of the program's dense-block conv
kernel (`rdb_conv_kernel`, the RRDB trunk's convs in the upscale stage)
per PNG written in the window, counted in the profiler's trace; None
where the trace holds no such kernel (a program without it)."""

KERNEL = "rdb_conv_kernel"


def read(run):
    if run.trace is None or not run.written:
        return None
    n = sum(c for name, (_, c) in run.trace.ops.items() if KERNEL in name)
    return n / run.written if n else None
