"""path_kernel.launches: launches of the path megakernel per PNG written
in the window, counted in the profiler's trace."""

KERNEL = "path_render_kernel"


def read(run):
    if run.trace is None or not run.written:
        return None
    n = sum(c for name, (_, c) in run.trace.ops.items() if KERNEL in name)
    return n / run.written if n else None
