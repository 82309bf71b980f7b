"""path_kernel.device_ms: device time of the path megakernel
(`path_render_kernel`, launched by dsrt_path_render) per PNG written in
the window, from the profiler's trace."""

KERNEL = "path_render_kernel"


def read(run):
    if run.trace is None or not run.written:
        return None
    hits = [s for name, (s, _) in run.trace.ops.items() if KERNEL in name]
    return sum(hits) * 1e3 / run.written if hits else None
