"""device.idle_share: 100 x (1 - the union of all device activity / the
traced window), from the profiler's trace."""


def read(run):
    if run.trace is None or run.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
