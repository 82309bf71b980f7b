"""s_per_frame: the window's wall clock over the PNGs written in it."""


def read(run):
    return run.window_s / run.written if run.written else None
