"""path_kernel.wrapper_ms: the `launch` spans (each
`ops/path_kernel.path_render` call: checks, packing, camera and sun
vectors, the ctypes launch) per PNG written in the window, from the
driver's --timings_tsv; None where the program writes no such rows."""


def read(run):
    rows = [s for stage, s in run.tsv if stage == "launch"]
    return sum(rows) * 1e3 / run.written if rows and run.written else None
