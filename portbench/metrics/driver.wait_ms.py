"""driver.wait_ms: the driver's `wait` spans (`render.finish`, the wait
on an issued frame's event) per PNG written in the window, from the
driver's --timings_tsv; None where the program writes no such rows."""


def read(run):
    rows = [s for stage, s in run.tsv if stage == "wait"]
    return sum(rows) * 1e3 / run.written if rows and run.written else None
