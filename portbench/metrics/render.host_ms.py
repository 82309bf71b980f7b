"""render.host_ms: the driver's `issue` spans (the `render_frame_async`
call: launches, tonemap, pinned copies and the event put on the stream,
and whatever the host waits for inside it) per PNG written in the
window, from the driver's --timings_tsv; None where the program writes
no such rows."""


def read(run):
    rows = [s for stage, s in run.tsv if stage == "issue"]
    return sum(rows) * 1e3 / run.written if rows and run.written else None
