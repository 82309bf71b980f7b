"""driver.render_stage_ms: the driver's `render` stage (issue of the
frame to its u8 image on the host; it overlaps the previous frame's
encode) per PNG written in the window, from the driver's --timings_tsv."""


def read(run):
    ren = [s for stage, s in run.tsv if stage == "render"]
    return sum(ren) * 1e3 / run.written if ren and run.written else None
