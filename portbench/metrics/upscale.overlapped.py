"""upscale.overlapped: the share of the window's PNGs whose upscale the
driver finished after the next frame's forward was queued: its
`upscale_finish` rows (a frame finished with nothing queued behind it,
at a call's end or with --no_pipeline, is an `upscale_drain` row) per
PNG written, from the driver's --timings_tsv; None where the program
writes neither row."""


def read(run):
    rows = [stage for stage, _ in run.tsv
            if stage in ("upscale_finish", "upscale_drain")]
    if not rows or not run.written:
        return None
    return rows.count("upscale_finish") / run.written
