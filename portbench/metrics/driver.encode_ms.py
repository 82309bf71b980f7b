"""driver.encode_ms: the driver's `encode` stage (write_png) per PNG
written in the window, from the driver's own --timings_tsv."""


def read(run):
    enc = [s for stage, s in run.tsv if stage == "encode"]
    return sum(enc) * 1e3 / run.written if enc and run.written else None
