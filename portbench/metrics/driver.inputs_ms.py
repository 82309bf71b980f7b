"""driver.inputs_ms: the driver's `inputs` spans (`frame_inputs`: the
frame's camera and sun put on the device, blocking uploads included) per
PNG written in the window, from the driver's --timings_tsv; None where
the program writes no such rows."""


def read(run):
    rows = [s for stage, s in run.tsv if stage == "inputs"]
    return sum(rows) * 1e3 / run.written if rows and run.written else None
