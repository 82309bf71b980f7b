"""upscale.mfu.rdv_a_swinir: the SwinIR upscale stage's share of the
H100's float32 peak in `rdv_a_swinir`, as a fraction: the
configuration's operations a frame (portbench/work_esrgan.py through
stages/SwinIR.py, counted from its widths, frame size and tile grid, not
from the program: 2.8139e13 at SwinIR-L's widths on 28 tiles of 128)
times the PNGs written in the window, over the device seconds of
`upscale.swin_device_ms` times 67 TFLOP/s.  The stage is bound by
compute: its bytes (weights once, each tile in and out once) take about
61 us at 3.35 TB/s against 0.42 s of operations, so this share is its
roofline share.  It reads configs/rdv_a_swinir.json itself, as a Run
carries no configuration; None where the trace has no stage spans."""

import json
from pathlib import Path

from portbench import work_esrgan

CONFIG = Path(__file__).resolve().parents[1] / "configs" / "rdv_a_swinir.json"
SPANS = ("upscale", "upscale_forward", "swin_rstb", "swin_attn")


def read(run):
    if run.trace is None or not run.written:
        return None
    dev_s = sum(run.trace.span_ops[s][0] for s in SPANS
                if s in run.trace.span_ops)
    if dev_s <= 0:
        return None
    cfg = json.loads(CONFIG.read_text())
    return (work_esrgan.frame_flops(cfg) * run.written
            / (dev_s * work_esrgan.FP32_FLOPS))
