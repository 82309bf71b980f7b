"""upscale.swin_device_ms: device time of the SwinIR upscale stage per
PNG written in the window: the device work launched inside the program's
spans `upscale`, `upscale_forward`, `swin_rstb` (each RSTB) and
`swin_attn` (each layer's window-attention core), all four summed, since
a launch counts to the innermost span around it (Trace.span_ops); from
the profiler's trace; None where the program has none of these spans."""

SPANS = ("upscale", "upscale_forward", "swin_rstb", "swin_attn")


def read(run):
    if run.trace is None or not run.written:
        return None
    hits = [run.trace.span_ops[s][0] for s in SPANS
            if s in run.trace.span_ops]
    return sum(hits) * 1e3 / run.written if hits else None
