"""upscale.swin_attn_launches: device launches (kernels, copies, sets)
inside the program's `swin_attn` spans per PNG written in the window, in
the profiler's trace (Trace.span_ops): what one fused window-attention
kernel would bring down to one a layer and tile batch; None where the
program has no such span."""

SPAN = "swin_attn"


def read(run):
    if run.trace is None or not run.written \
            or SPAN not in run.trace.span_ops:
        return None
    return run.trace.span_ops[SPAN][1] / run.written
