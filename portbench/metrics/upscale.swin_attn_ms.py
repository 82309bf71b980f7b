"""upscale.swin_attn_ms: device time of SwinIR's window-attention cores
per PNG written in the window: the device work launched inside the
program's `swin_attn` spans (q, k, v to the heads' output before `proj`:
q k^T, the position bias, the region mask, softmax, times v), from the
profiler's trace (Trace.span_ops); None where the program has no such
span."""

SPAN = "swin_attn"


def read(run):
    if run.trace is None or not run.written \
            or SPAN not in run.trace.span_ops:
        return None
    return run.trace.span_ops[SPAN][0] * 1e3 / run.written
