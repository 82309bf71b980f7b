"""Wrapper of the residual dense block's conv kernel (csrc/rdb_conv.cu),
its plain PyTorch version and its launch counter.

The kernel replaces no TPU kernel (the JAX package's convs are
`lax.conv_general_dilated`, dsrt_tpu/models/esrgan.py:130-135): it runs
the five 3x3 convs of each of the RRDB trunk's dense blocks on a
channels-last float32 buffer [n, h, w, nf + 4 gc] (`models/esrgan.py`
`dense_trunk`), each conv reading the channel prefix it needs and writing
its own channels in place, with the block's elementwise work in its
epilogue (`mode`):

- LRELU: lrelu(conv + b, 0.2), the dense block's conv1-4;
- RESIDUAL: x + 0.2 * (conv + b), x the block's input (channels [0,
  cout) of `src`): conv5;
- RRDB_RESIDUAL: r + 0.2 * (x + 0.2 * (conv + b)), r the RRDB's input,
  read from the output slice itself: conv5 of an RRDB's third block.

`rdb_conv` launches the kernel for CUDA tensors, or raises if the widths
are ones it does not take (output channels up to 64, every width a
multiple of 4); it takes the plain version only for CPU tensors.
LAUNCHES counts kernel launches, so a caller can show a run went through
the kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from dsrt_tpu_torch.ops import build
from dsrt_tpu_torch.ops.build import ptr

LAUNCHES = {"dsrt_rdb_conv": 0}
LRELU, RESIDUAL, RRDB_RESIDUAL = 0, 1, 2
# input channels a chunk of the packed weights (csrc/rdb_conv.cu KC)
KC = 8
MAX_COUT = 64


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def cout_padded(cout: int) -> int:
    """The kernel's output channels for `cout`: 8, 32 or 64."""
    return 8 if cout <= 8 else 32 if cout <= 32 else 64


def shape_error(src: torch.Tensor, cin: int, conv, dst: torch.Tensor,
                off: int, mode: int) -> str | None:
    """Why the kernel does not take this conv, or None."""
    cout = conv.out_channels
    if tuple(conv.kernel_size) != (3, 3) or tuple(conv.padding) != (1, 1) \
            or tuple(conv.stride) != (1, 1) or conv.bias is None:
        return "the kernel takes 3x3 convs with stride 1, padding 1 and a bias"
    if conv.in_channels != cin:
        return f"the conv takes {conv.in_channels} channels, not {cin}"
    if not 0 < cout <= MAX_COUT or any(c % 4 for c in (cin, cout, off)):
        return (f"the kernel takes up to {MAX_COUT} output channels and "
                f"widths that are multiples of 4 (cin {cin}, cout {cout}, "
                f"offset {off})")
    for name, t in (("src", src), ("dst", dst)):
        if t.dim() != 4 or t.dtype != torch.float32 or t.shape[3] % 4:
            return (f"{name}: expected an NHWC float32 buffer whose channels "
                    f"are a multiple of 4, got {tuple(t.shape)} {t.dtype}")
    if src.shape[:3] != dst.shape[:3]:
        return f"src {tuple(src.shape)} and dst {tuple(dst.shape)} differ"
    if cin > src.shape[3] or off + cout > dst.shape[3]:
        return "the conv's channels lie outside its buffers"
    if mode not in (LRELU, RESIDUAL, RRDB_RESIDUAL) or (
            mode != LRELU and cout > cin):
        return f"mode {mode} with cin {cin}, cout {cout}"
    if src.shape[0] > 65535:
        return f"at most 65535 images a launch, got {src.shape[0]}"
    return None


def pack(conv) -> tuple:
    """The conv's weights as the kernel reads them, [ceil(cin / 8)][3][3]
    [8][cout_p] (zeros past cin and cout), and its bias padded to cout_p;
    kept on the module (`_rdb_pack`) while its weight and bias are
    unchanged."""
    w, b = conv.weight, conv.bias
    # an inference tensor keeps no version counter and cannot change
    key = tuple((0 if t.is_inference() else t._version, t.data_ptr())
                for t in (w, b))
    hit = getattr(conv, "_rdb_pack", None)
    if hit is not None and hit[0] == key:
        return hit[1], hit[2]
    cout, cin = w.shape[:2]
    cp, nch = cout_padded(cout), -(-cin // KC)
    with torch.no_grad():
        wp = w.new_zeros((cp, nch * KC, 3, 3))
        wp[:cout, :cin] = w
        wt = wp.view(cp, nch, KC, 3, 3).permute(1, 3, 4, 2, 0).contiguous()
        bp = b.new_zeros(cp)
        bp[:cout] = b
    conv._rdb_pack = (key, wt, bp)
    return wt, bp


def rdb_conv(src: torch.Tensor, cin: int, conv, dst: torch.Tensor, off: int,
             mode: int) -> None:
    """conv over channels [0, cin) of the NHWC buffer `src`, with the
    epilogue `mode`, written to channels [off, off + cout) of `dst` (which
    may be `src`).  The kernel for CUDA tensors, the plain version for CPU
    tensors."""
    if src.device.type == "cpu":
        rdb_conv_plain(src, cin, conv, dst, off, mode)
        return
    err = shape_error(src, cin, conv, dst, off, mode)
    if err is not None:
        raise ValueError(f"dsrt_rdb_conv: {err}")
    wt, bias = pack(conv)
    n, h, w, cs_in = src.shape
    lib = build.load()
    rc = lib.dsrt_rdb_conv(
        ptr(src, torch.float32, "src"), ptr(wt, torch.float32, "weights"),
        ptr(bias, torch.float32, "bias"),
        ptr(dst, torch.float32, "dst") + 4 * off, n, h, w, cin, cs_in,
        conv.out_channels, dst.shape[3], mode,
        torch.cuda.current_stream(src.device).cuda_stream)
    build.check(lib, rc, "dsrt_rdb_conv")
    LAUNCHES["dsrt_rdb_conv"] += 1


def rdb_conv_plain(src: torch.Tensor, cin: int, conv, dst: torch.Tensor,
                   off: int, mode: int) -> None:
    """The plain version of `rdb_conv`: the module's conv on the channel
    prefix as a contiguous NCHW tensor, then the dense block's
    elementwise steps in its order."""
    cout = conv.out_channels
    y = conv(src[..., :cin].permute(0, 3, 1, 2).contiguous()
             ).permute(0, 2, 3, 1)
    if mode == LRELU:
        y = F.leaky_relu(y, 0.2)
    else:
        y = src[..., :cout] + 0.2 * y
        if mode == RRDB_RESIDUAL:
            y = dst[..., off:off + cout] + 0.2 * y
    dst[..., off:off + cout] = y
