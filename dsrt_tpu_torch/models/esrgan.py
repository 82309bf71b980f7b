"""RRDBNet (the Real-ESRGAN generator) in PyTorch, and the upscale
stage's loader and tile path for it and SwinIR.

Port of dsrt_tpu/models/esrgan.py, the pipeline's super-resolution
stage: the published Real-ESRGAN x4plus / x2plus network (RRDBNet,
num_feat 64, num_block 23, num_grow_ch 32) as a `torch.nn.Module` whose
module names are basicsr's (`conv_first`, `body.N.rdbJ.convI`,
`conv_body`, `conv_up1`, `conv_up2`, `conv_hr`, `conv_last`), so a
release `.pth` state dict loads with `load_state_dict`.

Architecture (public Real-ESRGAN design):
  conv_first -> num_block x RRDB -> conv_body (+residual) ->
  2 x [nearest x2 upsample -> conv -> lrelu] -> conv_hr -> conv_last
  RRDB       = 3 x ResidualDenseBlock, each residual-scaled by 0.2
  RDB        = 5 densely-connected 3x3 convs, lrelu(0.2) between
  scale 2/1  = pixel-unshuffle(2/4) on input (conv_first takes 4/16 x
               C_in), output still 4x the unshuffled grid

The JAX package computes every conv with `lax.conv_general_dilated`,
outside any Pallas kernel.  On the card the trunk's dense blocks run
through the hand-written FP32 kernel of `ops/rdb_conv.py` on channels-last
buffers (`dense_trunk`: no concatenation, the leaky ReLUs and residuals
in the kernel's epilogue); on the CPU they are the modules' own forwards.
The other convs are `nn.Conv2d` (cuDNN on the card), in full FP32:
`fp32_scope` scopes the forward to cuDNN and cuBLAS with TF32 off, since
PyTorch's default would run these convs in TF32.  The x4 tail (`x4_tail`)
is the one that SwinIR's real-world network (`models/swinir.py`) runs
too.

`load_torch_checkpoint` loads either network from a file, by the state
dict's keys, and the tile path below runs whichever it holds: a network
states the device bytes a tile takes (`tile_bytes`), and `tile_batch`
sizes its batches from that.

`upscale_tiled` keeps JAX's tile grid and stitch (edge padding, step =
tile - 2 * overlap, the interior of each tile), and sends the tiles
through the network in batches that fit the device's free memory.
`upscale_u8` converts u8 to float on the host, as JAX does, and the
network's output to u8 on the device (JAX's round half to even and clip
of y * 255 in float32, the same values), so that 4x fewer bytes come
back and the host stitches u8.

Each of them is `finish_upscale` of its `_async` twin, as
`render.render_frame_fused` is `render.finish` of
`render.render_frame_async`: on the card the async call queues the tiles'
copy in from pinned memory, the forwards, the u8 conversion, the copy
back into pinned memory and an event, and returns without waiting for
the device; `finish_upscale` waits for that event alone and stitches on
the host.  So a caller can queue the next image's work before it
finishes this one.  On the CPU the async call runs to the end.
"""

from __future__ import annotations

import contextlib
import dataclasses
from collections import OrderedDict

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from dsrt_tpu_torch.device import resolve_device, to_device
from dsrt_tpu_torch.ops import rdb_conv
from dsrt_tpu_torch.utils import timing

# the part of the free device memory a batch of tiles may take, and the
# budget on the CPU
TILE_MEMORY_SHARE = 0.5
CPU_TILE_BUDGET = 2 << 30


# ---------------------------------------------------------------------------
# the JAX package's parameter pytree (HWIO conv kernels), copied so that
# one seed gives JAX's arrays
# ---------------------------------------------------------------------------

def _conv_spec(cin: int, cout: int):
    return {"w": (3, 3, cin, cout), "b": (cout,)}


def rrdbnet_spec(num_in_ch: int = 3, num_out_ch: int = 3,
                 num_feat: int = 64, num_block: int = 23,
                 num_grow_ch: int = 32, scale: int = 4) -> dict:
    """Shape spec of the parameter pytree (HWIO conv kernels)."""
    cin = num_in_ch * (4 if scale == 2 else 16 if scale == 1 else 1)
    nf, gc = num_feat, num_grow_ch

    def rdb():
        return {f"conv{i + 1}": _conv_spec(nf + i * gc,
                                           gc if i < 4 else nf)
                for i in range(5)}

    spec = {
        "conv_first": _conv_spec(cin, nf),
        "body": [{f"rdb{j + 1}": rdb() for j in range(3)}
                 for _ in range(num_block)],
        "conv_body": _conv_spec(nf, nf),
        "conv_up1": _conv_spec(nf, nf),
        "conv_up2": _conv_spec(nf, nf),
        "conv_hr": _conv_spec(nf, nf),
        "conv_last": _conv_spec(nf, num_out_ch),
    }
    return spec


def init_params(rng: np.random.Generator, spec: dict,
                dtype=np.float32) -> dict:
    """Random He-style init matching the spec (tests / smoke runs)."""
    def leaf(s):
        if len(s) == 1:
            return np.zeros(s, dtype)
        fan_in = s[0] * s[1] * s[2]
        return (rng.standard_normal(s) * np.sqrt(2.0 / fan_in) * 0.1
                ).astype(dtype)

    def walk(node):
        if isinstance(node, dict):
            if set(node) == {"w", "b"}:
                return {"w": leaf(node["w"]), "b": leaf(node["b"])}
            return {k: walk(v) for k, v in node.items()}
        return [walk(v) for v in node]

    return walk(spec)


def state_dict_from_params(params: dict) -> "OrderedDict[str, torch.Tensor]":
    """The JAX pytree as a basicsr state dict: HWIO kernels -> OIHW."""
    sd = OrderedDict()

    def conv(prefix, p):
        sd[f"{prefix}.weight"] = torch.from_numpy(np.ascontiguousarray(
            np.transpose(np.asarray(p["w"], np.float32), (3, 2, 0, 1))))
        sd[f"{prefix}.bias"] = torch.from_numpy(
            np.asarray(p["b"], np.float32).copy())

    conv("conv_first", params["conv_first"])
    for n, blk in enumerate(params["body"]):
        for j in range(3):
            for i in range(5):
                conv(f"body.{n}.rdb{j + 1}.conv{i + 1}",
                     blk[f"rdb{j + 1}"][f"conv{i + 1}"])
    for name in ("conv_body", "conv_up1", "conv_up2", "conv_hr",
                 "conv_last"):
        conv(name, params[name])
    return sd


# ---------------------------------------------------------------------------
# the network
# ---------------------------------------------------------------------------

class ResidualDenseBlock(nn.Module):
    """5 densely connected 3x3 convs, lrelu(0.2) between, 0.2 residual."""

    def __init__(self, num_feat: int, num_grow_ch: int):
        super().__init__()
        for i in range(5):
            setattr(self, f"conv{i + 1}",
                    nn.Conv2d(num_feat + i * num_grow_ch,
                              num_grow_ch if i < 4 else num_feat, 3, 1, 1))

    def forward(self, x):
        x1 = F.leaky_relu(self.conv1(x), 0.2)
        x2 = F.leaky_relu(self.conv2(torch.cat((x, x1), 1)), 0.2)
        x3 = F.leaky_relu(self.conv3(torch.cat((x, x1, x2), 1)), 0.2)
        x4 = F.leaky_relu(self.conv4(torch.cat((x, x1, x2, x3), 1)), 0.2)
        x5 = self.conv5(torch.cat((x, x1, x2, x3, x4), 1))
        return x + 0.2 * x5


class RRDB(nn.Module):
    def __init__(self, num_feat: int, num_grow_ch: int):
        super().__init__()
        self.rdb1 = ResidualDenseBlock(num_feat, num_grow_ch)
        self.rdb2 = ResidualDenseBlock(num_feat, num_grow_ch)
        self.rdb3 = ResidualDenseBlock(num_feat, num_grow_ch)

    def forward(self, x):
        return x + 0.2 * self.rdb3(self.rdb2(self.rdb1(x)))


def x4_tail(net: nn.Module, feat: torch.Tensor) -> torch.Tensor:
    """The `nearest+conv` x4 tail of RRDBNet and of SwinIR's real-world
    network: twice (nearest x2, conv, leaky ReLU 0.2) through
    `net.conv_up1` and `net.conv_up2`, then `net.conv_hr`, leaky ReLU
    0.2, `net.conv_last`."""
    for conv in (net.conv_up1, net.conv_up2):
        feat = F.leaky_relu(conv(F.interpolate(feat, scale_factor=2,
                                               mode="nearest")), 0.2)
    return net.conv_last(F.leaky_relu(net.conv_hr(feat), 0.2))


def dense_trunk(body: nn.Sequential, feat: torch.Tensor,
                conv=rdb_conv.rdb_conv) -> torch.Tensor:
    """`body(feat)`, the RRDBs of the trunk, on three channels-last
    buffers [n, h, w, nf + 4 gc]: a dense block's input x sits in channels
    [0, nf) of its buffer, conv_i (i = 1..4) reads channels [0, nf + (i -
    1) gc) and writes its gc channels after them, and conv5 reads all of
    them and writes the block's output into the next buffer's [0, nf).
    An RRDB's blocks go from buffer 0 to 1, 1 to 2 and 2 back to 0, where
    conv5 adds the RRDB's own residual to its input in place.  `conv` is
    `rdb_conv.rdb_conv` (the kernel on the card) or its plain version.
    NCHW in and out."""
    n, nf, h, w = feat.shape
    if len(body) == 0:
        return feat
    gc = body[0].rdb1.conv1.out_channels
    width = nf + 4 * gc
    bufs = [feat.new_empty((n, h, w, width)) for _ in range(3)]
    bufs[0][..., :nf] = feat.permute(0, 2, 3, 1)
    for rrdb in body:
        for j, rdb in enumerate((rrdb.rdb1, rrdb.rdb2, rrdb.rdb3)):
            src, dst = bufs[j], bufs[(j + 1) % 3]
            for i in range(4):
                conv(src, nf + i * gc, getattr(rdb, f"conv{i + 1}"), src,
                     nf + i * gc, rdb_conv.LRELU)
            conv(src, width, rdb.conv5, dst, 0,
                 rdb_conv.RRDB_RESIDUAL if j == 2 else rdb_conv.RESIDUAL)
    return bufs[0][..., :nf].permute(0, 3, 1, 2).contiguous()


class RRDBNet(nn.Module):
    """NCHW float in [0, 1] -> NCHW, `scale` x the size."""

    def __init__(self, num_in_ch: int = 3, num_out_ch: int = 3,
                 num_feat: int = 64, num_block: int = 23,
                 num_grow_ch: int = 32, scale: int = 4):
        super().__init__()
        if scale not in (1, 2, 4):
            raise ValueError(f"scale {scale}: RRDBNet takes 1, 2 or 4")
        self.scale = scale
        cin = num_in_ch * (4 if scale == 2 else 16 if scale == 1 else 1)
        self.conv_first = nn.Conv2d(cin, num_feat, 3, 1, 1)
        self.body = nn.Sequential(*[RRDB(num_feat, num_grow_ch)
                                    for _ in range(num_block)])
        self.conv_body = nn.Conv2d(num_feat, num_feat, 3, 1, 1)
        self.conv_up1 = nn.Conv2d(num_feat, num_feat, 3, 1, 1)
        self.conv_up2 = nn.Conv2d(num_feat, num_feat, 3, 1, 1)
        self.conv_hr = nn.Conv2d(num_feat, num_feat, 3, 1, 1)
        self.conv_last = nn.Conv2d(num_feat, num_out_ch, 3, 1, 1)

    def forward(self, x):
        if self.scale == 2:
            x = F.pixel_unshuffle(x, 2)
        elif self.scale == 1:
            x = F.pixel_unshuffle(x, 4)
        feat = self.conv_first(x)
        trunk = (dense_trunk(self.body, feat) if feat.is_cuda
                 else self.body(feat))
        # the sum goes into conv_body's output and conv_first's is let go,
        # so that the tail's input is the one such map alive in the tail
        trunk = self.conv_body(trunk)
        trunk += feat
        del feat
        return x4_tail(self, trunk)

    def tile_bytes(self, th: int, tw: int) -> int:
        """Device bytes one th x tw tile takes at once in a forward: about
        four float32 activations of num_feat channels at the output
        size."""
        return 16 * self.conv_hr.out_channels * self.scale ** 2 * th * tw


def _net_from_state_dict(sd, num_block: int, scale: int,
                         device) -> RRDBNet:
    unshuffle = 4 if scale == 2 else 16 if scale == 1 else 1
    net = RRDBNet(num_in_ch=sd["conv_first.weight"].shape[1] // unshuffle,
                  num_out_ch=sd["conv_last.weight"].shape[0],
                  num_feat=sd["conv_first.weight"].shape[0],
                  num_block=num_block,
                  num_grow_ch=sd["body.0.rdb1.conv1.weight"].shape[0],
                  scale=scale)
    net.load_state_dict(sd)
    return net.to(resolve_device(device)).eval()


def rrdbnet_from_params(params: dict, scale: int = 4,
                        device=None) -> RRDBNet:
    """The network holding the JAX pytree's weights, on `device` (the
    card unless the caller asks for another)."""
    return _net_from_state_dict(state_dict_from_params(params),
                                len(params["body"]), scale, device)


# a key that each architecture's state dict has and the other's lacks
ARCH_KEYS = {"RRDBNet": "body.0.rdb1.conv1.weight",
             "SwinIR": "layers.0.residual_group.blocks.0.attn.qkv.weight"}


def load_torch_checkpoint(path: str, num_block: int = 23, scale: int = 4,
                          device=None) -> nn.Module:
    """A super-resolution .pth checkpoint, its state dict usually nested
    under 'params_ema' / 'params', as its network on `device`, the
    architecture picked by the state dict's keys (`ARCH_KEYS`): a
    Real-ESRGAN file (basicsr's RRDBNet, `num_block` RRDBs, `scale` 4, 2
    or 1) or a SwinIR release file (`models/swinir.py`, x4; its widths
    and depths read from the file).  A file of neither raises a
    ValueError naming the keys looked for; one that does not load
    raises."""
    raw = torch.load(path, map_location="cpu", weights_only=True)
    for k in ("params_ema", "params", "state_dict"):
        if k in raw:
            raw = raw[k]
            break
    if ARCH_KEYS["RRDBNet"] in raw:
        return _net_from_state_dict(raw, num_block, scale, device)
    if ARCH_KEYS["SwinIR"] in raw:
        from dsrt_tpu_torch.models import swinir
        return swinir.from_state_dict(raw, scale, device)
    raise ValueError(f"{path}: not an upscaler checkpoint: none of the keys "
                     f"{sorted(ARCH_KEYS.values())} (RRDBNet, SwinIR)")


# ---------------------------------------------------------------------------
# tiled inference
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def fp32_scope():
    """The scope an upscaler's forward runs in: cuDNN's convs and
    cuBLAS's matmuls in full FP32, TF32 off.  `cudnn.flags` sets every
    flag it takes for the scope, so the process's own benchmark and
    deterministic settings are passed through (PyTorch's default: both
    off); the caller's matmul setting comes back after the scope."""
    cudnn, mm = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = mm.allow_tf32
    mm.allow_tf32 = False
    try:
        with cudnn.flags(enabled=True, benchmark=cudnn.benchmark,
                         deterministic=cudnn.deterministic, allow_tf32=False):
            yield
    finally:
        mm.allow_tf32 = saved


def tile_batch(net: nn.Module, tile: int, n_tiles: int) -> int:
    """Tiles a forward may take at once: the network's bytes for a tile x
    tile tile (`net.tile_bytes`; for a network that states none, four
    float32 activations of `conv_hr`'s width at the output size) within
    TILE_MEMORY_SHARE of the device's free memory (CPU_TILE_BUDGET on
    the CPU)."""
    dev = next(net.parameters()).device
    if hasattr(net, "tile_bytes"):
        per_tile = net.tile_bytes(tile, tile)
    else:
        per_tile = 16 * net.conv_hr.out_channels * (tile * net.scale) ** 2
    if dev.type == "cuda":
        budget = TILE_MEMORY_SHARE * torch.cuda.mem_get_info(dev)[0]
    else:
        budget = CPU_TILE_BUDGET
    return int(max(1, min(n_tiles, budget // per_tile)))


@dataclasses.dataclass
class PendingUpscale:
    """Upscaled tiles on their way to the host: `ups`, in pinned host
    memory that the copy back fills when `done` fires (None: complete,
    as on the CPU), and the `stitch` arguments (origins, height, width,
    tile, overlap) that make them one image, None where `ups` is the
    result as it stands."""
    ups: torch.Tensor
    grid: tuple | None = None
    done: "torch.cuda.Event | None" = None


def issue_tiles(net: nn.Module, tiles: np.ndarray, u8: bool = False,
                grid: tuple | None = None) -> PendingUpscale:
    """Queue (N, h, w, 3) float32 tiles through the network and return
    without waiting for the device: `tile_batch` tiles a forward, each
    batch (copy in from pinned memory, forward, with `u8` round(y * 255)
    clipped to 0..255 as uint8, copy back) a span `upscale_forward`, then
    an event on the stream.  The result's tiles are (N, s*h, s*w, 3),
    float32 or uint8; `grid` is handed on to `finish_upscale`."""
    dev = next(net.parameters()).device
    n, th, tw, _ = tiles.shape
    batch = tile_batch(net, max(th, tw), n)
    s = net.scale
    cuda = dev.type == "cuda"
    nchw = np.ascontiguousarray(tiles.transpose(0, 3, 1, 2))
    with torch.inference_mode(), fp32_scope():
        ups = torch.empty((n, th * s, tw * s, 3),
                          dtype=torch.uint8 if u8 else torch.float32,
                          pin_memory=cuda)
        for i in range(0, n, batch):
            with timing.span("upscale_forward"):
                y = net(to_device(nchw[i:i + batch], dev))
                if u8:
                    y = torch.round(y * 255.0).clamp_(0, 255).to(torch.uint8)
                ups[i:i + batch].copy_(y.permute(0, 2, 3, 1).contiguous(),
                                       non_blocking=True)
        done = None
        if cuda:
            done = torch.cuda.Event()
            done.record()
    return PendingUpscale(ups, grid, done)


def finish_upscale(p: PendingUpscale) -> np.ndarray:
    """The host array of an issued upscale, after waiting for its event
    only: its tiles stitched on its grid, or `ups` where it has none."""
    if p.done is not None:
        p.done.synchronize()
    ups = p.ups.numpy()
    return ups if p.grid is None else stitch(ups, *p.grid)


def forward_tiles(net: nn.Module, tiles: np.ndarray,
                  u8: bool = False) -> np.ndarray:
    """(N, h, w, 3) float32 tiles -> (N, s*h, s*w, 3) float32 on the
    host (with `u8`: uint8, round(y * 255) clipped to 0..255 on the
    device); `issue_tiles` then `finish_upscale`."""
    return finish_upscale(issue_tiles(net, tiles, u8))


def tile_grid(img: np.ndarray, tile: int = 128, overlap: int = 8):
    """JAX's tile grid: the (N, tile, tile, 3) float32 tiles of the image
    edge-padded to whole tiles (step tile - 2 * overlap), and their
    (y0, x0) origins in row-major order."""
    h, w, _ = img.shape
    step = tile - 2 * overlap
    hp = int(np.ceil(max(h - 2 * overlap, 1) / step)) * step + 2 * overlap
    wp = int(np.ceil(max(w - 2 * overlap, 1) / step)) * step + 2 * overlap
    pad = np.pad(img, ((0, hp - h), (0, wp - w), (0, 0)), mode="edge")
    origins = [(y0, x0) for y0 in range(0, hp - 2 * overlap, step)
               for x0 in range(0, wp - 2 * overlap, step)]
    tiles = np.stack([pad[y0:y0 + tile, x0:x0 + tile] for y0, x0 in origins])
    return tiles.astype(np.float32), origins


def stitch(ups: np.ndarray, origins, height: int, width: int,
           tile: int = 128, overlap: int = 8) -> np.ndarray:
    """JAX's stitch of the upscaled tiles of `tile_grid` into the
    (scale*height, scale*width, 3) image: each tile's interior, the
    overlap margin skipped except at the leading image border, later
    tiles overwriting earlier ones; of the tiles' dtype."""
    s = ups.shape[1] // tile
    hp, wp = origins[-1][0] + tile, origins[-1][1] + tile
    out = np.zeros((hp * s, wp * s, 3), ups.dtype)
    for (y0, x0), u in zip(origins, ups):
        sy0 = 0 if y0 == 0 else overlap * s
        sx0 = 0 if x0 == 0 else overlap * s
        out[y0 * s + sy0:(y0 + tile) * s,
            x0 * s + sx0:(x0 + tile) * s] = u[sy0:, sx0:]
    return out[:height * s, :width * s]


def upscale_tiled_async(net: nn.Module, img: np.ndarray, tile: int = 128,
                        overlap: int = 8, u8: bool = False) -> PendingUpscale:
    """Issue the `net.scale` x upscale of an (H, W, 3) float [0,1] image
    in overlapping tiles (`tile_grid`, `issue_tiles`) without waiting for
    the device; `finish_upscale` stitches it.  An image within one tile
    runs whole."""
    h, w, _ = img.shape
    if h <= tile and w <= tile:
        p = issue_tiles(net, img[None].astype(np.float32), u8)
        return dataclasses.replace(p, ups=p.ups[0])
    tiles, origins = tile_grid(img, tile, overlap)
    return issue_tiles(net, tiles, u8, (origins, h, w, tile, overlap))


def upscale_tiled(net: nn.Module, img: np.ndarray, tile: int = 128,
                  overlap: int = 8, u8: bool = False) -> np.ndarray:
    """Upscale an (H, W, 3) float [0,1] image `net.scale` x in
    overlapping tiles (`upscale_tiled_async`, then `finish_upscale`); an
    image within one tile runs whole.  Float out, or with `u8` uint8."""
    return finish_upscale(upscale_tiled_async(net, img, tile, overlap, u8))


def upscale_u8_async(net: nn.Module, img_u8: np.ndarray, tile: int = 128,
                     overlap: int = 8) -> PendingUpscale:
    """Issue `upscale_u8` of `img_u8` without waiting for the device."""
    return upscale_tiled_async(net, img_u8.astype(np.float32) / 255.0, tile,
                               overlap, u8=True)


def upscale_u8(net: nn.Module, img_u8: np.ndarray, tile: int = 128,
               overlap: int = 8) -> np.ndarray:
    """uint8 (H, W, 3) -> uint8 (sH, sW, 3) through the network."""
    return finish_upscale(upscale_u8_async(net, img_u8, tile, overlap))
