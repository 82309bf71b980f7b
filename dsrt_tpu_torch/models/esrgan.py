"""RRDBNet (the Real-ESRGAN generator) in PyTorch.

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
outside any Pallas kernel; here they are `nn.Conv2d` (cuDNN on the card).
They run in full FP32: `fp32_convs` scopes the forward to cuDNN with
TF32 off, since PyTorch's default would run these convs in TF32.

`upscale_tiled` keeps JAX's tile grid and stitch (edge padding, step =
tile - 2 * overlap, the interior of each tile), and sends the tiles
through the network in batches that fit the device's free memory.
`upscale_u8` converts u8 <-> float on the host in numpy, as JAX does.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from dsrt_tpu_torch.device import resolve_device

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
        feat = feat + self.conv_body(self.body(feat))
        feat = F.leaky_relu(self.conv_up1(
            F.interpolate(feat, scale_factor=2, mode="nearest")), 0.2)
        feat = F.leaky_relu(self.conv_up2(
            F.interpolate(feat, scale_factor=2, mode="nearest")), 0.2)
        return self.conv_last(F.leaky_relu(self.conv_hr(feat), 0.2))


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


def load_torch_checkpoint(path: str, num_block: int = 23, scale: int = 4,
                          device=None) -> RRDBNet:
    """A Real-ESRGAN .pth checkpoint (basicsr RRDBNet state dict, usually
    nested under 'params_ema' / 'params') as the network on `device`.
    A file that is not such a checkpoint raises."""
    raw = torch.load(path, map_location="cpu", weights_only=True)
    for k in ("params_ema", "params", "state_dict"):
        if k in raw:
            raw = raw[k]
            break
    return _net_from_state_dict(raw, num_block, scale, device)


# ---------------------------------------------------------------------------
# tiled inference
# ---------------------------------------------------------------------------

def fp32_convs():
    """The scope the upscaler's convs run in: cuDNN with TF32 off.
    `cudnn.flags` sets every flag it takes for the scope, so the
    process's own benchmark and deterministic settings are passed
    through (PyTorch's default: both off)."""
    cudnn = torch.backends.cudnn
    return cudnn.flags(enabled=True, benchmark=cudnn.benchmark,
                       deterministic=cudnn.deterministic, allow_tf32=False)


def tile_batch(net: RRDBNet, tile: int, n_tiles: int) -> int:
    """Tiles a forward may take at once: about four float32 activations
    of num_feat channels at the output size each, within
    TILE_MEMORY_SHARE of the device's free memory (CPU_TILE_BUDGET on
    the CPU)."""
    dev = next(net.parameters()).device
    per_tile = 16 * net.conv_hr.out_channels * (tile * net.scale) ** 2
    if dev.type == "cuda":
        budget = TILE_MEMORY_SHARE * torch.cuda.mem_get_info(dev)[0]
    else:
        budget = CPU_TILE_BUDGET
    return int(max(1, min(n_tiles, budget // per_tile)))


def forward_tiles(net: RRDBNet, tiles: np.ndarray) -> np.ndarray:
    """(N, h, w, 3) float32 tiles -> (N, s*h, s*w, 3) float32 on the
    host, `tile_batch` tiles a forward."""
    dev = next(net.parameters()).device
    n, th, tw, _ = tiles.shape
    batch = tile_batch(net, max(th, tw), n)
    s = net.scale
    out = np.empty((n, th * s, tw * s, 3), np.float32)
    with torch.inference_mode(), fp32_convs():
        for i in range(0, n, batch):
            x = torch.from_numpy(np.ascontiguousarray(
                tiles[i:i + batch].transpose(0, 3, 1, 2))).to(dev)
            out[i:i + batch] = net(x).permute(0, 2, 3, 1).cpu().numpy()
    return out


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
    tiles overwriting earlier ones."""
    s = ups.shape[1] // tile
    hp, wp = origins[-1][0] + tile, origins[-1][1] + tile
    out = np.zeros((hp * s, wp * s, 3), np.float32)
    for (y0, x0), u in zip(origins, ups):
        sy0 = 0 if y0 == 0 else overlap * s
        sx0 = 0 if x0 == 0 else overlap * s
        out[y0 * s + sy0:(y0 + tile) * s,
            x0 * s + sx0:(x0 + tile) * s] = u[sy0:, sx0:]
    return out[:height * s, :width * s]


def upscale_tiled(net: RRDBNet, img: np.ndarray, tile: int = 128,
                  overlap: int = 8) -> np.ndarray:
    """Upscale an (H, W, 3) float [0,1] image `net.scale` x in
    overlapping tiles (`tile_grid`, `forward_tiles`, `stitch`); an image
    within one tile runs whole."""
    h, w, _ = img.shape
    if h <= tile and w <= tile:
        return forward_tiles(net, img[None].astype(np.float32))[0]
    tiles, origins = tile_grid(img, tile, overlap)
    return stitch(forward_tiles(net, tiles), origins, h, w, tile, overlap)


def upscale_u8(net: RRDBNet, img_u8: np.ndarray, tile: int = 128,
               overlap: int = 8) -> np.ndarray:
    """uint8 (H, W, 3) -> uint8 (sH, sW, 3) through the network."""
    x = img_u8.astype(np.float32) / 255.0
    y = upscale_tiled(net, x, tile, overlap)
    return np.clip(np.rint(y * 255.0), 0, 255).astype(np.uint8)
