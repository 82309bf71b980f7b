"""Plain PyTorch reference of the upscale stage: RRDBNet, the Real-ESRGAN
generator, on a state dict of basicsr's layout (portbench/weights.py).

The network (Wang et al., "Real-ESRGAN", 2021; basicsr's `RRDBNet`):
conv_first -> num_block x RRDB -> conv_body, added to conv_first's
output -> twice (nearest x2, conv, leaky ReLU 0.2) -> conv_hr, leaky ReLU
-> conv_last.  An RRDB is three residual dense blocks, its output scaled
by 0.2 and added to its input; a dense block is five 3x3 convs, each over
the concatenation of the block's input and every earlier conv's output,
leaky ReLU 0.2 after the first four, the fifth scaled by 0.2 and added to
the input.  Scale 2 and 1 unshuffle the input by 2 and 4 first.

Departures from the published inference (RealESRGANer, as the upstream's
post-process runs it, SURVEY.md section 2.4):

- float32 with TF32 off, where the upstream runs half precision whenever
  CUDA is present;
- the tile grid and stitch of the JAX package (dsrt_tpu/models/esrgan.py,
  frozen here): the frame edge-padded to whole tiles, step tile -
  2 * overlap, each tile's interior kept, later tiles over earlier ones;
  `tile` 0, or a frame within one tile, runs whole.  RealESRGANer pads
  and crops its tiles its own way;
- u8 to float as x / 255 and back as round-half-even(y * 255) clipped to
  0..255, on RGB rows read top first;
- seeded weights in place of the release file.

The tile grid, the stitch's owner map, the u8 conversions and
`upscale_tiles` are every architecture's: `upscale_tiles` runs the
`forward` of the configuration's `stages/<upscale.arch>.py` (for RRDBNet,
`forward` here).  `dtype` torch.bfloat16, or `tf32` True, computes the
same in the lower precision: the check's controls.  Imports nothing of
the program.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

from portbench import registry

SLOPE = 0.2
RES = 0.2


@contextlib.contextmanager
def precision(tf32: bool):
    """TF32 off (or on, for the control) in matmuls and cuDNN convs for
    the scope; the process's settings come back after it."""
    mm, cd = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = mm.allow_tf32, cd.allow_tf32
    mm.allow_tf32 = cd.allow_tf32 = bool(tf32)
    try:
        yield
    finally:
        mm.allow_tf32, cd.allow_tf32 = saved


def _conv(sd, name, x):
    return F.conv2d(x, sd[f"{name}.weight"], sd[f"{name}.bias"], padding=1)


def _dense_block(sd, p, x):
    feats = [x]
    for i in range(1, 5):
        feats.append(F.leaky_relu(_conv(sd, f"{p}.conv{i}",
                                        torch.cat(feats, 1)), SLOPE))
    return x + RES * _conv(sd, f"{p}.conv5", torch.cat(feats, 1))


def forward(sd: dict, x: torch.Tensor, num_block: int,
            scale: int) -> torch.Tensor:
    """(N, C, h, w) float in [0, 1] -> (N, C, 4h, 4w)."""
    if scale in (1, 2):
        x = F.pixel_unshuffle(x, 4 // scale)
    feat = _conv(sd, "conv_first", x)
    body = feat
    for n in range(num_block):
        inner = body
        for j in range(1, 4):
            inner = _dense_block(sd, f"body.{n}.rdb{j}", inner)
        body = body + RES * inner
    feat = feat + _conv(sd, "conv_body", body)
    for name in ("conv_up1", "conv_up2"):
        feat = F.leaky_relu(_conv(sd, name, F.interpolate(
            feat, scale_factor=2, mode="nearest")), SLOPE)
    return _conv(sd, "conv_last",
                 F.leaky_relu(_conv(sd, "conv_hr", feat), SLOPE))


def grid(height: int, width: int, tile: int, overlap: int):
    """(origins, tile_h, tile_w): the (y0, x0) of every tile in row-major
    order and the tile's size; one tile of the frame's size where `tile`
    is 0 or the frame lies within one tile."""
    if tile == 0 or (height <= tile and width <= tile):
        return [(0, 0)], height, width
    step = tile - 2 * overlap
    hp = -(-max(height - 2 * overlap, 1) // step) * step + 2 * overlap
    wp = -(-max(width - 2 * overlap, 1) // step) * step + 2 * overlap
    return ([(y0, x0) for y0 in range(0, hp - 2 * overlap, step)
             for x0 in range(0, wp - 2 * overlap, step)], tile, tile)


def tiles(img: np.ndarray, origins, th: int, tw: int) -> np.ndarray:
    """(N, th, tw, 3) of the image, edge-padded as far as the tiles at
    `origins` reach."""
    h, w, _ = img.shape
    hp = max(y0 for y0, _ in origins) + th
    wp = max(x0 for _, x0 in origins) + tw
    pad = np.pad(img, ((0, max(hp - h, 0)), (0, max(wp - w, 0)), (0, 0)),
                 mode="edge")
    return np.stack([pad[y0:y0 + th, x0:x0 + tw] for y0, x0 in origins])


def owner(origins, height: int, width: int, th: int, tw: int,
          overlap: int, scale: int) -> np.ndarray:
    """(scale*height, scale*width) int: the tile whose output the stitch
    keeps at each output pixel (each tile's interior, the overlap margin
    skipped but at the leading border, later tiles over earlier ones)."""
    s = scale
    hp = max(y0 for y0, _ in origins) + th
    wp = max(x0 for _, x0 in origins) + tw
    out = np.full((hp * s, wp * s), -1, np.int64)
    for t, (y0, x0) in enumerate(origins):
        sy = 0 if y0 == 0 else overlap * s
        sx = 0 if x0 == 0 else overlap * s
        out[y0 * s + sy:(y0 + th) * s, x0 * s + sx:(x0 + tw) * s] = t
    return out[:height * s, :width * s]


def to_float(u8: np.ndarray) -> np.ndarray:
    return u8.astype(np.float32) / np.float32(255.0)


def to_u8(y: torch.Tensor) -> torch.Tensor:
    return torch.round(y.float() * 255.0).clamp(0, 255).to(torch.uint8)


def upscale_tiles(sd: dict, batch: np.ndarray, up: dict, device,
                  dtype=torch.float32, tf32: bool = False,
                  root=registry.REPO) -> np.ndarray:
    """(N, th, tw, 3) float tiles -> (N, s*th, s*tw, 3) uint8, one tile a
    forward of the architecture `up["arch"]` of the benchmark under
    `root`, in `dtype` (and TF32 on or off)."""
    arch = registry.stage(up.get("arch"), root)
    w = {k: v.to(device, dtype) for k, v in sd.items()}
    out = []
    with torch.no_grad(), precision(tf32):
        for t in batch:
            x = torch.as_tensor(np.ascontiguousarray(t.transpose(2, 0, 1))
                                )[None].to(device, dtype)
            out.append(to_u8(arch.forward(w, x, up))[0]
                       .permute(1, 2, 0).cpu().numpy())
    return np.stack(out)
