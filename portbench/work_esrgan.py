"""The work of a configuration's upscale stage, counted from its widths,
its frame size and its tile grid: what a roofline share divides by, the
same whatever program computes the stage.

- operations: one forward of a tile, by the architecture's file
  (`stages/<upscale.arch>.py` `tile_flops`), times the tiles of the grid
  (reference_esrgan.grid: the tiles run whole, overlap and edge padding
  included).  RRDBNet's (`flops_per_input_pixel`): 2 x 9 x in x out
  channels a 3x3 conv an output pixel, for every conv
  (reference_esrgan.py's equations) at the size it runs at (the body at
  the input's, `conv_up1` at 2x, the rest at 4x); the leaky ReLUs,
  residual sums, concatenations and nearest upsamples are not counted.
- bytes: the weights once (the architecture's `param_count`), each
  tile's float32 input and output once.

`RealESRGAN_x4plus` (64 / 23 / 32, x4) comes to 35,853,696 operations an
input pixel; 800x450 on 128-pixel tiles with an 8-pixel overlap is 28
tiles, 16,447,954,747,392 operations a frame, 0.2455 s at the H100's 67
TFLOP/s in float32, against 160,377,356 bytes, 48 us at 3.35 TB/s: the
stage is bound by compute.  Imports nothing of the program.
"""

from __future__ import annotations

from portbench import reference_esrgan, registry, weights

FP32_FLOPS = 67e12        # H100 SXM, float32 outside the tensor cores
HBM_BYTES_S = 3.35e12


def flops_per_input_pixel(up: dict) -> float:
    """Operations (2 per multiply-add) of one forward per input pixel."""
    # the body runs on the input unshuffled by 1, 2 or 4 (scale 4, 2, 1);
    # conv_up1 at twice its size, the three after it at four times
    unshuffle = {4: 1, 2: 4, 1: 16}[int(up["scale"])]
    area = {"conv_up1": 4, "conv_up2": 16, "conv_hr": 16, "conv_last": 16}
    total = 0.0
    for name, co, ci in weights.conv_shapes(up):
        total += 2 * 9 * co * ci * area.get(name, 1) / unshuffle
    return total


def frame_tiles(cfg: dict) -> tuple:
    """(tiles, tile height, tile width) of a frame on the stage's grid."""
    up = cfg["upscale"]
    origins, th, tw = reference_esrgan.grid(
        int(cfg["height"]), int(cfg["width"]), int(up["tile"]),
        int(up["overlap"]))
    return len(origins), th, tw


def frame_flops(cfg: dict, root=registry.REPO) -> float:
    """Operations of the stage on one frame, over every tile."""
    up = cfg["upscale"]
    n, th, tw = frame_tiles(cfg)
    return registry.stage(up.get("arch"), root).tile_flops(up, th, tw) * n


def frame_bytes(cfg: dict, root=registry.REPO) -> float:
    """Bytes the stage must move for one frame: weights once, each tile's
    float32 input and output once."""
    up = cfg["upscale"]
    s = int(up["scale"])
    params = registry.stage(up.get("arch"), root).param_count(up)
    n, th, tw = frame_tiles(cfg)
    cin = int(up.get("num_in_ch", 3))
    cout = int(up.get("num_out_ch", 3))
    return 4.0 * (params + n * th * tw * (cin + cout * s * s))


def frame_bound_s(cfg: dict, root=registry.REPO) -> float:
    """The least time the H100 could take for a frame's stage: the larger
    of operations over its float32 peak and bytes over its HBM rate."""
    return max(frame_flops(cfg, root) / FP32_FLOPS,
               frame_bytes(cfg, root) / HBM_BYTES_S)
