#!/usr/bin/env python
"""Super-resolution post-process for rendered frames.

Port of scripts/upsample.py (the reference's Real-ESRGAN x2/x4 step,
RRDBNet-23 with auto-downloaded weights).  Backends:

1. rrdbnet: the network of dsrt_tpu_torch/models/esrgan.py on the release
   weights (cached under ~/.cache/realesrgan/, or downloaded there with a
   SHA256 check), in FP32 on the device;
2. torch: bicubic interpolation on the device;
3. pil: PIL bicubic on the host.

`auto` takes rrdbnet when the weight file is there (cached or
downloaded), else torch, and prints the backend it took.  Only a
missing weight file changes the backend: a checkpoint that does not
load, or a device error, raises.  The reference's own realesrgan stack
(basicsr) is not carried: rrdbnet is the same network on the same
weights.

`Upscaler` picks and loads the backend, for `process_folder` and for the
driver's `--upscale` alike.  Given a weights path (the driver's
`--upscale_weights`) it takes rrdbnet on that file: no lookup, no
download, no fallback.  `Upscaler.issue` starts an image and returns
before the device is done (rrdbnet's `models/esrgan.py`
`upscale_u8_async`; the other backends complete it), and
`esrgan.finish_upscale` of the result is the upscaled image: the
driver's stage queues the next frame's forward before it finishes this
one's.

Usage: python -m dsrt_tpu_torch.scripts.upsample --in dir_or_image
       --out out_dir [--scale 4] [--backend auto|rrdbnet|torch|pil]
       [--device cuda]
"""

from __future__ import annotations

import argparse
import glob
import os
import sys

import numpy as np

# Official Real-ESRGAN release weights (the URLs the reference
# auto-downloads from, scripts/upsample.py:29-39) + published SHA256.
WEIGHT_URLS = {
    2: ("https://github.com/xinntao/Real-ESRGAN/releases/download/"
        "v0.2.1/RealESRGAN_x2plus.pth",
        "49fafd45f8fd7aa8d31ab2a22d14d91b536c34494a5cfe31eb5d89c2fa266abb"),
    4: ("https://github.com/xinntao/Real-ESRGAN/releases/download/"
        "v0.1.0/RealESRGAN_x4plus.pth",
        "4fa0d38905f75ac06eb49a7951b426670021be3018265fd191d2125df9d682f1"),
}


def fetch_weights(scale: int, allow_download: bool = True) -> str:
    """Return the cached weight path, auto-downloading (with a SHA256
    check) when absent and the network permits — reference parity with
    scripts/upsample.py:29-39, plus integrity verification."""
    import hashlib
    import urllib.request

    name = f"RealESRGAN_x{scale}plus"
    weights = os.path.expanduser(f"~/.cache/realesrgan/{name}.pth")
    if os.path.exists(weights):
        return weights
    if not allow_download:
        raise FileNotFoundError(f"weights not cached at {weights}")
    url, sha = WEIGHT_URLS[scale]
    os.makedirs(os.path.dirname(weights), exist_ok=True)
    tmp = weights + ".part"
    print(f"[+] downloading {url}", file=sys.stderr)
    try:
        urllib.request.urlretrieve(url, tmp)
    except Exception as e:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise FileNotFoundError(
            f"weights not cached at {weights} and download failed ({e}); "
            f"fetch {url} manually") from e
    digest = hashlib.sha256(open(tmp, "rb").read()).hexdigest()
    if digest != sha:
        os.unlink(tmp)
        raise ValueError(f"weight download hash mismatch for {name}: "
                         f"{digest} != {sha}")
    os.replace(tmp, weights)
    return weights


def upsample_torch(img: np.ndarray, scale: int, device) -> np.ndarray:
    """Bicubic x`scale` on `device`; u8 <-> float on the host."""
    import torch
    t = torch.from_numpy(img.transpose(2, 0, 1)[None].astype("float32")
                         / 255).to(device)
    out = torch.nn.functional.interpolate(
        t, scale_factor=scale, mode="bicubic", align_corners=False)
    out = out.clamp(0, 1).cpu().numpy()[0].transpose(1, 2, 0)
    return (out * 255 + 0.5).astype(np.uint8)


def upsample_pil(img: np.ndarray, scale: int) -> np.ndarray:
    from PIL import Image
    h, w = img.shape[:2]
    return np.asarray(Image.fromarray(img).resize(
        (w * scale, h * scale), Image.BICUBIC))


BACKENDS = ("auto", "rrdbnet", "torch", "pil")


class Upscaler:
    """One backend, chosen and loaded once; `up(img)` upscales a u8
    (H, W, 3) image `scale` x.

    `weights`: a checkpoint path.  With one, the backend is the RRDBNet
    on that file, whatever `backend` says: nothing is fetched, and a
    file that is missing or does not load raises.  Without one, `auto`
    and `rrdbnet` look the release weights up with `fetch_weights`, and
    `auto` falls back to `torch` (saying so on stderr) when that finds
    none.  `device`: the card unless the caller asks for another (`pil`
    runs on the host)."""

    def __init__(self, scale: int = 4, backend: str = "auto", device=None,
                 weights: str | None = None):
        from dsrt_tpu_torch.device import resolve_device

        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}")
        self.scale, self.net = scale, None
        self.device = None if backend == "pil" else resolve_device(device)
        if backend in ("auto", "rrdbnet") and weights is None:
            try:
                weights = fetch_weights(scale)
            except FileNotFoundError as e:
                if backend == "rrdbnet":
                    raise
                print(f"rrdbnet weights unavailable ({e}); falling back to "
                      "torch bicubic", file=sys.stderr)
                backend = "torch"
        if weights is not None:
            from dsrt_tpu_torch.models.esrgan import load_torch_checkpoint
            self.net = load_torch_checkpoint(weights, scale=scale,
                                             device=self.device)
            backend = "rrdbnet"
        self.backend = backend

    def issue(self, img: np.ndarray):
        """`img`'s upscale as an `esrgan.PendingUpscale`: on the device
        and not yet waited for through the network, complete through
        the other backends."""
        from dsrt_tpu_torch.models import esrgan
        if self.backend == "rrdbnet":
            return esrgan.upscale_u8_async(self.net, img)
        import torch
        return esrgan.PendingUpscale(torch.from_numpy(self(img)))

    def __call__(self, img: np.ndarray) -> np.ndarray:
        if self.backend == "rrdbnet":
            # through the module, so that a wrapper of upscale_u8 is used
            from dsrt_tpu_torch.models import esrgan
            return esrgan.upscale_u8(self.net, img)
        if self.backend == "torch":
            return upsample_torch(img, self.scale, self.device)
        return upsample_pil(img, self.scale)


def process_folder(in_path: str, out_dir: str, scale: int = 4,
                   backend: str = "auto", device=None) -> int:
    """Upscale every PNG of `in_path` (or the one image) into `out_dir`;
    returns the number written.  `device`: the card unless the caller
    asks for another."""
    from dsrt_tpu_torch.utils.image_io import load_image_rgb8, write_png

    up = Upscaler(scale, backend, device)
    os.makedirs(out_dir, exist_ok=True)
    if os.path.isdir(in_path):
        files = sorted(glob.glob(os.path.join(in_path, "*.png")))
    else:
        files = [in_path]
    n = 0
    for f in files:
        write_png(os.path.join(out_dir, os.path.basename(f)),
                  up(load_image_rgb8(f)))
        n += 1
    print(f"[+] upsampled {n} image(s) x{scale} via {up.backend} -> "
          f"{out_dir}")
    return n


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="dsrt_tpu_torch.scripts.upsample")
    p.add_argument("--in", dest="in_path", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--scale", type=int, default=4, choices=(2, 4))
    p.add_argument("--backend", default="auto", choices=BACKENDS)
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (the default) or cpu")
    args = p.parse_args(argv)
    process_folder(args.in_path, args.out, args.scale, args.backend,
                   args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
