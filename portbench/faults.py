"""Faults planted in the timed path, to show that the check catches them.

The render's faults wrap the program's `driver.render_frame_async`, the
call that issues every frame of the window:

- `stale`: every frame returns the first frame issued (a step that
  returns its state unchanged);
- `half`: half the samples, the mean taken over them (half of the batch
  left out);
- `altered`: the frame's red channel altered by one where it is made.

The upscale stage's faults wrap the program's
`models.esrgan.upscale_u8_async`, the call that issues every frame's
upscale (the driver's stage finishes what it returns, one frame later):

- `upstale`: every output is the first frame's;
- `bicubic`: the stage replaced by the program's bicubic upsampler;
- `noblock`: the last RRDB of the network skipped (RRDBNet's only: a
  network whose `body` is its list of RRDBs).

`python3 -m portbench.run ... --fault <name>` runs a cell with one of
them planted; benchmark runs never do.
"""

from __future__ import annotations

import dataclasses


def stale(orig):
    held = []

    def issue(*a, **k):
        f = orig(*a, **k)
        held.append(f)
        return held[0]
    return issue


def half(orig):
    def issue(scene, cam, cfg, **k):
        return orig(scene, cam, dataclasses.replace(cfg, spp=cfg.spp // 2),
                    **k)
    return issue


def altered(orig):
    def issue(*a, **k):
        f = orig(*a, **k)
        if f.done is not None:
            f.done.synchronize()
        img = f.img.clone()
        img[..., 0] ^= 1
        return dataclasses.replace(f, img=img, done=None)
    return issue


def upstale(orig):
    held = []

    def upscale(*a, **k):
        held.append(orig(*a, **k))
        return held[0]
    return upscale


def bicubic(orig):
    def upscale(net, img_u8, *a, **k):
        import torch

        from dsrt_tpu_torch.models.esrgan import PendingUpscale
        from dsrt_tpu_torch.scripts.upsample import upsample_torch
        return PendingUpscale(torch.from_numpy(upsample_torch(
            img_u8, net.scale, next(net.parameters()).device)))
    return upscale


def noblock(orig):
    """RRDBNet's only: the network's `body` is its RRDBs."""
    def upscale(net, *a, **k):
        body = net.body
        net.body = body[:-1]
        try:
            return orig(net, *a, **k)
        finally:
            net.body = body
    return upscale


# name -> (module, function wrapped, fault)
FAULTS = {"stale": ("driver", "render_frame_async", stale),
          "half": ("driver", "render_frame_async", half),
          "altered": ("driver", "render_frame_async", altered),
          "upstale": ("models.esrgan", "upscale_u8_async", upstale),
          "bicubic": ("models.esrgan", "upscale_u8_async", bicubic),
          "noblock": ("models.esrgan", "upscale_u8_async", noblock)}


def plant(name: str) -> None:
    """Wrap the program's function that the fault `name` breaks."""
    import importlib
    mod_name, attr, fault = FAULTS[name]
    mod = importlib.import_module(f"dsrt_tpu_torch.{mod_name}")
    setattr(mod, attr, fault(getattr(mod, attr)))
