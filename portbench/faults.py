"""Faults planted in the timed path, to show that the check catches them.

Each wraps the program's `driver.render_frame_async`, the call that issues
every frame of the window:

- `stale`: every frame returns the first frame issued (a step that
  returns its state unchanged);
- `half`: half the samples, the mean taken over them (half of the batch
  left out);
- `altered`: the frame's red channel altered by one where it is made.

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


FAULTS = {"stale": stale, "half": half, "altered": altered}


def plant(name: str) -> None:
    """Wrap the program's frame issue with the fault `name`."""
    from dsrt_tpu_torch import driver
    driver.render_frame_async = FAULTS[name](driver.render_frame_async)
