"""Triangle test scenes (port of dsrt_tpu/models/presets.py:72-98)."""

from __future__ import annotations

import numpy as np

from dsrt_tpu.models.materials import Material
from dsrt_tpu_torch.models.scene import Scene, SceneBuilder


def single_triangle_scene(sun: bool = True, seed: int = 1337,
                          device="cpu") -> Scene:
    """One triangle facing +Z."""
    b = SceneBuilder(sun_enabled=sun, sun_dir=(0.0, -0.3, -1.0),
                     sun_radiance=(5.0, 5.0, 5.0), seed=seed)
    mat = Material.lambertian((0.7, 0.3, 0.3))
    b.add_triangle((-1.0, -1.0, -2.0), (1.0, -1.0, -2.0), (0.0, 1.0, -2.0),
                   mat)
    return b.build(device=device)


def random_tri_soup_scene(n: int = 256, sun: bool = True, seed: int = 1337,
                          rng_seed: int = 7, device="cpu") -> Scene:
    """Random triangle soup in a unit-ish box in front of the camera."""
    rng = np.random.default_rng(rng_seed)
    b = SceneBuilder(sun_enabled=sun, sun_dir=(-0.2, -1.0, -0.4),
                     sun_radiance=(6.0, 6.0, 6.0), seed=seed)
    mats = [Material.lambertian(tuple(rng.uniform(0.2, 0.9, 3))),
            Material.metal(tuple(rng.uniform(0.5, 0.95, 3)), fuzz=0.1),
            Material.lambertian((0.73, 0.73, 0.73))]
    centers = rng.uniform([-1.5, -1.0, -4.0], [1.5, 1.0, -2.0], (n, 3))
    for i in range(n):
        c = centers[i]
        e1 = rng.normal(0, 0.12, 3)
        e2 = rng.normal(0, 0.12, 3)
        b.add_triangle(c, c + e1, c + e2, mats[i % len(mats)])
    return b.build(device=device)
