"""Test scenes (port of dsrt_tpu/models/presets.py:21-98).

- `rtiow_smoke_scene`: ground + three spheres (lambertian, dielectric,
  metal), sun on; sphere scenes of this kind go to the sphere kernel.
- `sphere_light_scene`: one emissive sphere over diffuse geometry, sun
  off; exercises light picking and the asymmetric mixture pdf.
- `volumetric_scene`: a constant-medium fog sphere, checker and marble
  textures, a sphere light and the sun.
- `dof_motion_scene`, `env_sphere_scene`: sphere scenes for depth of
  field with motion blur, and for the environment-map sky.
- `single_triangle_scene`, `random_tri_soup_scene`: triangle scenes.
"""

from __future__ import annotations

import numpy as np

from dsrt_tpu.models.materials import Material
from dsrt_tpu_torch.models.scene import Scene, SceneBuilder


def rtiow_smoke_scene(sun: bool = True, seed: int = 1337,
                      device="cpu") -> Scene:
    b = SceneBuilder(sun_enabled=sun, sun_dir=(-0.4, -0.8, -0.45),
                     sun_radiance=(6.0, 5.7, 5.4), seed=seed)
    b.add_sphere((0.0, -100.5, -1.0), 100.0,
                 Material.lambertian((0.8, 0.8, 0.0)))
    b.add_sphere((0.0, 0.0, -1.0), 0.5, Material.lambertian((0.1, 0.2, 0.5)))
    b.add_sphere((-1.0, 0.0, -1.0), 0.5, Material.dielectric(1.5))
    b.add_sphere((1.0, 0.0, -1.0), 0.5,
                 Material.metal((0.8, 0.6, 0.2), fuzz=0.05))
    return b.build(device=device)


def sphere_light_scene(seed: int = 1337, device="cpu") -> Scene:
    b = SceneBuilder(sun_enabled=False, seed=seed)
    b.add_sphere((0.0, -100.5, -1.0), 100.0,
                 Material.lambertian((0.73, 0.73, 0.73)))
    b.add_sphere((-0.6, 0.0, -1.2), 0.5, Material.lambertian((0.6, 0.2, 0.2)))
    b.add_sphere((0.7, 0.0, -1.0), 0.5, Material.metal((0.9, 0.9, 0.9),
                                                       fuzz=0.0))
    b.add_sphere((0.0, 2.2, -1.0), 0.6,
                 Material.diffuse_light((12.0, 11.0, 10.0)))
    return b.build(device=device)


def volumetric_scene(seed: int = 1337, device="cpu") -> Scene:
    b = SceneBuilder(sun_enabled=True, sun_dir=(-0.3, -0.9, -0.2),
                     sun_radiance=(7.0, 6.6, 6.2), seed=seed)
    b.add_sphere((0.0, -100.5, -1.0), 100.0,
                 Material.checker((0.2, 0.3, 0.1), (0.9, 0.9, 0.9),
                                  scale=4.0))
    b.add_sphere((0.7, 0.0, -1.1), 0.5, Material.marble(scale=2.0))
    b.add_sphere((0.0, 2.4, -1.0), 0.5,
                 Material.diffuse_light((10.0, 10.0, 9.0)))
    b.add_constant_medium_sphere((-0.7, 0.1, -1.0), 0.55, density=2.5,
                                 albedo=(0.8, 0.85, 0.9))
    return b.build(device=device)


def dof_motion_scene(sun: bool = False, seed: int = 1337,
                     device="cpu") -> Scene:
    """A moving diffuse sphere, a small fuzzy metal sphere and a sphere
    light over the ground (the scene of tests/test_fused_spheres.py
    `_dof_motion_scene`); render with an aperture and an open shutter."""
    b = SceneBuilder(sun_enabled=sun, seed=seed)
    b.add_sphere((0.0, -100.5, -1.0), 100.0,
                 Material.lambertian((0.8, 0.8, 0.0)))
    b.add_sphere((-0.4, 0.0, -1.0), 0.35,
                 Material.lambertian((0.1, 0.2, 0.7)),
                 center2=(0.4, 0.1, -1.0))
    b.add_sphere((0.3, -0.1, -0.6), 0.2,
                 Material.metal((0.8, 0.7, 0.6), fuzz=0.1))
    b.add_sphere((0.0, 2.2, -1.0), 0.8,
                 Material.diffuse_light((8.0, 8.0, 8.0)))
    return b.build(device=device)


def env_sphere_scene(env: np.ndarray, rotation_deg: float = 0.0,
                     scale: float = 1.0, seed: int = 1337,
                     device="cpu") -> Scene:
    """Two spheres under an equirectangular sky `env`, an (H, W, 3)
    linear float array (the scene of tests/test_envmap.py `_scene`)."""
    b = SceneBuilder(sun_enabled=False, seed=seed)
    b.add_sphere((0.0, 0.0, -2.0), 0.6,
                 Material.lambertian((0.6, 0.6, 0.6)))
    b.add_sphere((1.2, 0.0, -2.0), 0.4,
                 Material.metal((0.9, 0.9, 0.9), fuzz=0.05))
    b.set_environment(env, rotation_deg=rotation_deg, scale=scale)
    return b.build(device=device)


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
