"""Small scenes that exercise each feature of the path kernel, built by
any scene builder with the reference SceneBuilder's interface.

`chip_smoke.py` builds them with the port's SceneBuilder and Material to
hold the kernel against its plain version; the CPU tests build the same
scenes with the JAX package's classes to hold the plain version against
the JAX renderers.  This module imports neither: every function takes the
builder class `B`, the Material class `M` and, where a scene needs the
procedural stand-in, the `iss_standin_mesh` function of either package.

CASES maps a case name to (scene function, look-from, look-at, vfov,
RenderConfig extras).  `aperture` in the extras goes to the camera too.
"""

from __future__ import annotations

import types

import numpy as np

# the tests' pose of the small scenes (tests/test_fused_mixed.py)
MIX_LOOK = ((0.0, 0.4, 1.6), (0.0, -0.2, -2.5), 60.0)
MEDIA_LOOK = ((0.0, 0.2, 1.6), (0.0, -0.3, -2.0), 55.0)


def mesh_floor(b, M) -> None:
    """A two-triangle floor and a raised triangle."""
    m = M.lambertian((0.7, 0.7, 0.65))
    b.add_triangle((-3, -1, -5), (3, -1, -5), (3, -1, 1), m)
    b.add_triangle((-3, -1, -5), (3, -1, 1), (-3, -1, 1), m)
    b.add_triangle((-1.5, -1, -3), (-0.5, -1, -3), (-1.0, 0.2, -3.2),
                   M.lambertian((0.3, 0.5, 0.8)))


def sphere_mix(B, M, **_):
    """Mesh with diffuse, metal and glass spheres under the sun; the metal
    sphere shadows the floor."""
    b = B(sun_enabled=True, sun_dir=(0.25, -0.8, -0.4),
          sun_radiance=(6.0, 5.7, 5.4))
    mesh_floor(b, M)
    b.add_sphere((0.6, -0.4, -2.6), 0.6, M.lambertian((0.8, 0.3, 0.3)))
    b.add_sphere((-0.9, 0.6, -2.2), 0.35, M.metal((0.8, 0.8, 0.9), fuzz=0.1))
    b.add_sphere((0.0, -0.6, -1.6), 0.4, M.dielectric(1.5))
    return b


def quad_light(B, M, **_):
    """Mesh floor, two wall quads and an emissive quad overhead."""
    b = B(sun_enabled=False)
    mesh_floor(b, M)
    b.add_quad((-2, -1, -4.5), (4, 0, 0), (0, 3, 0),
               M.lambertian((0.73, 0.73, 0.73)))
    b.add_quad((-2, -1, -4.5), (0, 3, 0), (0, 0, 4),
               M.lambertian((0.12, 0.45, 0.15)))
    b.add_quad((-0.7, 1.8, -3.4), (1.4, 0, 0), (0, 0, 1.2),
               M.diffuse_light((8.0, 8.0, 7.0)))
    return b


def sphere_light(B, M, **_):
    """Mesh floor, an emissive sphere and a diffuse sphere, sun off."""
    b = B(sun_enabled=False)
    mesh_floor(b, M)
    b.add_sphere((0.8, 1.6, -2.8), 0.5, M.diffuse_light((10.0, 9.0, 8.0)))
    b.add_sphere((-0.6, -0.5, -2.3), 0.5, M.lambertian((0.4, 0.6, 0.9)))
    return b


def cornell(B, M, seed: int = 1337, **_):
    """A unit Cornell box of quads: five walls, a quad area light under
    the ceiling and two boxes; sun off (models/presets.py
    cornell_box_scene)."""
    b = B(sun_enabled=False, seed=seed)
    red = M.lambertian((0.65, 0.05, 0.05))
    white = M.lambertian((0.73, 0.73, 0.73))
    green = M.lambertian((0.12, 0.45, 0.15))
    b.add_quad((1, 0, 0), (0, 1, 0), (0, 0, 1), green)
    b.add_quad((0, 0, 0), (0, 1, 0), (0, 0, 1), red)
    b.add_quad((0.35, 1 - 1e-3, 0.35), (0.3, 0, 0), (0, 0, 0.3),
               M.diffuse_light((15.0, 15.0, 15.0)))
    b.add_quad((0, 0, 0), (1, 0, 0), (0, 0, 1), white)
    b.add_quad((0, 1, 0), (1, 0, 0), (0, 0, 1), white)
    b.add_quad((0, 0, 1), (1, 0, 0), (0, 1, 0), white)
    b.add_box((0.15, 0.0, 0.10), (0.45, 0.55, 0.40), white)
    b.add_box((0.55, 0.0, 0.50), (0.85, 0.30, 0.80), white)
    return b


def mesh_media(B, M, light: bool = False, **_):
    """Floor and a metal triangle inside a box medium and beside a sphere
    medium, sun on; with `light`, a sphere light too."""
    b = B(sun_enabled=True, sun_dir=(0.2, -0.8, -0.3),
          sun_radiance=(30.0, 30.0, 28.0), seed=1337)
    m = M.lambertian((0.7, 0.7, 0.7))
    b.add_triangle((-2, -1, -3), (2, -1, -3), (2, -1, 1), m)
    b.add_triangle((-2, -1, -3), (2, -1, 1), (-2, -1, 1), m)
    b.add_triangle((-0.6, -1, -2), (0.6, -1, -2), (0, 0.4, -2),
                   M.metal((0.85, 0.85, 0.9), fuzz=0.1))
    b.add_constant_medium_box((-1.2, -1.0, -2.6), (0.2, 0.2, -1.4),
                              density=1.2, albedo=(0.8, 0.85, 0.9))
    b.add_constant_medium_sphere((0.9, -0.4, -1.6), 0.5, density=2.0,
                                 albedo=(0.9, 0.6, 0.5))
    if light:
        b.add_sphere((0.0, 1.6, -1.6), 0.3, M.diffuse_light((14.0, 13.0, 12.0)))
    return b


def ptex_tris(B, M, **_):
    """Checker floor and a marble triangle, sun on."""
    b = B(sun_enabled=True, sun_dir=(0.2, -0.8, -0.3),
          sun_radiance=(25.0, 25.0, 24.0), seed=1337)
    g = M.checker((0.2, 0.3, 0.1), (0.9, 0.9, 0.9), scale=3.0)
    b.add_triangle((-2, -1, -3), (2, -1, -3), (2, -1, 1), g)
    b.add_triangle((-2, -1, -3), (2, -1, 1), (-2, -1, 1), g)
    b.add_triangle((-0.6, -1, -2), (0.6, -1, -2), (0, 0.4, -2),
                   M.marble(scale=2.0))
    return b


def dof(B, M, **_):
    """Floor and a red triangle for the thin lens, sun on."""
    b = B(sun_enabled=True, sun_dir=(0.2, -0.8, -0.3),
          sun_radiance=(25.0, 25.0, 24.0), seed=1337)
    m = M.lambertian((0.7, 0.7, 0.7))
    b.add_triangle((-2, -1, -3), (2, -1, -3), (2, -1, 1), m)
    b.add_triangle((-2, -1, -3), (2, -1, 1), (-2, -1, 1), m)
    b.add_triangle((-0.5, -1, -2), (0.5, -1, -2), (0, 0.2, -2),
                   M.lambertian((0.8, 0.3, 0.3)))
    return b


def motion_blur(B, M, **_):
    """Mesh floor, a moving diffuse sphere and a metal sphere, sun on."""
    b = B(sun_enabled=True, sun_dir=(0.25, -0.8, -0.4),
          sun_radiance=(6.0, 5.7, 5.4))
    mesh_floor(b, M)
    b.add_sphere((0.6, -0.4, -2.6), 0.5, M.lambertian((0.8, 0.3, 0.3)),
                 center2=(-0.6, -0.4, -2.6))
    b.add_sphere((-0.9, 0.6, -2.2), 0.35, M.metal((0.8, 0.8, 0.9), fuzz=0.1))
    return b


def env_array(seed: int = 5) -> np.ndarray:
    """An 8x16 equirect sky of random linear radiance in [0, 2)."""
    rng = np.random.default_rng(seed)
    return rng.uniform(0.0, 2.0, (8, 16, 3)).astype(np.float32)


def env_sky(B, M, **_):
    """Mesh floor and a metal sphere under an equirect sky, sun off."""
    b = B(sun_enabled=False, seed=1337)
    mesh_floor(b, M)
    b.add_sphere((0.3, -0.3, -2.4), 0.5, M.metal((0.9, 0.9, 0.9), fuzz=0.05))
    b.set_environment(env_array(), rotation_deg=30.0, scale=1.5)
    return b


def uv_sphere_mesh(M, center, radius: float, n_lat: int = 6,
                   n_lon: int = 10):
    """A faceted sphere of triangles with its exact vertex normals, as a
    mesh with n0/n1/n2 (what an OBJ with `vn` lines loads to)."""
    th = np.linspace(0.0, np.pi, n_lat + 1)
    ph = np.linspace(0.0, 2.0 * np.pi, n_lon + 1)
    nrm = np.stack([np.outer(np.sin(th), np.cos(ph)),
                    np.outer(np.cos(th), np.ones_like(ph)),
                    np.outer(np.sin(th), np.sin(ph))], -1)
    pos = np.asarray(center, np.float64) + radius * nrm
    tris = []
    for i in range(n_lat):
        for j in range(n_lon):
            a, b_, c, d = (i, j), (i + 1, j), (i + 1, j + 1), (i, j + 1)
            if i > 0:
                tris.append((a, c, b_))
            if i < n_lat - 1:
                tris.append((a, d, c))
    idx = np.asarray(tris)

    def corner(arr, k):
        return arr[idx[:, k, 0], idx[:, k, 1]].astype(np.float32)

    n = len(idx)
    zuv = np.zeros((n, 2), np.float32)
    return types.SimpleNamespace(
        v0=corner(pos, 0), v1=corner(pos, 1), v2=corner(pos, 2),
        uv0=zuv, uv1=zuv, uv2=zuv,
        materials=[M.lambertian((0.8, 0.5, 0.3))] * n, tex_paths=[""] * n,
        n0=corner(nrm, 0), n1=corner(nrm, 1), n2=corner(nrm, 2))


def smooth(B, M, **_):
    """A smooth-shaded faceted sphere (vertex normals) on a flat floor."""
    b = B(sun_enabled=True, sun_dir=(0.25, -0.8, -0.4),
          sun_radiance=(6.0, 5.7, 5.4))
    mesh_floor(b, M)
    b.add_mesh(uv_sphere_mesh(M, (0.2, -0.3, -2.5), 0.7))
    return b


def textured_spheres(B, M, tex_path: str = "", **_):
    """A textured floor (image at `tex_path`) with a sphere sharing its
    material object and a metal sphere, sun on."""
    b = B(sun_enabled=True, sun_dir=(0.0, -0.3, -1.0),
          sun_radiance=(8.0, 8.0, 8.0))
    mat = M.lambertian((0.9, 0.9, 0.9))
    b.add_triangle((-2, -1, -3), (2, -1, -3), (2, -1, 1), mat,
                   uv0=(0, 1), uv1=(3, 1), uv2=(3, -2), tex_path=tex_path)
    b.add_triangle((-2, -1, -3), (2, -1, 1), (-2, -1, 1), mat,
                   uv0=(0, 1), uv1=(3, -2), uv2=(0, -2), tex_path=tex_path)
    b.add_sphere((0.0, -0.4, -1.2), 0.45, mat)
    b.add_sphere((-0.8, -0.2, -1.8), 0.3, M.metal((0.9, 0.8, 0.7), fuzz=0.05))
    return b


def volumetric_mesh(B, M, standin_mesh=None, detail: int = 4, **_):
    """The stand-in inside a fog sphere (r 70, density 0.004), sun on:
    the JAX bench's volumetric-mesh cell (bench.py:540-549)."""
    b = B(sun_enabled=True, sun_dir=(0.35, 0.65, 0.4),
          sun_radiance=(1e5, 9.5e4, 9e4), seed=1337, bvh_method="sbvh")
    b.add_mesh(standin_mesh(detail))
    b.add_constant_medium_sphere((0.0, 0.0, 0.0), 70.0, density=0.004,
                                 albedo=(0.85, 0.9, 0.95))
    return b


CASES = {
    "sphere_mix": (sphere_mix, *MIX_LOOK, {}),
    "quad_light": (quad_light, *MIX_LOOK, {}),
    "sphere_light": (sphere_light, *MIX_LOOK, {}),
    "cornell": (cornell, (0.5, 0.5, -1.3), (0.5, 0.5, 0.5), 40.0, {}),
    "mesh_media": (mesh_media, *MEDIA_LOOK, {}),
    "mesh_media_light": (lambda B, M, **kw: mesh_media(B, M, light=True,
                                                       **kw),
                         *MEDIA_LOOK, {}),
    "ptex": (ptex_tris, *MEDIA_LOOK, {}),
    "dof": (dof, *MEDIA_LOOK, dict(aperture=0.35)),
    "motion_blur": (motion_blur, (0.0, 0.3, 1.2), (0.0, 0.0, -2.0), 60.0,
                    dict(time0=0.1, time1=0.9)),
    "env": (env_sky, *MIX_LOOK, {}),
    "smooth": (smooth, *MIX_LOOK, {}),
    "textured_spheres": (textured_spheres, (0.0, 0.4, 1.2), (0.0, -0.3, -2.0),
                         60.0, {}),
}
