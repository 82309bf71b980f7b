"""Procedural test meshes and the scenes built from them.

A copy of the ISS stand-in generator of dsrt_tpu/models/mesh_gen.py
(:22-192: `MeshAccum`, `iss_standin_mesh`), and its two scenes on the
port's scene compiler: `iss_standin_scene` (:195-212) and
`iss_mixed_scene` (:215-240), the stand-in mesh plus three free-flying
spheres, which no megakernel of the port covers, so it renders through
the split pipeline (render_frame_wavefront / render_frame_queue).

The reference renders NASA's `ISS_stationary.obj`, which is not in its
repo; the generator builds an ISS-like model — central truss, pressurized
modules, radiators and solar arrays — with a controllable triangle
budget, emitted as MeshData so it flows through the same scene-compile
path as a loaded OBJ.
"""

from __future__ import annotations

import math

import numpy as np

from dsrt_tpu_torch.models.materials import Material
from dsrt_tpu_torch.models.obj import MeshData
from dsrt_tpu_torch.models.scene import Scene, SceneBuilder
from dsrt_tpu_torch.utils.image_io import write_png


def _empty():
    return [], [], [], [], [], [], [], []


class MeshAccum:
    def __init__(self) -> None:
        (self.v0, self.v1, self.v2, self.u0, self.u1, self.u2,
         self.mats, self.texs) = _empty()

    def tri(self, a, b, c, mat: Material, uva=(0, 0), uvb=(0, 0), uvc=(0, 0),
            tex: str = "") -> None:
        self.v0.append(np.asarray(a, np.float32))
        self.v1.append(np.asarray(b, np.float32))
        self.v2.append(np.asarray(c, np.float32))
        self.u0.append(np.asarray(uva, np.float32))
        self.u1.append(np.asarray(uvb, np.float32))
        self.u2.append(np.asarray(uvc, np.float32))
        self.mats.append(mat)
        self.texs.append(tex)

    def quad(self, a, b, c, d, mat: Material, tex: str = "",
             subdiv: int = 1) -> None:
        """Quad a-b-c-d (ccw) split into a subdiv x subdiv triangle grid."""
        a, b, c, d = (np.asarray(p, np.float32) for p in (a, b, c, d))
        n = subdiv
        for i in range(n):
            for j in range(n):
                s0, s1 = i / n, (i + 1) / n
                t0, t1 = j / n, (j + 1) / n

                def lerp2(s, t):
                    return (a * (1 - s) * (1 - t) + b * s * (1 - t)
                            + d * (1 - s) * t + c * s * t)

                p00, p10 = lerp2(s0, t0), lerp2(s1, t0)
                p01, p11 = lerp2(s0, t1), lerp2(s1, t1)
                self.tri(p00, p10, p11, mat, (s0, t0), (s1, t0), (s1, t1), tex)
                self.tri(p00, p11, p01, mat, (s0, t0), (s1, t1), (s0, t1), tex)

    def box(self, center, half, mat: Material, subdiv: int = 1) -> None:
        cx, cy, cz = center
        hx, hy, hz = half
        lo = np.array([cx - hx, cy - hy, cz - hz], np.float32)
        hi = np.array([cx + hx, cy + hy, cz + hz], np.float32)
        x0, y0, z0 = lo
        x1, y1, z1 = hi
        q = self.quad
        q((x0, y0, z1), (x1, y0, z1), (x1, y1, z1), (x0, y1, z1), mat, subdiv=subdiv)  # +z
        q((x1, y0, z0), (x0, y0, z0), (x0, y1, z0), (x1, y1, z0), mat, subdiv=subdiv)  # -z
        q((x1, y0, z1), (x1, y0, z0), (x1, y1, z0), (x1, y1, z1), mat, subdiv=subdiv)  # +x
        q((x0, y0, z0), (x0, y0, z1), (x0, y1, z1), (x0, y1, z0), mat, subdiv=subdiv)  # -x
        q((x0, y1, z1), (x1, y1, z1), (x1, y1, z0), (x0, y1, z0), mat, subdiv=subdiv)  # +y
        q((x0, y0, z0), (x1, y0, z0), (x1, y0, z1), (x0, y0, z1), mat, subdiv=subdiv)  # -y

    def cylinder(self, p0, p1, radius: float, mat: Material,
                 segments: int = 12, caps: bool = True) -> None:
        p0 = np.asarray(p0, np.float32)
        p1 = np.asarray(p1, np.float32)
        axis = p1 - p0
        az = axis / max(np.linalg.norm(axis), 1e-9)
        ref = np.array([0, 1, 0], np.float32) if abs(az[1]) < 0.9 \
            else np.array([1, 0, 0], np.float32)
        ax = np.cross(az, ref)
        ax /= max(np.linalg.norm(ax), 1e-9)
        ay = np.cross(az, ax)
        ring0, ring1 = [], []
        for s in range(segments):
            ang = 2 * math.pi * s / segments
            off = (radius * (math.cos(ang) * ax + math.sin(ang) * ay)
                   ).astype(np.float32)
            ring0.append(p0 + off)
            ring1.append(p1 + off)
        for s in range(segments):
            a, b = ring0[s], ring0[(s + 1) % segments]
            c, d = ring1[(s + 1) % segments], ring1[s]
            self.tri(a, b, c, mat)
            self.tri(a, c, d, mat)
            if caps:
                self.tri(p0, b, a, mat)
                self.tri(p1, ring1[s], ring1[(s + 1) % segments], mat)

    def build(self) -> MeshData:
        n = len(self.v0)
        s3 = (n, 3) if n else (0, 3)
        s2 = (n, 2) if n else (0, 2)
        return MeshData(
            v0=np.asarray(self.v0, np.float32).reshape(s3),
            v1=np.asarray(self.v1, np.float32).reshape(s3),
            v2=np.asarray(self.v2, np.float32).reshape(s3),
            uv0=np.asarray(self.u0, np.float32).reshape(s2),
            uv1=np.asarray(self.u1, np.float32).reshape(s2),
            uv2=np.asarray(self.u2, np.float32).reshape(s2),
            materials=self.mats, tex_paths=self.texs)


def iss_standin_mesh(detail: int = 2, tex_path: str = "",
                     tex_paths=()) -> MeshData:
    """ISS-like station, ~meters scale, centered at origin.

    detail=1 -> ~0.8k tris, detail=2 -> ~2.4k, detail=3 -> ~5k,
    detail=4 -> ~9k, detail=6 -> ~20k (the real ISS OBJ is tens of
    thousands).

    With `tex_path` the solar-array and radiator quads carry that image
    texture (per-triangle map_Kd, the real NASA OBJ's layout —
    inc/triangle_mesh.h:244-251); their materials then follow the
    builder's textured-albedo-forced-white contract.

    With `tex_paths` (a sequence) each solar WING cycles through its
    own map and the radiators take the last one — the real multi-MTL
    OBJ layout where every surface has a distinct map_Kd, so a wave's
    texel footprint localizes to the 1-2 maps its hits use (the
    designed win case of the chunked/tiled in-kernel pool gather).
    """
    m = MeshAccum()
    hull = Material.lambertian((0.73, 0.73, 0.73))
    truss_m = Material.lambertian((0.55, 0.55, 0.58))
    tex_paths = tuple(tex_paths)
    if tex_paths and not tex_path:
        tex_path = tex_paths[0]
    if tex_path:
        panel = Material.lambertian((0.25, 0.2, 0.45), tex_path=tex_path)
        radiator = Material.lambertian(
            (0.85, 0.85, 0.88),
            tex_path=tex_paths[-1] if tex_paths else tex_path)
    else:
        panel = Material.lambertian((0.25, 0.2, 0.45))
        radiator = Material.lambertian((0.85, 0.85, 0.88))
    gold = Material.metal((0.8, 0.65, 0.3), fuzz=0.25)
    seg = 8 + 8 * detail

    # main truss along x (~109 m real span)
    m.box((0, 0, 0), (52, 1.6, 1.6), truss_m, subdiv=2 * detail)

    # pressurized modules along z
    m.cylinder((0, 0, -28), (0, 0, 24), 3.4, hull, segments=seg)
    m.cylinder((-10, 0, 6), (10, 0, 6), 2.6, hull, segments=seg)  # node row
    m.cylinder((0, -6, 2), (0, 6, 2), 2.2, gold, segments=seg)     # airlock
    # docked vehicle
    m.cylinder((0, 0, -34), (0, 0, -28), 1.8, gold, segments=seg)

    # 4 solar array wing pairs at the truss ends (each wing ~34x12 m);
    # with tex_paths every wing cycles through its own map_Kd (its own
    # forced-white material, like a real per-surface-MTL OBJ)
    wing = 4 * detail
    wi = 0
    for sx in (-1, 1):
        for wx in (34.0, 46.0):
            x = sx * wx
            for sy in (-1, 1):
                if tex_paths:
                    wtex = tex_paths[wi % len(tex_paths)]
                    wmat = Material.lambertian((0.25, 0.2, 0.45),
                                               tex_path=wtex)
                else:
                    wtex, wmat = tex_path, panel
                wi += 1
                y0, y1 = 2.5 * sy, (2.5 + 34.0) * sy
                m.quad((x - 6, y0, -0.2), (x + 6, y0, -0.2),
                       (x + 6, y1, -0.2), (x - 6, y1, -0.2),
                       wmat, tex=wtex, subdiv=wing)

    # radiators
    rtex = tex_paths[-1] if tex_paths else tex_path
    for sx in (-1, 1):
        x = sx * 14.0
        m.quad((x - 1.5, -1.8, 3), (x + 1.5, -1.8, 3),
               (x + 1.5, -1.8, 25), (x - 1.5, -1.8, 25),
               radiator, tex=rtex, subdiv=2 * detail)

    return m.build()


def write_panel_texture(path: str, size: int = 256) -> None:
    """Deterministic solar-panel cell grid PNG (the flagship scene's
    map_Kd; same image as the reference benchmark's panel)."""
    y, x = np.mgrid[0:size, 0:size]
    cell = ((x // 16 + y // 16) % 2).astype(np.float32)
    grid = ((x % 16 < 1) | (y % 16 < 1)).astype(np.float32)
    r = 40 + 30 * cell
    g = 35 + 25 * cell + 18
    b = 110 + 60 * cell
    img = np.stack([r, g, b], axis=-1)
    img = img * (1.0 - 0.7 * grid[..., None]) + 220.0 * 0.2 * grid[..., None]
    write_png(path, np.clip(img, 0, 255).astype(np.uint8))


def iss_standin_scene(detail: int = 2, sun_dir=(0.35, 0.65, 0.4),
                      sun_radiance=(1e5, 9.5e4, 9e4), seed: int = 1337,
                      bvh_method: str = "sbvh", tex_path: str = "",
                      sbvh_alpha: float = 1e-5, tex_paths=(),
                      device=None) -> Scene:
    """Stand-in station at the origin with a directional sun; `sun_dir` is
    the model->Sun direction as the pose pipeline supplies it (the
    renderer negates it; default the reference's (0.35, 0.65, 0.4)).
    `tex_path` textures the solar-panel and radiator quads; `tex_paths`
    gives each solar wing its own map (iss_standin_mesh).  On the card
    unless `device` says otherwise."""
    b = SceneBuilder(sun_enabled=True, sun_dir=sun_dir,
                     sun_radiance=sun_radiance, seed=seed,
                     bvh_method=bvh_method, sbvh_alpha=sbvh_alpha)
    b.add_mesh(iss_standin_mesh(detail, tex_path=tex_path,
                                tex_paths=tex_paths))
    return b.build(device=device)


def iss_mixed_scene(detail: int = 4, device=None, **kw) -> Scene:
    """The stand-in mesh plus free-flying primitives (a visiting-vehicle
    sphere pair and a metal tank): triangles and spheres in one scene,
    SBVH like iss_standin_scene.  `kw` goes to SceneBuilder, with the
    stand-in's sun, seed and BVH method as defaults.  On the card unless
    `device` says otherwise."""
    opts = dict(sun_enabled=True, sun_dir=(0.35, 0.65, 0.4),
                sun_radiance=(1e5, 9.5e4, 9e4), seed=1337, bvh_method="sbvh")
    b = SceneBuilder(**{**opts, **kw})
    b.add_mesh(iss_standin_mesh(detail))
    b.add_sphere((12.0, 6.0, -14.0), 2.2,
                 Material.lambertian((0.82, 0.8, 0.78)))
    b.add_sphere((14.5, 4.5, -10.5), 1.1,
                 Material.lambertian((0.35, 0.36, 0.4)))
    b.add_sphere((-10.0, -5.0, 12.0), 1.6,
                 Material.metal((0.75, 0.76, 0.8), fuzz=0.15))
    return b.build(device=device)
