"""The ISS stand-in mesh, as plain numpy arrays.

Frozen copy of `MeshAccum` and `iss_standin_mesh` from
dsrt_tpu_torch/models/mesh_gen.py at commit 92c3b0f (single `tex_path`
form only).  The benchmark makes the mesh itself and hands the same
arrays to the program (wrapped in the program's MeshData by the harness)
and to the plain reference, so a later change to the program's generator
cannot change what is measured.  Materials are `Mat` records: one object
per material, shared by the triangles that use it, as the program's
SceneBuilder deduplicates materials by identity.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

LAMBERTIAN = 0
METAL = 1


@dataclasses.dataclass(eq=False)
class Mat:
    kind: int
    albedo: tuple
    fuzz: float = 0.0


@dataclasses.dataclass
class Mesh:
    v0: np.ndarray
    v1: np.ndarray
    v2: np.ndarray
    uv0: np.ndarray
    uv1: np.ndarray
    uv2: np.ndarray
    materials: list     # one Mat per triangle
    tex_paths: list     # one path ("" for none) per triangle


class _Accum:
    def __init__(self) -> None:
        self.v0, self.v1, self.v2 = [], [], []
        self.u0, self.u1, self.u2 = [], [], []
        self.mats, self.texs = [], []

    def tri(self, a, b, c, mat, uva=(0, 0), uvb=(0, 0), uvc=(0, 0),
            tex: str = "") -> None:
        self.v0.append(np.asarray(a, np.float32))
        self.v1.append(np.asarray(b, np.float32))
        self.v2.append(np.asarray(c, np.float32))
        self.u0.append(np.asarray(uva, np.float32))
        self.u1.append(np.asarray(uvb, np.float32))
        self.u2.append(np.asarray(uvc, np.float32))
        self.mats.append(mat)
        self.texs.append(tex)

    def quad(self, a, b, c, d, mat, tex: str = "", subdiv: int = 1) -> None:
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

    def box(self, center, half, mat, subdiv: int = 1) -> None:
        cx, cy, cz = center
        hx, hy, hz = half
        lo = np.array([cx - hx, cy - hy, cz - hz], np.float32)
        hi = np.array([cx + hx, cy + hy, cz + hz], np.float32)
        x0, y0, z0 = lo
        x1, y1, z1 = hi
        q = self.quad
        q((x0, y0, z1), (x1, y0, z1), (x1, y1, z1), (x0, y1, z1), mat, subdiv=subdiv)
        q((x1, y0, z0), (x0, y0, z0), (x0, y1, z0), (x1, y1, z0), mat, subdiv=subdiv)
        q((x1, y0, z1), (x1, y0, z0), (x1, y1, z0), (x1, y1, z1), mat, subdiv=subdiv)
        q((x0, y0, z0), (x0, y0, z1), (x0, y1, z1), (x0, y1, z0), mat, subdiv=subdiv)
        q((x0, y1, z1), (x1, y1, z1), (x1, y1, z0), (x0, y1, z0), mat, subdiv=subdiv)
        q((x0, y0, z0), (x1, y0, z0), (x1, y0, z1), (x0, y0, z1), mat, subdiv=subdiv)

    def cylinder(self, p0, p1, radius: float, mat, segments: int = 12) -> None:
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
            self.tri(p0, b, a, mat)
            self.tri(p1, ring1[s], ring1[(s + 1) % segments], mat)

    def build(self) -> Mesh:
        n = len(self.v0)
        return Mesh(*(np.asarray(a, np.float32).reshape(n, k)
                      for a, k in ((self.v0, 3), (self.v1, 3), (self.v2, 3),
                                   (self.u0, 2), (self.u1, 2), (self.u2, 2))),
                    materials=self.mats, tex_paths=self.texs)


def standin_mesh(detail: int, tex_path: str) -> Mesh:
    """ISS-like station at the origin, metres: truss, modules, a docked
    vehicle, eight solar wings and two radiators; the wings and radiators
    carry the image `tex_path`."""
    m = _Accum()
    hull = Mat(LAMBERTIAN, (0.73, 0.73, 0.73))
    truss = Mat(LAMBERTIAN, (0.55, 0.55, 0.58))
    panel = Mat(LAMBERTIAN, (0.25, 0.2, 0.45))
    radiator = Mat(LAMBERTIAN, (0.85, 0.85, 0.88))
    gold = Mat(METAL, (0.8, 0.65, 0.3), fuzz=0.25)
    seg = 8 + 8 * detail

    m.box((0, 0, 0), (52, 1.6, 1.6), truss, subdiv=2 * detail)
    m.cylinder((0, 0, -28), (0, 0, 24), 3.4, hull, segments=seg)
    m.cylinder((-10, 0, 6), (10, 0, 6), 2.6, hull, segments=seg)
    m.cylinder((0, -6, 2), (0, 6, 2), 2.2, gold, segments=seg)
    m.cylinder((0, 0, -34), (0, 0, -28), 1.8, gold, segments=seg)

    wing = 4 * detail
    for sx in (-1, 1):
        for wx in (34.0, 46.0):
            x = sx * wx
            for sy in (-1, 1):
                y0, y1 = 2.5 * sy, (2.5 + 34.0) * sy
                m.quad((x - 6, y0, -0.2), (x + 6, y0, -0.2),
                       (x + 6, y1, -0.2), (x - 6, y1, -0.2),
                       panel, tex=tex_path, subdiv=wing)

    for sx in (-1, 1):
        x = sx * 14.0
        m.quad((x - 1.5, -1.8, 3), (x + 1.5, -1.8, 3),
               (x + 1.5, -1.8, 25), (x - 1.5, -1.8, 25),
               radiator, tex=tex_path, subdiv=2 * detail)
    return m.build()
