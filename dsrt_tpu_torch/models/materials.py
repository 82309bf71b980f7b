"""Host-side material model and the MTL->material inference heuristic.

A copy of dsrt_tpu/models/materials.py: the port imports nothing of the JAX package.

Mirrors the reference's behavior:
- 4-way material taxonomy LAMBERTIAN/METAL/DIELECTRIC/DIFFUSE_LIGHT
  (inc/gpu_scene.h:21-26) flattened to a SoA table by identity-dedup
  (src/gpu_scene_builder.cpp:71-139).
- MTL property -> material heuristic of inc/triangle_mesh.h:75-112:
  emissive (Ke != 0 or map_Ke) -> diffuse_light; map_Kd -> textured
  lambertian; d < 0.999 -> dielectric with Ni clamped to (0.1, 10) else 1.5;
  |Ks| > 0.05 -> metal with fuzz = clamp(100/(Ns+100)); else lambertian(Kd).

Extension beyond the reference GPU path: procedural textures (checker /
noise / marble) from the reference's CPU-only texture classes
(inc/texture.h:38-86), evaluated on-device (see ops/textures.py).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

LAMBERTIAN = 0
METAL = 1
DIELECTRIC = 2
DIFFUSE_LIGHT = 3

# Procedural texture kinds (extension; 0 = none).
PTEX_NONE = 0
PTEX_CHECKER = 1
PTEX_NOISE = 2
PTEX_MARBLE = 3


@dataclasses.dataclass
class Material:
    """One material; identity (object id) is the dedup key, like the raw
    `material*` pointer key in src/gpu_scene_builder.cpp:88."""

    kind: int = LAMBERTIAN
    albedo: Tuple[float, float, float] = (0.8, 0.8, 0.8)
    emissive: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    fuzz: float = 0.0
    ref_idx: float = 1.5
    tex_path: Optional[str] = None          # map_Kd image texture
    ptex_kind: int = PTEX_NONE              # procedural texture (extension)
    ptex_scale: float = 1.0
    ptex_color2: Tuple[float, float, float] = (0.9, 0.9, 0.9)
    name: str = ""

    @staticmethod
    def lambertian(albedo=(0.8, 0.8, 0.8), tex_path=None, **kw) -> "Material":
        return Material(kind=LAMBERTIAN, albedo=tuple(albedo),
                        tex_path=tex_path, **kw)

    @staticmethod
    def metal(albedo, fuzz=0.0, **kw) -> "Material":
        return Material(kind=METAL, albedo=tuple(albedo), fuzz=float(fuzz), **kw)

    @staticmethod
    def dielectric(ref_idx=1.5, **kw) -> "Material":
        # GPU table stores albedo white for dielectrics
        # (src/gpu_scene_builder.cpp:112-118).
        return Material(kind=DIELECTRIC, albedo=(1.0, 1.0, 1.0),
                        ref_idx=float(ref_idx), **kw)

    @staticmethod
    def diffuse_light(emissive, **kw) -> "Material":
        return Material(kind=DIFFUSE_LIGHT, albedo=(1.0, 1.0, 1.0),
                        emissive=tuple(emissive), ref_idx=1.0, **kw)

    @staticmethod
    def checker(c1=(0.2, 0.3, 0.1), c2=(0.9, 0.9, 0.9), scale=1.0) -> "Material":
        return Material(kind=LAMBERTIAN, albedo=tuple(c1), ptex_kind=PTEX_CHECKER,
                        ptex_scale=scale, ptex_color2=tuple(c2))

    @staticmethod
    def noise(scale=1.0) -> "Material":
        return Material(kind=LAMBERTIAN, albedo=(1.0, 1.0, 1.0),
                        ptex_kind=PTEX_NOISE, ptex_scale=scale)

    @staticmethod
    def marble(scale=1.0) -> "Material":
        return Material(kind=LAMBERTIAN, albedo=(1.0, 1.0, 1.0),
                        ptex_kind=PTEX_MARBLE, ptex_scale=scale)


DEFAULT_MATERIAL = Material.lambertian((0.8, 0.8, 0.8))


@dataclasses.dataclass
class MtlProps:
    """Parsed `newmtl` block, defaults per inc/triangle_mesh.h:58-72."""

    name: str = ""
    Kd: Tuple[float, float, float] = (0.8, 0.8, 0.8)
    Ks: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    Ke: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    Ns: float = 0.0
    d: float = 1.0
    Ni: float = 1.5
    map_Kd: str = ""
    map_Ke: str = ""


def material_from_mtl(m: MtlProps, base_dir: str) -> Material:
    """The exact inference heuristic of inc/triangle_mesh.h:75-112."""
    import os

    has_emissive = any(c != 0.0 for c in m.Ke)
    if has_emissive or m.map_Ke:
        # map_Ke textures collapse to plain emissive on the GPU path
        # (upsert_material reads only emit_value); keep Ke as radiance.
        return Material.diffuse_light(m.Ke, name=m.name)

    if m.map_Kd:
        return Material.lambertian((0.8, 0.8, 0.8),
                                   tex_path=os.path.join(base_dir, m.map_Kd),
                                   name=m.name)

    if m.d < 0.999:
        ior = m.Ni if (0.1 < m.Ni < 10.0) else 1.5
        return Material.dielectric(ior, name=m.name)

    ks_mag = (m.Ks[0] ** 2 + m.Ks[1] ** 2 + m.Ks[2] ** 2) ** 0.5
    if ks_mag > 0.05:
        fuzz = min(max(100.0 / (m.Ns + 100.0), 0.0), 1.0)
        return Material.metal(m.Ks, fuzz, name=m.name)

    return Material.lambertian(m.Kd, name=m.name)
