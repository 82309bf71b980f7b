"""Scene tables as torch tensors, and the host scene compiler.

Port of dsrt_tpu/models/scene.py for the tables the triangle path needs.
The compiler is the reference's numpy `SceneBuilder.build()` (material
dedup, texture pool, SBVH build, 8-ary collapse re-grouping, leaf-order
packing), emitting only the main-path tables:

- `bvh_pack` f32[Bp,16]: node box (0-5), skip, leaf offset, leaf count;
- `thr_pack` f32[Bp,16]: the octant thread table, lanes [2o, 2o+1] =
  (enter, skip) for ray-direction octant o;
- `tri_pack` f32[Tp,16]: v0, e1, e2, material, face normal, and the
  per-vertex UVs as bf16 pairs in lanes 13-15 (bit patterns — never do
  float arithmetic on those lanes);
- `tri_shade` f32[T,16]: normal, uv0, uv1, uv2, material, texture;
- `mat_pack` f32[M,16]: type, albedo, emissive, fuzz, ref_idx, ...;
- the texture pool (bf16-representable f32 values) and its headers;
- spheres (`sph_center`, `sph_center2` for moving centres, `sph_radius`,
  `sph_mat`), the emissive-sphere light list `light_idx`, constant media
  (`med_*`) and the environment-map sky (`env_tex`, a texture-pool
  entry, with `env_rotation` in radians and `env_scale`).

The build-time quantizations that change pixels are kept: bf16 UVs on
flat-textured scenes and the bf16-rounded texture pool.  Quads and
smooth (vn) shading are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from dsrt_tpu.models.bvh_build import BVH, build_bvh, collapse_wide
from dsrt_tpu.models.materials import (DEFAULT_MATERIAL, DIFFUSE_LIGHT,
                                       Material)
from dsrt_tpu.models.textures import TextureRegistry

# (field name, dtype) of every table the port keeps, in the reference
# Scene's field names
TABLES = (("bvh_pack", np.float32), ("thr_pack", np.float32),
          ("tri_pack", np.float32), ("tri_shade", np.float32),
          ("mat_pack", np.float32), ("tex_pool", np.float32),
          ("tex_w", np.int32), ("tex_h", np.int32), ("tex_off", np.int32),
          ("sun_dir", np.float32), ("sun_radiance", np.float32),
          ("sph_center", np.float32), ("sph_center2", np.float32),
          ("sph_radius", np.float32), ("sph_mat", np.int32),
          ("light_idx", np.int32),
          ("med_kind", np.int32), ("med_center", np.float32),
          ("med_radius", np.float32), ("med_min", np.float32),
          ("med_max", np.float32), ("med_neg_inv_density", np.float32),
          ("med_albedo", np.float32))
INT_META = ("n_tris", "n_nodes", "max_leaf", "n_textures", "n_spheres",
            "n_quads", "n_lights", "n_media", "env_tex", "seed")
BOOL_META = ("sun_enabled", "has_image_tex", "has_ptex", "has_smooth",
             "has_moving")
FLOAT_META = ("env_rotation", "env_scale")
META = INT_META + BOOL_META + FLOAT_META
MED_SPHERE = 0
MED_BOX = 1


@dataclasses.dataclass(frozen=True)
class Scene:
    bvh_pack: torch.Tensor
    thr_pack: torch.Tensor
    tri_pack: torch.Tensor
    tri_shade: torch.Tensor
    mat_pack: torch.Tensor
    tex_pool: torch.Tensor
    tex_w: torch.Tensor
    tex_h: torch.Tensor
    tex_off: torch.Tensor
    sun_dir: torch.Tensor        # f32[3], ISS->Sun (the renderer negates)
    sun_radiance: torch.Tensor   # f32[3]
    sph_center: torch.Tensor     # f32[S,3] (one far dummy row when S = 0)
    sph_center2: torch.Tensor    # f32[S,3] centre at shutter time 1
    sph_radius: torch.Tensor     # f32[S]
    sph_mat: torch.Tensor        # i32[S]
    light_idx: torch.Tensor      # i32[n_lights] sphere rows (dummy [0])
    med_kind: torch.Tensor       # i32[M]: MED_SPHERE or MED_BOX
    med_center: torch.Tensor     # f32[M,3]
    med_radius: torch.Tensor     # f32[M]
    med_min: torch.Tensor        # f32[M,3]
    med_max: torch.Tensor        # f32[M,3]
    med_neg_inv_density: torch.Tensor  # f32[M] = -1 / density
    med_albedo: torch.Tensor     # f32[M,3]
    n_tris: int
    n_nodes: int                 # binary BVH nodes = the walk's end marker
    max_leaf: int
    n_textures: int
    n_spheres: int
    n_quads: int
    n_lights: int
    n_media: int
    sun_enabled: bool
    has_image_tex: bool
    has_ptex: bool
    has_smooth: bool
    has_moving: bool
    env_tex: int                 # texture id of the sky (-1: black)
    env_rotation: float          # radians
    env_scale: float
    seed: int

    @property
    def device(self) -> torch.device:
        return self.tri_pack.device

    @property
    def has_env(self) -> bool:
        return self.env_tex >= 0

    def to(self, device) -> "Scene":
        return dataclasses.replace(self, **{
            name: getattr(self, name).to(device) for name, _ in TABLES})

    def with_sun(self, sun_dir) -> "Scene":
        """Same tables, new sun direction (one 3-vector upload)."""
        return dataclasses.replace(self, sun_dir=torch.as_tensor(
            np.asarray(sun_dir, np.float32), device=self.device))


def scene_from_reference(ref, device="cpu") -> Scene:
    """Scene from any object with the reference Scene's fields; arrays are
    read with np.asarray, so a JAX scene converts without importing JAX
    here."""
    tables = {name: torch.as_tensor(np.array(np.asarray(getattr(ref, name)),
                                             dtype), device=device)
              for name, dtype in TABLES}
    meta = {name: int(getattr(ref, name)) for name in INT_META}
    meta.update({name: bool(getattr(ref, name)) for name in BOOL_META})
    meta.update({name: float(getattr(ref, name)) for name in FLOAT_META})
    return Scene(**tables, **meta)


def _pack_for_kernel(bvh: BVH, v0: np.ndarray, v1: np.ndarray,
                     v2: np.ndarray, tri_mat: np.ndarray, fn: np.ndarray):
    """bvh_pack, tri_pack and the octant thread table thr_pack
    (dsrt_tpu/models/scene.py:34-122, verbatim numpy)."""
    b = bvh.num_nodes
    size = np.ones(b, np.int64)
    internal = (bvh.tri_count == 0) & (bvh.left >= 0)
    for i in range(b - 1, -1, -1):
        if internal[i]:
            size[i] = 1 + size[bvh.left[i]] + size[bvh.right[i]]
    skip = np.arange(b) + size

    bp = max(((b + 7) // 8) * 8, 8)
    pack = np.zeros((bp, 16), np.float32)
    pack[:b, 0:3] = bvh.bbox_min
    pack[:b, 3:6] = bvh.bbox_max
    pack[:b, 6] = skip.astype(np.float32)
    pack[:b, 7] = bvh.tri_offset.astype(np.float32)
    pack[:b, 8] = bvh.tri_count.astype(np.float32)
    pack[b:, 6] = float(b)  # padded rows escape immediately

    # octant thread table: near child first along each octant's
    # representative direction; skip = next node of that octant's preorder
    end = b
    enter_t = np.full((8, b), end, np.int64)
    skip_t = np.full((8, b), end, np.int64)
    if b and internal.any():
        li, ri = bvh.left, bvh.right
        cl = 0.5 * (bvh.bbox_min[np.maximum(li, 0)]
                    + bvh.bbox_max[np.maximum(li, 0)])
        cr = 0.5 * (bvh.bbox_min[np.maximum(ri, 0)]
                    + bvh.bbox_max[np.maximum(ri, 0)])
        s = np.array([[1.0 - 2.0 * ((o >> a) & 1) for a in range(3)]
                      for o in range(8)], np.float32)        # (8,3)
        left_first = ((cr - cl) @ s.T) >= 0.0                # (b,8)
        octs = np.arange(8)
        for n in range(b):
            if not internal[n]:
                continue
            near = np.where(left_first[n], li[n], ri[n])
            far = np.where(left_first[n], ri[n], li[n])
            enter_t[octs, n] = near
            skip_t[octs, near] = far
            skip_t[octs, far] = skip_t[octs, n]
    thr = np.zeros((bp, 16), np.float32)
    thr[:, 0::2] = float(end)
    thr[:, 1::2] = float(end)
    if b:
        thr[:b, 0::2] = enter_t.T.astype(np.float32)
        thr[:b, 1::2] = skip_t.T.astype(np.float32)

    t = len(v0)
    tp = max(((t + 7) // 8) * 8, 8)
    tpack = np.zeros((tp, 16), np.float32)
    if t:
        tpack[:t, 0:3] = v0
        tpack[:t, 3:6] = v1 - v0
        tpack[:t, 6:9] = v2 - v0
        tpack[:t, 9] = tri_mat.astype(np.float32)
        tpack[:t, 10:13] = fn
    return pack, tpack, thr


def _bf16_round(a: np.ndarray) -> np.ndarray:
    """Round f32 to the nearest bf16 (ties to even), kept as f32."""
    bits = np.ascontiguousarray(a, np.float32).view(np.uint32)
    rounded = ((bits + np.uint32(0x7FFF) + ((bits >> np.uint32(16))
                                            & np.uint32(1)))
               & np.uint32(0xFFFF0000)).astype(np.uint32)
    return rounded.view(np.float32).reshape(a.shape)


def _pack_uv_bf16(uv: np.ndarray) -> np.ndarray:
    """(N,2) bf16-rounded uv -> (N,) f32 bit patterns [u_bf16 : v_bf16]."""
    ub = np.ascontiguousarray(uv[:, 0], np.float32).view(np.uint32)
    vb = np.ascontiguousarray(uv[:, 1], np.float32).view(np.uint32)
    return ((ub & np.uint32(0xFFFF0000)) | (vb >> 16)).view(np.float32)


@dataclasses.dataclass
class _MeshEntry:
    v0: np.ndarray
    v1: np.ndarray
    v2: np.ndarray
    uv0: np.ndarray
    uv1: np.ndarray
    uv2: np.ndarray
    materials: List[Material]
    tex_paths: List[str]
    smooth: bool = False   # carries per-vertex (vn) normals


def _queued(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to dsrt_tpu_torch yet (ROADMAP {item})")


class SceneBuilder:
    """Host scene compiler: triangles, spheres, constant media, materials
    (deduplicated by object identity), image textures, the environment
    sky, directional sun."""

    def __init__(self, sun_enabled: bool = True,
                 sun_dir: Tuple[float, float, float] = (0.0, 1.0, 0.0),
                 sun_radiance: Tuple[float, float, float] = (1e5, 9.5e4, 9e4),
                 seed: int = 1337, bvh_method: str = "median"):
        self._meshes: List[_MeshEntry] = []
        self._spheres: List[tuple] = []
        self._media: List[tuple] = []
        self._env: Optional[tuple] = None   # (path or array, rot, scale)
        self.sun_enabled = sun_enabled
        self.sun_dir = np.asarray(sun_dir, np.float64)
        self.sun_radiance = np.asarray(sun_radiance, np.float32)
        self.seed = seed
        self.bvh_method = bvh_method

    def add_triangle(self, v0, v1, v2, material: Material, uv0=(0, 0),
                     uv1=(0, 0), uv2=(0, 0), tex_path: str = "") -> None:
        self._meshes.append(_MeshEntry(
            np.asarray([v0], np.float32), np.asarray([v1], np.float32),
            np.asarray([v2], np.float32),
            np.asarray([uv0], np.float32), np.asarray([uv1], np.float32),
            np.asarray([uv2], np.float32), [material], [tex_path]))

    def add_mesh(self, mesh) -> None:
        """Add a models.obj.MeshData (OBJ load or procedural mesh)."""
        self._meshes.append(_MeshEntry(
            mesh.v0, mesh.v1, mesh.v2, mesh.uv0, mesh.uv1, mesh.uv2,
            list(mesh.materials), list(mesh.tex_paths),
            smooth=getattr(mesh, "n0", None) is not None))

    def add_sphere(self, center, radius: float, material: Material,
                   center2=None) -> None:
        """Static sphere, or moving when `center2` is given: the centre
        travels c(t) = center + t (center2 - center) over the shutter
        time t (rendered when cfg.time1 > cfg.time0)."""
        c = np.asarray(center, np.float32)
        c2 = c if center2 is None else np.asarray(center2, np.float32)
        self._spheres.append((c, float(radius), material, c2))

    def add_quad(self, *a, **kw) -> None:
        raise _queued("add_quad", "queue 1 item 1")

    def add_box(self, *a, **kw) -> None:
        raise _queued("add_box", "queue 1 item 1")

    def add_constant_medium_sphere(self, center, radius: float,
                                   density: float, albedo) -> None:
        self._media.append((MED_SPHERE, np.asarray(center, np.float32),
                            float(radius), np.zeros(3, np.float32),
                            np.zeros(3, np.float32), float(density),
                            np.asarray(albedo, np.float32)))

    def add_constant_medium_box(self, box_min, box_max, density: float,
                                albedo) -> None:
        self._media.append((MED_BOX, np.zeros(3, np.float32), 0.0,
                            np.asarray(box_min, np.float32),
                            np.asarray(box_max, np.float32), float(density),
                            np.asarray(albedo, np.float32)))

    def set_environment(self, image, rotation_deg: float = 0.0,
                        scale: float = 1.0) -> None:
        """Equirectangular sky: `image` is a file path (.hdr stays linear,
        LDR files go through sRGB -> linear) or an (H, W, 3) float linear
        array.  Rays that miss pick up scale * env(dir)."""
        self._env = (image, float(np.radians(rotation_deg)), float(scale))

    def set_sun(self, direction, radiance=None, enabled: bool = True) -> None:
        self.sun_dir = np.asarray(direction, np.float64)
        if radiance is not None:
            self.sun_radiance = np.asarray(radiance, np.float32)
        self.sun_enabled = enabled

    def build(self, device="cpu") -> Scene:
        texreg = TextureRegistry()
        mats: List[Material] = []
        mat_index = {}
        mat_tex: List[int] = []

        def upsert(m: Optional[Material], tex_id: int = -1) -> int:
            # keyed on (material identity, texture): the texture id is a
            # pure function of the material row
            if m is None:
                mats.append(DEFAULT_MATERIAL)
                mat_tex.append(tex_id)
                return len(mats) - 1
            key = (id(m), tex_id)
            if key not in mat_index:
                mats.append(m)
                mat_tex.append(tex_id)
                mat_index[key] = len(mats) - 1
            return mat_index[key]

        tv0, tv1, tv2, tuv0, tuv1, tuv2 = [], [], [], [], [], []
        tmat, ttex = [], []
        has_smooth = False
        textured_mat_ids = set()
        for mesh in self._meshes:
            has_smooth |= mesh.smooth and len(mesh.v0) > 0
            for i in range(len(mesh.v0)):
                path = mesh.tex_paths[i] if i < len(mesh.tex_paths) else ""
                tex_id = texreg.get_or_load(path)
                mid = upsert(mesh.materials[i], tex_id)
                if tex_id >= 0:
                    # textured triangles force the material albedo white
                    textured_mat_ids.add(mid)
                tv0.append(mesh.v0[i]); tv1.append(mesh.v1[i])
                tv2.append(mesh.v2[i])
                tuv0.append(mesh.uv0[i][:2]); tuv1.append(mesh.uv1[i][:2])
                tuv2.append(mesh.uv2[i][:2])
                tmat.append(mid); ttex.append(tex_id)

        n_tris = len(tv0)
        if n_tris:
            v0 = np.asarray(tv0, np.float32)
            v1 = np.asarray(tv1, np.float32)
            v2 = np.asarray(tv2, np.float32)
            fn = np.cross(v1 - v0, v2 - v0)
            ln = np.linalg.norm(fn, axis=1, keepdims=True)
            fn = np.where(ln > 0, fn / np.maximum(ln, 1e-30),
                          0.0).astype(np.float32)
            uv0 = np.asarray(tuv0, np.float32)
            uv1 = np.asarray(tuv1, np.float32)
            uv2 = np.asarray(tuv2, np.float32)
            tri_tex = np.asarray(ttex, np.int32)
            if textured_mat_ids:
                # anchor-shift textured UVs by floor(uv0): same texel after
                # the sampler's wrap, smaller quantization error
                anchor = np.floor(uv0) * (tri_tex >= 0)[:, None]
                uv0, uv1, uv2 = uv0 - anchor, uv1 - anchor, uv2 - anchor
            if textured_mat_ids and not has_smooth:
                uv0, uv1, uv2 = (_bf16_round(uv0), _bf16_round(uv1),
                                 _bf16_round(uv2))
            tri_mat = np.asarray(tmat, np.int32)
        else:
            v0 = v1 = v2 = fn = np.zeros((1, 3), np.float32)
            uv0 = uv1 = uv2 = np.zeros((1, 2), np.float32)
            tri_mat = np.zeros(1, np.int32)
            tri_tex = -np.ones(1, np.int32)

        bvh = build_bvh(v0[:n_tris], v1[:n_tris], v2[:n_tris],
                        method=self.bvh_method)
        if n_tris:
            # triangles in BVH-leaf order (SBVH: one row per reference)
            perm = bvh.tri_indices
            v0, v1, v2, fn = v0[perm], v1[perm], v2[perm], fn[perm]
            uv0, uv1, uv2 = uv0[perm], uv1[perm], uv2[perm]
            tri_mat, tri_tex = tri_mat[perm], tri_tex[perm]
            n_tris = len(perm)
        # the 8-ary collapse re-groups triangles by wide node and rewrites
        # the binary leaf offsets in place; apply its permutation too
        wide = collapse_wide(bvh, wide_max_leaf=20 if n_tris >= 16384
                             else 16)
        if n_tris:
            src = wide.src
            v0, v1, v2, fn = v0[src], v1[src], v2[src], fn[src]
            uv0, uv1, uv2 = uv0[src], uv1[src], uv2[src]
            tri_mat, tri_tex = tri_mat[src], tri_tex[src]
        bvh_pack, tri_pack, thr_pack = _pack_for_kernel(
            bvh, v0[:n_tris], v1[:n_tris], v2[:n_tris], tri_mat[:n_tris],
            fn[:n_tris])
        if n_tris:
            tri_pack[:n_tris, 13] = _pack_uv_bf16(uv0[:n_tris])
            tri_pack[:n_tris, 14] = _pack_uv_bf16(uv1[:n_tris])
            tri_pack[:n_tris, 15] = _pack_uv_bf16(uv2[:n_tris])
        m = max(n_tris, 1)
        tri_shade = np.zeros((m, 16), np.float32)
        tri_shade[:, 0:3] = fn[:m]
        tri_shade[:, 3:5] = uv0[:m]
        tri_shade[:, 5:7] = uv1[:m]
        tri_shade[:, 7:9] = uv2[:m]
        tri_shade[:, 9] = tri_mat[:m].astype(np.float32)
        tri_shade[:, 10] = tri_tex[:m].astype(np.float32)

        # spheres after the triangles, in insertion order (material rows
        # are numbered in that order too)
        n_spheres = len(self._spheres)
        if n_spheres:
            sph_center = np.asarray([e[0] for e in self._spheres],
                                    np.float32)
            sph_radius = np.asarray([e[1] for e in self._spheres],
                                    np.float32)
            sph_mat = np.asarray([upsert(e[2]) for e in self._spheres],
                                 np.int32)
            sph_center2 = np.asarray([e[3] for e in self._spheres],
                                     np.float32)
        else:
            sph_center = sph_center2 = np.full((1, 3), 1e30, np.float32)
            sph_radius = np.zeros(1, np.float32)
            sph_mat = np.zeros(1, np.int32)

        n_media = len(self._media)
        media = self._media or [(0, np.zeros(3, np.float32), 0.0,
                                 np.zeros(3, np.float32),
                                 np.zeros(3, np.float32), None,
                                 np.zeros(3, np.float32))]
        med_kind = np.asarray([e[0] for e in media], np.int32)
        med_center = np.asarray([e[1] for e in media], np.float32)
        med_radius = np.asarray([e[2] for e in media], np.float32)
        med_min = np.asarray([e[3] for e in media], np.float32)
        med_max = np.asarray([e[4] for e in media], np.float32)
        med_nid = np.asarray([0.0 if e[5] is None else -1.0 / e[5]
                              for e in media], np.float32)
        med_albedo = np.asarray([e[6] for e in media], np.float32)

        if not mats:
            mats.append(DEFAULT_MATERIAL)
            mat_tex.append(-1)
        mat_albedo = np.asarray([mt.albedo for mt in mats], np.float32)
        for mid in textured_mat_ids:
            mat_albedo[mid] = 1.0
        mat_ptk = np.asarray([mt.ptex_kind for mt in mats], np.int32)
        mat_pack = np.zeros((len(mats), 16), np.float32)
        mat_pack[:, 0] = np.asarray([mt.kind for mt in mats], np.float32)
        mat_pack[:, 1:4] = mat_albedo
        mat_pack[:, 4:7] = np.asarray([mt.emissive for mt in mats],
                                      np.float32)
        mat_pack[:, 7] = np.asarray([mt.fuzz for mt in mats], np.float32)
        mat_pack[:, 8] = np.asarray([mt.ref_idx for mt in mats], np.float32)
        mat_pack[:, 9] = mat_ptk.astype(np.float32)
        mat_pack[:, 10] = np.asarray([mt.ptex_scale for mt in mats],
                                     np.float32)
        mat_pack[:, 11:14] = np.asarray([mt.ptex_color2 for mt in mats],
                                        np.float32)
        mat_pack[:, 14] = np.asarray(mat_tex, np.float32)

        # emissive spheres are the area lights
        lights = [i for i in range(n_spheres)
                  if mats[sph_mat[i]].kind == DIFFUSE_LIGHT
                  and max(mats[sph_mat[i]].emissive) > 0]
        light_idx = np.asarray(lights or [0], np.int32)

        # the sky is registered after the triangle textures, so
        # has_image_tex counts triangle textures only
        n_tex_tri = texreg.num_textures
        env_tex, env_rot, env_scale = -1, 0.0, 1.0
        if self._env is not None:
            img, env_rot, env_scale = self._env
            env_tex = (texreg.get_or_load(img) if isinstance(img, str)
                       else texreg.add_array(np.asarray(img, np.float32)))
        pool, tex_w, tex_h, tex_off, n_tex = texreg.build_pool()
        pool = _bf16_round(pool)

        sun_dir = self.sun_dir / max(np.linalg.norm(self.sun_dir), 1e-300)

        def t(a, dtype):
            return torch.as_tensor(np.asarray(a, dtype), device=device)

        return Scene(
            bvh_pack=t(bvh_pack, np.float32), thr_pack=t(thr_pack, np.float32),
            tri_pack=t(tri_pack, np.float32),
            tri_shade=t(tri_shade, np.float32),
            mat_pack=t(mat_pack, np.float32), tex_pool=t(pool, np.float32),
            tex_w=t(tex_w, np.int32), tex_h=t(tex_h, np.int32),
            tex_off=t(tex_off, np.int32), sun_dir=t(sun_dir, np.float32),
            sun_radiance=t(self.sun_radiance, np.float32),
            sph_center=t(sph_center, np.float32),
            sph_center2=t(sph_center2, np.float32),
            sph_radius=t(sph_radius, np.float32),
            sph_mat=t(sph_mat, np.int32), light_idx=t(light_idx, np.int32),
            med_kind=t(med_kind, np.int32),
            med_center=t(med_center, np.float32),
            med_radius=t(med_radius, np.float32),
            med_min=t(med_min, np.float32), med_max=t(med_max, np.float32),
            med_neg_inv_density=t(med_nid, np.float32),
            med_albedo=t(med_albedo, np.float32),
            n_tris=n_tris, n_nodes=bvh.num_nodes,
            max_leaf=max(bvh.max_leaf_size, 1), n_textures=n_tex,
            n_spheres=n_spheres, n_quads=0, n_lights=len(lights),
            n_media=n_media, sun_enabled=bool(self.sun_enabled),
            has_image_tex=bool(n_tex_tri > 0),
            has_ptex=bool((mat_ptk != 0).any()),
            has_smooth=bool(has_smooth),
            has_moving=bool((sph_center2 != sph_center).any()),
            env_tex=int(env_tex), env_rotation=float(env_rot),
            env_scale=float(env_scale), seed=int(self.seed))
