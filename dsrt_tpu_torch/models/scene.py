"""Scene tables as torch tensors, and the host scene compiler.

Port of dsrt_tpu/models/scene.py for the tables the triangle path needs.
The compiler is the reference's numpy `SceneBuilder.build()` (material
dedup, texture pool, SBVH build, 8-ary collapse re-grouping, leaf-order
packing), emitting only the main-path tables:

- `bvh_pack` f32[Bp,16]: node box (0-5), skip, leaf offset, leaf count;
- `thr_pack` f32[Bp,16]: the octant thread table, lanes [2o, 2o+1] =
  (enter, skip) for ray-direction octant o;
- `wide_pack` f32[Nw,72] (the port's own, `pack_wide`): the same tree as
  an 8-ary table whose leaf children are the binary leaves, with each
  octant's binary visit order, for the path kernel's wide walk;
- `tri_pack` f32[Tp,16]: v0, e1, e2, material, face normal, and the
  per-vertex UVs as bf16 pairs in lanes 13-15 (bit patterns — never do
  float arithmetic on those lanes);
- `tri_shade` f32[T,16]: normal, uv0, uv1, uv2, material, texture;
- `mat_pack` f32[M,16]: type, albedo, emissive, fuzz, ref_idx, ...;
- the texture pool (bf16-representable f32 values) and its headers;
- `tri_aux` f32[Tp,16] (row-aligned with tri_pack): per-vertex shading
  normals vn0, vn1, vn2 (the flat normal where a corner has none),
  uv0, uv1, uv2, texture;
- spheres (`sph_center`, `sph_center2` for moving centres, `sph_radius`,
  `sph_mat`), quads (`quad_q`, `quad_u`, `quad_v` and the derived
  `quad_n`, `quad_w`, `quad_d`, `quad_area`, computed in float64 and
  stored as f32; `quad_mat`), the area-light list (`light_kind` 0 = sphere,
  1 = quad, `light_idx` its row; spheres first, then quads), constant
  media (`med_*`) and the environment-map sky (`env_tex`, a texture-pool
  entry, with `env_rotation` in radians and `env_scale`).

Material rows are numbered in insertion order: triangles, spheres, then
quads.  The build-time quantizations that change pixels are kept: bf16
UVs on flat-textured scenes (smooth scenes keep f32 UVs) and the
bf16-rounded texture pool.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from dsrt_tpu_torch.device import resolve_device, to_device
from dsrt_tpu_torch.models.bvh_build import BVH, build_bvh, collapse_wide
from dsrt_tpu_torch.models.materials import (DEFAULT_MATERIAL, DIFFUSE_LIGHT,
                                             Material)
from dsrt_tpu_torch.models.textures import TextureRegistry

# (field name, dtype) of every table the port shares with the reference
# Scene, in its field names
REF_TABLES = (("bvh_pack", np.float32), ("thr_pack", np.float32),
          ("tri_pack", np.float32), ("tri_shade", np.float32),
          ("tri_aux", np.float32), ("mat_pack", np.float32), ("tex_pool", np.float32),
          ("tex_w", np.int32), ("tex_h", np.int32), ("tex_off", np.int32),
          ("sun_dir", np.float32), ("sun_radiance", np.float32),
          ("sph_center", np.float32), ("sph_center2", np.float32),
          ("sph_radius", np.float32), ("sph_mat", np.int32),
          ("quad_q", np.float32), ("quad_u", np.float32),
          ("quad_v", np.float32), ("quad_n", np.float32),
          ("quad_w", np.float32), ("quad_d", np.float32),
          ("quad_area", np.float32), ("quad_mat", np.int32),
          ("light_idx", np.int32), ("light_kind", np.int32),
          ("med_kind", np.int32), ("med_center", np.float32),
          ("med_radius", np.float32), ("med_min", np.float32),
          ("med_max", np.float32), ("med_neg_inv_density", np.float32),
          ("med_albedo", np.float32))
# ... and every table the port keeps: the reference's, then the 8-ary
# table the path kernel walks (`pack_wide`, derived from bvh_pack and
# thr_pack)
TABLES = REF_TABLES + (("wide_pack", np.float32),)
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
    tri_aux: torch.Tensor        # f32[Tp,16]: vn0 vn1 vn2 uv0 uv1 uv2 tex
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
    quad_q: torch.Tensor         # f32[Q,3] corner (one dummy row when Q = 0)
    quad_u: torch.Tensor         # f32[Q,3] edge
    quad_v: torch.Tensor         # f32[Q,3] edge
    quad_n: torch.Tensor         # f32[Q,3] unit normal of u x v
    quad_w: torch.Tensor         # f32[Q,3] (u x v) / |u x v|^2
    quad_d: torch.Tensor         # f32[Q] n . q
    quad_area: torch.Tensor      # f32[Q] |u x v|
    quad_mat: torch.Tensor       # i32[Q]
    light_idx: torch.Tensor      # i32[n_lights] sphere or quad rows (dummy [0])
    light_kind: torch.Tensor     # i32[n_lights] 0 sphere, 1 quad (dummy [0])
    med_kind: torch.Tensor       # i32[M]: MED_SPHERE or MED_BOX
    med_center: torch.Tensor     # f32[M,3]
    med_radius: torch.Tensor     # f32[M]
    med_min: torch.Tensor        # f32[M,3]
    med_max: torch.Tensor        # f32[M,3]
    med_neg_inv_density: torch.Tensor  # f32[M] = -1 / density
    med_albedo: torch.Tensor     # f32[M,3]
    wide_pack: torch.Tensor      # f32[Nw, WIDE_ROW]: see pack_wide
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
    wide_stack: int              # the wide walk's worst stack height
    # sun_dir's and sun_radiance's float32 values on the host, set with
    # them, so the kernel wrappers read the sun without waiting for the
    # device
    sun_dir_host: np.ndarray = dataclasses.field(compare=False, repr=False)
    sun_radiance_host: np.ndarray = dataclasses.field(compare=False,
                                                      repr=False)
    # what the kernel wrappers derive from the tables once per scene
    # (`cached`); shared by the copies `with_sun` makes
    cache: dict = dataclasses.field(default_factory=dict, compare=False,
                                    repr=False)

    @property
    def device(self) -> torch.device:
        return self.tri_pack.device

    @property
    def has_env(self) -> bool:
        return self.env_tex >= 0

    def to(self, device) -> "Scene":
        return dataclasses.replace(self, cache={}, **{
            name: getattr(self, name).to(device) for name, _ in TABLES})

    def with_sun(self, sun_dir) -> "Scene":
        """Same tables, new sun direction: one 3-vector upload (on the
        card one that does not wait for the stream, `to_device`), its
        host copy kept beside it."""
        host = np.array(sun_dir, np.float32)
        return dataclasses.replace(self, sun_dir=to_device(host, self.device),
                                   sun_dir_host=host)

    def cached(self, key: str, sources: tuple, make):
        """`make()`, kept in `cache` under `key` while the tensors in
        `sources` are this scene's."""
        hit = self.cache.get(key)
        if hit is not None and len(hit[0]) == len(sources) and all(
                a is b for a, b in zip(hit[0], sources)):
            return hit[1]
        value = make()
        self.cache[key] = (sources, value)
        return value


def scene_from_reference(ref, device=None) -> Scene:
    """Scene from any object with the reference Scene's fields; arrays are
    read with np.asarray, so a JAX scene converts without importing JAX
    here.  On the card unless `device` says otherwise."""
    device = resolve_device(device)
    host = {name: np.array(np.asarray(getattr(ref, name)), dtype)
            for name, dtype in REF_TABLES}
    wide, _, stack = pack_wide(host["bvh_pack"], host["thr_pack"],
                               int(ref.n_nodes))
    tables = {name: torch.as_tensor(a, device=device)
              for name, a in dict(host, wide_pack=wide).items()}
    meta = {name: int(getattr(ref, name)) for name in INT_META}
    meta.update({name: bool(getattr(ref, name)) for name in BOOL_META})
    meta.update({name: float(getattr(ref, name)) for name in FLOAT_META})
    return Scene(**tables, **meta, wide_stack=stack,
                 sun_dir_host=host["sun_dir"],
                 sun_radiance_host=host["sun_radiance"])


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


# The 8-ary table the path kernel walks (csrc/wide_walk.cuh), one row of
# WIDE_ROW floats a wide node:
#   floats [8k, 8k+8), child slot k < 8: box min (3), box max (3), then two
#     int32 bit patterns: a leaf child's first tri_pack row and its count
#     (> 0), or an interior child's wide node index and 0; an empty slot
#     has the zero-width box at _EMPTY_BOX (never entered) and index -1;
#   float 64 + o, ray octant o: the binary walk's visit rank of each slot,
#     3 bits a slot (bits 3k..3k+2 for slot k), an int32 bit pattern.
WIDE_ARITY = 8
WIDE_ROW = 9 * WIDE_ARITY
_EMPTY_BOX = np.float32(1e30)


def pack_wide(bvh_pack: np.ndarray, thr_pack: np.ndarray, n_nodes: int):
    """The 8-ary table over the binary tree in bvh_pack / thr_pack, its
    wide depth and the walk's worst stack height: (table f32[Nw, WIDE_ROW],
    depth, stack).

    Each wide node's children are the frontier of a binary subtree: its
    top node T, expanded (replaced by its two children) while fewer than
    8 slots are used, the child of largest surface area first.  Leaf
    children are exactly the binary leaves, and a wide interior child
    is a binary interior node whose own box the walk tests before it
    expands it.  A binary node the walk does not test (one expanded
    inside a wide node) is expanded only when both children's boxes lie
    inside its own, bit for bit: the slab test rounds monotonically, so a
    child entered then implies the parent entered, and the wide walk
    tests exactly the leaves the binary walk tests, in the same order.
    T itself is tested as its parent's child record, except the root,
    which is expanded only under the same containment rule (else the
    root wide node holds the root alone).  The order words come from the
    thread table: for octant o, walking thr_pack inside T's subtree and
    emitting each frontier node reproduces the binary walk's order."""
    b = int(n_nodes)
    box_min = bvh_pack[:b, 0:3]
    box_max = bvh_pack[:b, 3:6]
    skip = bvh_pack[:b, 6].astype(np.int64)
    cnt = bvh_pack[:b, 8].astype(np.int64)
    enter_t = thr_pack[:b, 0::2].astype(np.int64)   # (b, octant)
    skip_t = thr_pack[:b, 1::2].astype(np.int64)
    interior = (cnt == 0) & (skip > np.arange(b) + 1)
    ext = np.maximum(box_max.astype(np.float64) - box_min, 0.0)
    area = ext[:, 0] * ext[:, 1] + ext[:, 1] * ext[:, 2] + ext[:, 2] * ext[:, 0]

    def kids(n):
        return [n + 1, int(skip[n + 1])]

    def expandable(n):
        return interior[n] and all(
            (box_min[c] >= box_min[n]).all() and (box_max[c] <= box_max[n]).all()
            for c in kids(n))

    rows = []
    depth = stack = 0
    # (wide index, top node T, T tested as a child record, depth, stack
    # height when the walk expands this node)
    work = [(0, 0, False, 1, 0)]
    while work:
        j, top, tested, d, h = work.pop()
        frontier = kids(top) if tested else [top]
        while len(frontier) < WIDE_ARITY:
            cand = [f for f in frontier if expandable(f)]
            if not cand:
                break
            f = max(cand, key=lambda n: (area[n], -n))
            i = frontier.index(f)
            frontier[i:i + 1] = kids(f)
        frontier = [f for f in frontier if interior[f] or cnt[f] > 0]
        slot_of = {f: k for k, f in enumerate(frontier)}
        row = np.zeros(WIDE_ROW, np.float32)
        ints = row.view(np.int32)
        kids_rows = row[:8 * WIDE_ARITY].reshape(WIDE_ARITY, 8)
        kid_ints = ints[:8 * WIDE_ARITY].reshape(WIDE_ARITY, 8)
        kids_rows[:, 0:6] = _EMPTY_BOX
        kid_ints[:, 6] = -1
        for k, f in enumerate(frontier):
            kids_rows[k, 0:3] = box_min[f]
            kids_rows[k, 3:6] = box_max[f]
            if interior[f]:
                # interior children take the next free wide indices
                kid_ints[k, 6] = len(rows) + len(work) + 1
                work.append((int(kid_ints[k, 6]), f, True, d + 1,
                             h + len(frontier) - 1))
            else:
                kid_ints[k, 6] = int(bvh_pack[f, 7])
                kid_ints[k, 7] = int(cnt[f])
        for o in range(WIDE_ARITY):
            # the binary walk inside T's subtree: enter what was expanded,
            # emit (and skip) what is a child record
            order, n = [], top
            while n != skip_t[top, o]:
                if n in slot_of:
                    order.append(slot_of[n])
                    n = skip_t[n, o]
                else:
                    n = enter_t[n, o]
            order += [k for k in range(WIDE_ARITY) if k not in order]
            ints[8 * WIDE_ARITY + o] = sum(r << (3 * k)
                                           for r, k in enumerate(order))
        depth = max(depth, d)
        stack = max(stack, h + len(frontier))
        rows.append((j, row))
    table = np.zeros((len(rows), WIDE_ROW), np.float32)
    for j, row in rows:
        table[j] = row
    return table, depth, stack


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
    # per-vertex shading normals (smooth shading); None = flat
    n0: Optional[np.ndarray] = None
    n1: Optional[np.ndarray] = None
    n2: Optional[np.ndarray] = None


class SceneBuilder:
    """Host scene compiler: triangles (flat or smooth), spheres, quads and
    boxes, constant media, materials (deduplicated by object identity),
    image textures, the environment sky, directional sun."""

    def __init__(self, sun_enabled: bool = True,
                 sun_dir: Tuple[float, float, float] = (0.0, 1.0, 0.0),
                 sun_radiance: Tuple[float, float, float] = (1e5, 9.5e4, 9e4),
                 seed: int = 1337, bvh_method: str = "median",
                 sbvh_alpha: float = 1e-5):
        """`sbvh_alpha` is the SBVH's spatial-split gate (the overlap's
        share of the root's surface area above which a split is tried; 0
        always tries)."""
        self._meshes: List[_MeshEntry] = []
        self._spheres: List[tuple] = []
        self._quads: List[tuple] = []
        self._media: List[tuple] = []
        self._env: Optional[tuple] = None   # (path or array, rot, scale)
        self.sun_enabled = sun_enabled
        self.sun_dir = np.asarray(sun_dir, np.float64)
        self.sun_radiance = np.asarray(sun_radiance, np.float32)
        self.seed = seed
        self.bvh_method = bvh_method
        self.sbvh_alpha = sbvh_alpha

    def add_triangle(self, v0, v1, v2, material: Material, uv0=(0, 0),
                     uv1=(0, 0), uv2=(0, 0), tex_path: str = "") -> None:
        self._meshes.append(_MeshEntry(
            np.asarray([v0], np.float32), np.asarray([v1], np.float32),
            np.asarray([v2], np.float32),
            np.asarray([uv0], np.float32), np.asarray([uv1], np.float32),
            np.asarray([uv2], np.float32), [material], [tex_path]))

    def add_mesh(self, mesh, translate=None, rotate_y_deg: float = 0.0,
                 flip_face: bool = False) -> None:
        """Add a models.obj.MeshData (OBJ load or procedural mesh), with
        build-time instancing applied rotate-then-translate: rotation
        about +Y (x' = cos t x + sin t z, z' = -sin t x + cos t z, in
        float64), a vertex offset, and flip_face, which reverses the
        winding (and negates and swaps the vn normals)."""
        v0, v1, v2 = mesh.v0, mesh.v1, mesh.v2
        n0 = getattr(mesh, "n0", None)
        n1 = getattr(mesh, "n1", None)
        n2 = getattr(mesh, "n2", None)
        if rotate_y_deg:
            t = np.deg2rad(float(rotate_y_deg))
            c, s = np.cos(t), np.sin(t)
            rot = np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]],
                           np.float64)

            def turn(a):
                return (a.astype(np.float64) @ rot.T).astype(np.float32)

            v0, v1, v2 = turn(v0), turn(v1), turn(v2)
            if n0 is not None:
                n0, n1, n2 = turn(n0), turn(n1), turn(n2)
        if translate is not None:
            off = np.asarray(translate, np.float32)
            v0, v1, v2 = v0 + off, v1 + off, v2 + off
        uv0, uv1, uv2 = mesh.uv0, mesh.uv1, mesh.uv2
        if flip_face:
            v1, v2 = v2, v1
            uv1, uv2 = uv2, uv1
            if n0 is not None:
                n0, n1, n2 = -n0, -n2, -n1
        self._meshes.append(_MeshEntry(
            v0, v1, v2, uv0, uv1, uv2, list(mesh.materials),
            list(mesh.tex_paths), n0=n0, n1=n1, n2=n2))

    def add_sphere(self, center, radius: float, material: Material,
                   center2=None) -> None:
        """Static sphere, or moving when `center2` is given: the centre
        travels c(t) = center + t (center2 - center) over the shutter
        time t (rendered when cfg.time1 > cfg.time0)."""
        c = np.asarray(center, np.float32)
        c2 = c if center2 is None else np.asarray(center2, np.float32)
        self._spheres.append((c, float(radius), material, c2))

    def add_quad(self, q, u, v, material: Material,
                 flip_face: bool = False) -> None:
        """Planar quad: corner q and edge vectors u, v.  flip_face swaps
        the edges, which negates the normal."""
        if flip_face:
            u, v = v, u
        self._quads.append((np.asarray(q, np.float32),
                            np.asarray(u, np.float32),
                            np.asarray(v, np.float32), material))

    def add_box(self, a, b, material: Material) -> None:
        """Axis-aligned box as six quads (front, right, back, left, top,
        bottom)."""
        a = np.asarray(a, np.float64)
        b = np.asarray(b, np.float64)
        mn = np.minimum(a, b)
        mx = np.maximum(a, b)
        dx = np.array([mx[0] - mn[0], 0, 0])
        dy = np.array([0, mx[1] - mn[1], 0])
        dz = np.array([0, 0, mx[2] - mn[2]])
        self.add_quad((mn[0], mn[1], mx[2]), dx, dy, material)
        self.add_quad((mx[0], mn[1], mx[2]), -dz, dy, material)
        self.add_quad((mx[0], mn[1], mn[2]), -dx, dy, material)
        self.add_quad((mn[0], mn[1], mn[2]), dz, dy, material)
        self.add_quad((mn[0], mx[1], mx[2]), dx, -dz, material)
        self.add_quad((mn[0], mn[1], mn[2]), dx, dz, material)

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

    def build(self, device=None) -> Scene:
        """Compile the scene onto `device`, the card when None."""
        device = resolve_device(device)
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
        tn0, tn1, tn2 = [], [], []
        tmat, ttex = [], []
        has_smooth = False
        zero3 = np.zeros(3, np.float32)
        textured_mat_ids = set()
        for mesh in self._meshes:
            smooth = mesh.n0 is not None
            has_smooth |= smooth and len(mesh.v0) > 0
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
                if smooth:
                    tn0.append(mesh.n0[i]); tn1.append(mesh.n1[i])
                    tn2.append(mesh.n2[i])
                else:
                    tn0.append(zero3); tn1.append(zero3); tn2.append(zero3)
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
            if has_smooth:
                # per-vertex vn where given, the flat normal where a corner
                # has none (a zero vector marks it absent)
                vn0, vn1, vn2 = (
                    np.where(np.linalg.norm(np.asarray(tn, np.float32), axis=1,
                                            keepdims=True) < 1e-6,
                             fn, np.asarray(tn, np.float32)).astype(np.float32)
                    for tn in (tn0, tn1, tn2))
            else:
                vn0 = vn1 = vn2 = fn
        else:
            v0 = v1 = v2 = fn = np.zeros((1, 3), np.float32)
            vn0 = vn1 = vn2 = fn
            uv0 = uv1 = uv2 = np.zeros((1, 2), np.float32)
            tri_mat = np.zeros(1, np.int32)
            tri_tex = -np.ones(1, np.int32)

        bvh = build_bvh(v0[:n_tris], v1[:n_tris], v2[:n_tris],
                        method=self.bvh_method, sbvh_alpha=self.sbvh_alpha)
        if n_tris:
            # triangles in BVH-leaf order (SBVH: one row per reference)
            perm = bvh.tri_indices
            v0, v1, v2, fn = v0[perm], v1[perm], v2[perm], fn[perm]
            vn0, vn1, vn2 = vn0[perm], vn1[perm], vn2[perm]
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
            vn0, vn1, vn2 = vn0[src], vn1[src], vn2[src]
            uv0, uv1, uv2 = uv0[src], uv1[src], uv2[src]
            tri_mat, tri_tex = tri_mat[src], tri_tex[src]
        bvh_pack, tri_pack, thr_pack = _pack_for_kernel(
            bvh, v0[:n_tris], v1[:n_tris], v2[:n_tris], tri_mat[:n_tris],
            fn[:n_tris])
        wide_pack, _, wide_stack = pack_wide(bvh_pack, thr_pack,
                                             bvh.num_nodes)
        if n_tris:
            tri_pack[:n_tris, 13] = _pack_uv_bf16(uv0[:n_tris])
            tri_pack[:n_tris, 14] = _pack_uv_bf16(uv1[:n_tris])
            tri_pack[:n_tris, 15] = _pack_uv_bf16(uv2[:n_tris])
        # smooth-shading table, row-aligned with tri_pack's 8-padding
        tri_aux = np.zeros((tri_pack.shape[0], 16), np.float32)
        tri_aux[:, 15] = -1.0
        if n_tris:
            tri_aux[:n_tris, 0:3] = vn0[:n_tris]
            tri_aux[:n_tris, 3:6] = vn1[:n_tris]
            tri_aux[:n_tris, 6:9] = vn2[:n_tris]
            tri_aux[:n_tris, 9:11] = uv0[:n_tris]
            tri_aux[:n_tris, 11:13] = uv1[:n_tris]
            tri_aux[:n_tris, 13:15] = uv2[:n_tris]
            tri_aux[:n_tris, 15] = tri_tex[:n_tris].astype(np.float32)
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

        # quads after the spheres; the derived quantities in float64,
        # stored as f32
        n_quads = len(self._quads)
        if n_quads:
            qq = np.asarray([e[0] for e in self._quads], np.float64)
            qu = np.asarray([e[1] for e in self._quads], np.float64)
            qv = np.asarray([e[2] for e in self._quads], np.float64)
            qm = np.asarray([upsert(e[3]) for e in self._quads], np.int32)
            cr = np.cross(qu, qv)
            n2 = np.maximum((cr * cr).sum(axis=1, keepdims=True), 1e-30)
            qn = cr / np.sqrt(n2)
            qw = cr / n2
            qd = (qn * qq).sum(axis=1)
            qarea = np.sqrt(n2[:, 0])
        else:
            qq = qu = qv = qw = np.zeros((1, 3))
            qn = np.array([[0.0, 0.0, 1.0]])
            qd = qarea = np.zeros(1)
            qm = np.zeros(1, np.int32)

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

        # emissive spheres, then emissive quads, are the area lights
        def emits(mid):
            return (mats[mid].kind == DIFFUSE_LIGHT
                    and np.float32(max(mats[mid].emissive)) > 0)

        lights = [(0, i) for i in range(n_spheres) if emits(sph_mat[i])]
        lights += [(1, j) for j in range(n_quads) if emits(qm[j])]
        light_idx = np.asarray([e[1] for e in lights] or [0], np.int32)
        light_kind = np.asarray([e[0] for e in lights] or [0], np.int32)

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

        sun_dir = np.asarray(self.sun_dir / max(np.linalg.norm(
            self.sun_dir), 1e-300), np.float32)

        def t(a, dtype):
            return torch.as_tensor(np.asarray(a, dtype), device=device)

        return Scene(
            bvh_pack=t(bvh_pack, np.float32), thr_pack=t(thr_pack, np.float32),
            tri_pack=t(tri_pack, np.float32),
            tri_shade=t(tri_shade, np.float32),
            tri_aux=t(tri_aux, np.float32),
            mat_pack=t(mat_pack, np.float32), tex_pool=t(pool, np.float32),
            tex_w=t(tex_w, np.int32), tex_h=t(tex_h, np.int32),
            tex_off=t(tex_off, np.int32), sun_dir=t(sun_dir, np.float32),
            sun_radiance=t(self.sun_radiance, np.float32),
            sph_center=t(sph_center, np.float32),
            sph_center2=t(sph_center2, np.float32),
            sph_radius=t(sph_radius, np.float32),
            sph_mat=t(sph_mat, np.int32),
            quad_q=t(qq, np.float32), quad_u=t(qu, np.float32),
            quad_v=t(qv, np.float32), quad_n=t(qn, np.float32),
            quad_w=t(qw, np.float32), quad_d=t(qd, np.float32),
            quad_area=t(qarea, np.float32), quad_mat=t(qm, np.int32),
            light_idx=t(light_idx, np.int32),
            light_kind=t(light_kind, np.int32),
            med_kind=t(med_kind, np.int32),
            med_center=t(med_center, np.float32),
            med_radius=t(med_radius, np.float32),
            med_min=t(med_min, np.float32), med_max=t(med_max, np.float32),
            med_neg_inv_density=t(med_nid, np.float32),
            med_albedo=t(med_albedo, np.float32),
            wide_pack=t(wide_pack, np.float32),
            n_tris=n_tris, n_nodes=bvh.num_nodes,
            max_leaf=max(bvh.max_leaf_size, 1), n_textures=n_tex,
            n_spheres=n_spheres, n_quads=n_quads, n_lights=len(lights),
            n_media=n_media, sun_enabled=bool(self.sun_enabled),
            has_image_tex=bool(n_tex_tri > 0),
            has_ptex=bool((mat_ptk != 0).any()),
            has_smooth=bool(has_smooth),
            has_moving=bool((sph_center2 != sph_center).any()),
            env_tex=int(env_tex), env_rotation=float(env_rot),
            env_scale=float(env_scale), seed=int(self.seed),
            wide_stack=int(wide_stack), sun_dir_host=sun_dir,
            sun_radiance_host=np.array(self.sun_radiance, np.float32))
