"""OBJ/MTL mesh loader.

A copy of dsrt_tpu/models/obj.py: the port imports nothing of the JAX package.

Reproduces the reference loader's exact parse semantics
(inc/triangle_mesh.h:114-255):

- `v` scaled by `scale` at parse time;
- `vt` stored V-FLIPPED: (u, 1-v) (triangle_mesh.h:207) — the sampler flips
  again (ops/textures.py), net un-flipping; both reproduced verbatim;
- `vn` indices parsed but IGNORED (triangle_mesh.h:227-234) — normals are
  flat per face (computed by the scene builder);
- faces fan-triangulated: (tok0, tok_k, tok_{k+1}) (triangle_mesh.h:232);
- face index forms v, v/vt, v//vn, v/vt/vn; 1-based; index 0/invalid token
  skips the face corner's triangle;
- per-triangle map_Kd path recorded for the texture registry
  (triangle_mesh.h:244-251);
- materials inferred from MTL props (models/materials.py) and cached per
  MTL name (triangle_mesh.h:216-225);
- missing usemtl or lookup miss -> fallback material.

Note: the reference does not support negative (relative) OBJ indices; we
additionally accept them (standard OBJ) since they cannot occur in files
the reference parses successfully.
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Dict, List, Optional

import numpy as np

from dsrt_tpu_torch.models.materials import (Material, MtlProps, material_from_mtl,
                                       DEFAULT_MATERIAL)


@dataclasses.dataclass
class MeshData:
    v0: np.ndarray
    v1: np.ndarray
    v2: np.ndarray
    uv0: np.ndarray
    uv1: np.ndarray
    uv2: np.ndarray
    materials: List[Material]
    tex_paths: List[str]
    # per-vertex shading normals (smooth shading opt-in); None = flat
    # (the reference ignores `vn`, triangle_mesh.h:227-234 — flat is parity)
    n0: Optional[np.ndarray] = None
    n1: Optional[np.ndarray] = None
    n2: Optional[np.ndarray] = None

    @property
    def num_triangles(self) -> int:
        return len(self.v0)


def load_mtl(path: str) -> Dict[str, MtlProps]:
    """MTL parser for Kd/Ks/Ke/Ns/d/Ni/map_Kd/map_Ke
    (inc/triangle_mesh.h:114-169)."""
    out: Dict[str, MtlProps] = {}
    try:
        fh = open(path, "r", errors="replace")
    except OSError:
        return out
    cur: Optional[MtlProps] = None
    with fh:
        for line in fh:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            tag = parts[0]
            try:
                if tag == "newmtl" and len(parts) > 1:
                    cur = MtlProps(name=parts[1])
                    out[parts[1]] = cur
                elif cur is None:
                    continue
                elif tag in ("Kd", "Ks", "Ke") and len(parts) >= 4:
                    setattr(cur, tag, (float(parts[1]), float(parts[2]),
                                       float(parts[3])))
                elif tag == "Ns" and len(parts) > 1:
                    cur.Ns = float(parts[1])
                elif tag == "d" and len(parts) > 1:
                    cur.d = float(parts[1])
                elif tag == "Ni" and len(parts) > 1:
                    cur.Ni = float(parts[1])
                elif tag == "map_Kd" and len(parts) > 1:
                    cur.map_Kd = parts[1]
                elif tag == "map_Ke" and len(parts) > 1:
                    cur.map_Ke = parts[1]
            except ValueError:
                continue
    return out


_FACE_RE = re.compile(r"^(-?\d+)(?:/(-?\d*)(?:/(-?\d+))?)?$")


def _parse_face_token(tok: str):
    """-> (v, vt, vn), 0 meaning absent (parse_face_idx,
    triangle_mesh.h:181-188)."""
    m = _FACE_RE.match(tok)
    if not m:
        return 0, 0, 0
    v = int(m.group(1))
    vt = int(m.group(2)) if m.group(2) else 0
    vn = int(m.group(3)) if m.group(3) else 0
    return v, vt, vn


def load_obj(path: str, fallback: Optional[Material] = None,
             scale: float = 1.0, smooth: bool = False) -> MeshData:
    """smooth=True honors `vn` per-corner normal indices (standard OBJ
    smooth shading) — an opt-in EXTENSION; the reference parses and
    discards them (triangle_mesh.h:227-234), so the default stays flat."""
    fallback = fallback or DEFAULT_MATERIAL
    base_dir = os.path.dirname(path)

    verts: List[np.ndarray] = []
    uvs: List[np.ndarray] = []
    norms: List[np.ndarray] = []
    mtl: Dict[str, MtlProps] = {}
    mat_cache: Dict[str, Material] = {}
    cur_mtl = ""

    tv0, tv1, tv2 = [], [], []
    tu0, tu1, tu2 = [], [], []
    tn0, tn1, tn2 = [], [], []
    any_vn = False
    tri_mats: List[Material] = []
    tri_tex: List[str] = []
    zero3 = np.zeros(3, np.float32)

    def resolve(idx: int, n: int) -> int:
        """1-based; negative = relative from end (extension)."""
        return idx - 1 if idx > 0 else n + idx

    with open(path, "r", errors="replace") as fh:
        for line in fh:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            tag = parts[0]
            if tag == "mtllib" and len(parts) > 1:
                mtl.update(load_mtl(os.path.join(base_dir, parts[1])))
            elif tag == "usemtl" and len(parts) > 1:
                cur_mtl = parts[1]
            elif tag == "v" and len(parts) >= 4:
                try:
                    verts.append(np.array(
                        [scale * float(parts[1]), scale * float(parts[2]),
                         scale * float(parts[3])], np.float32))
                except ValueError:
                    pass
            elif tag == "vt" and len(parts) >= 3:
                try:
                    # store V flipped, exactly like the reference
                    uvs.append(np.array([float(parts[1]),
                                         1.0 - float(parts[2])], np.float32))
                except ValueError:
                    pass
            elif smooth and tag == "vn" and len(parts) >= 4:
                try:
                    n = np.array([float(parts[1]), float(parts[2]),
                                  float(parts[3])], np.float32)
                    ln = float(np.linalg.norm(n))
                    norms.append(n / ln if ln > 0 else n)
                except ValueError:
                    pass
            elif tag == "f" and len(parts) >= 4:
                toks = parts[1:]
                use_mat = fallback
                if cur_mtl:
                    if cur_mtl in mat_cache:
                        use_mat = mat_cache[cur_mtl]
                    elif cur_mtl in mtl:
                        use_mat = material_from_mtl(mtl[cur_mtl], base_dir)
                        mat_cache[cur_mtl] = use_mat

                i0, it0, in0 = _parse_face_token(toks[0])
                if i0 == 0:
                    continue
                vi0 = resolve(i0, len(verts))
                if not (0 <= vi0 < len(verts)):
                    continue
                v0 = verts[vi0]
                uv0 = (uvs[resolve(it0, len(uvs))]
                       if it0 != 0 and 0 <= resolve(it0, len(uvs)) < len(uvs)
                       else np.zeros(2, np.float32))

                def vnorm(ix):
                    if not smooth or ix == 0:
                        return zero3
                    r = resolve(ix, len(norms))
                    return norms[r] if 0 <= r < len(norms) else zero3

                n0 = vnorm(in0)

                tex_path = ""
                if cur_mtl and cur_mtl in mtl and mtl[cur_mtl].map_Kd:
                    tex_path = os.path.join(base_dir, mtl[cur_mtl].map_Kd)

                for k in range(1, len(toks) - 1):
                    i1, it1, in1 = _parse_face_token(toks[k])
                    i2, it2, in2 = _parse_face_token(toks[k + 1])
                    if i1 == 0 or i2 == 0:
                        continue
                    vi1 = resolve(i1, len(verts))
                    vi2 = resolve(i2, len(verts))
                    if not (0 <= vi1 < len(verts) and 0 <= vi2 < len(verts)):
                        continue
                    tv0.append(v0)
                    tv1.append(verts[vi1])
                    tv2.append(verts[vi2])
                    tu0.append(uv0)
                    tu1.append(uvs[resolve(it1, len(uvs))]
                               if it1 != 0 and 0 <= resolve(it1, len(uvs)) < len(uvs)
                               else np.zeros(2, np.float32))
                    tu2.append(uvs[resolve(it2, len(uvs))]
                               if it2 != 0 and 0 <= resolve(it2, len(uvs)) < len(uvs)
                               else np.zeros(2, np.float32))
                    if smooth:
                        n1v, n2v = vnorm(in1), vnorm(in2)
                        any_vn = any_vn or (n0 is not zero3
                                            or n1v is not zero3
                                            or n2v is not zero3)
                        tn0.append(n0)
                        tn1.append(n1v)
                        tn2.append(n2v)
                    tri_mats.append(use_mat)
                    tri_tex.append(tex_path)

    n = len(tv0)
    shape3 = (n, 3) if n else (0, 3)
    shape2 = (n, 2) if n else (0, 2)
    use_vn = smooth and any_vn
    return MeshData(
        v0=np.asarray(tv0, np.float32).reshape(shape3),
        v1=np.asarray(tv1, np.float32).reshape(shape3),
        v2=np.asarray(tv2, np.float32).reshape(shape3),
        uv0=np.asarray(tu0, np.float32).reshape(shape2),
        uv1=np.asarray(tu1, np.float32).reshape(shape2),
        uv2=np.asarray(tu2, np.float32).reshape(shape2),
        materials=tri_mats, tex_paths=tri_tex,
        n0=np.asarray(tn0, np.float32).reshape(shape3) if use_vn else None,
        n1=np.asarray(tn1, np.float32).reshape(shape3) if use_vn else None,
        n2=np.asarray(tn2, np.float32).reshape(shape3) if use_vn else None)
