"""Host-side texture registry and atlas.

A copy of dsrt_tpu/models/textures.py: the port imports nothing of the JAX package.

Reproduces the reference's texture pipeline
(src/gpu_scene_builder.cpp:199-246, 513-555):

- path-keyed dedup;
- decode forced to RGB;
- sRGB -> linear via pow(c/255, 2.2) at load time;
- failed loads fall back to a 1x1 white texture (with a warning);
- all textures concatenated into one flat float32 RGB pool with
  (width, height, offset) headers.

Note the V-handedness contract: the OBJ loader stores v as 1-v
(inc/triangle_mesh.h:207) and the sampler flips again with j=(1-v)(h-1)
(src/gpu_render.cu:248), net un-flipping.  Both flips are reproduced
verbatim (loader in models/obj.py, sampler in ops/textures.py).
"""

from __future__ import annotations

import logging
from typing import Dict, List

import numpy as np

from dsrt_tpu_torch.utils.image_io import load_image_rgb8

log = logging.getLogger(__name__)


class TextureRegistry:
    def __init__(self) -> None:
        self._path_to_index: Dict[str, int] = {}
        self._images: List[np.ndarray] = []  # (H,W,3) float32 linear

    def get_or_load(self, path: str) -> int:
        """Return the texture index for `path`, loading on first use.
        Empty path -> -1 (no texture)."""
        if not path:
            return -1
        idx = self._path_to_index.get(path)
        if idx is not None:
            return idx
        try:
            if path.lower().endswith(".hdr"):
                # Radiance HDR is already linear radiance — no transfer
                # curve (stb's float path, stbi_loadf)
                from dsrt_tpu_torch.utils.image_io import read_hdr
                linear = read_hdr(path)
            else:
                rgb8 = load_image_rgb8(path)
                linear = np.power(rgb8.astype(np.float32) / 255.0, 2.2)
        except Exception as e:  # white 1x1 fallback, builder.cpp:217-222
            log.warning("failed to load texture '%s' (%s); using 1x1 white",
                        path, e)
            linear = np.ones((1, 1, 3), np.float32)
        idx = len(self._images)
        self._images.append(linear)
        self._path_to_index[path] = idx
        return idx

    def add_array(self, rgb_linear: np.ndarray) -> int:
        """Register an in-memory linear-RGB float texture (tests)."""
        img = np.asarray(rgb_linear, np.float32)
        assert img.ndim == 3 and img.shape[2] == 3
        idx = len(self._images)
        self._images.append(img)
        return idx

    @property
    def num_textures(self) -> int:
        return len(self._images)

    def build_pool(self):
        """Flatten to (pool_f32[P], w[i32,N], h[i32,N], off[i32,N])."""
        n = len(self._images)
        if n == 0:
            return (np.zeros((3,), np.float32), np.zeros((1,), np.int32),
                    np.zeros((1,), np.int32), np.zeros((1,), np.int32), 0)
        ws = np.empty(n, np.int32)
        hs = np.empty(n, np.int32)
        offs = np.empty(n, np.int32)
        chunks = []
        off = 0
        for i, img in enumerate(self._images):
            h, w = img.shape[:2]
            ws[i], hs[i], offs[i] = w, h, off
            chunks.append(img.reshape(-1))
            off += h * w * 3
        pool = np.concatenate(chunks).astype(np.float32)
        return pool, ws, hs, offs, n

    def build_pool_tiled(self, tile: int = 32):
        """The SAME texels re-laid into `tile` x `tile` texel tiles
        (row-major tiles, row-major texels within a tile; images padded
        up to tile multiples with zeros).  The fused megakernel's
        per-lane pool gather prices a wave by the number of gather
        CHUNKS its texel indices touch; row-major layout spreads a
        spatially-coherent UV footprint across ~footprint_height rows
        (v-adjacent texels sit a full image width apart), while the
        tiled layout keeps a 32x32 footprint inside ONE tile — so big
        map_Kd pools stop touching every chunk per wave.  Returns
        (pool_f32[Pt] interleaved, toff[i32,N] texel offsets,
        ttw[i32,N] tiles-across).  Values are identical to build_pool's
        (addresses differ), so renders stay bit-identical."""
        n = len(self._images)
        if n == 0:
            return (np.zeros((3,), np.float32), np.zeros((1,), np.int32),
                    np.zeros((1,), np.int32))
        toffs = np.empty(n, np.int32)
        ttws = np.empty(n, np.int32)
        chunks = []
        off = 0
        for i, img in enumerate(self._images):
            h, w = img.shape[:2]
            th = -(-h // tile)
            tw = -(-w // tile)
            pad = np.zeros((th * tile, tw * tile, 3), np.float32)
            pad[:h, :w] = img
            t = (pad.reshape(th, tile, tw, tile, 3)
                 .transpose(0, 2, 1, 3, 4))
            toffs[i] = off // 3      # texel units
            ttws[i] = tw
            chunks.append(t.reshape(-1))
            off += t.size
        return np.concatenate(chunks).astype(np.float32), toffs, ttws


def make_perlin_tables(rng: np.random.Generator | None = None):
    """Generate the classic Perlin tables (inc/perlin.h:18-37): 256 unit
    gradient vectors and three independent index permutations."""
    rng = rng or np.random.default_rng(20271)
    v = rng.uniform(-1.0, 1.0, size=(256, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    perms = [rng.permutation(256).astype(np.int32) for _ in range(3)]
    return v.astype(np.float32), perms[0], perms[1], perms[2]
