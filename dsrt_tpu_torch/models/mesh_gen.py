"""The ISS stand-in scene on the port's scene compiler.

The procedural mesh itself is dsrt_tpu.models.mesh_gen.iss_standin_mesh
(numpy, shared); this wraps it like dsrt_tpu/models/mesh_gen.py:195-212.
"""

from __future__ import annotations

import numpy as np

from dsrt_tpu.models.mesh_gen import iss_standin_mesh
from dsrt_tpu.utils.image_io import write_png
from dsrt_tpu_torch.models.scene import Scene, SceneBuilder


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


def iss_standin_scene(detail: int = 2, tex_path: str = "",
                      device="cpu") -> Scene:
    """Stand-in station at the origin with the reference's default sun
    (model->Sun (0.35, 0.65, 0.4)) and SBVH; `tex_path` textures the
    solar-panel and radiator quads."""
    b = SceneBuilder(sun_enabled=True, sun_dir=(0.35, 0.65, 0.4),
                     sun_radiance=(1e5, 9.5e4, 9e4), seed=1337,
                     bvh_method="sbvh")
    b.add_mesh(iss_standin_mesh(detail, tex_path=tex_path))
    return b.build(device=device)
