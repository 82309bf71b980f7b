"""Sphere scenes as whole frames: dsrt_tpu_torch.render.render_frame_fused
on CPU tensors (the sphere kernel's plain version) against the JAX parity
renderer dsrt_tpu.render.render_frame.

Tolerance: u8-exact on rtiow_smoke_scene.  Elsewhere at least 99% of
pixels identical and mean |d| <= 0.5 u8: cos, sin and log (sphere lights,
the marble texture, media free paths) are taken in float64 and rounded
once by the port and in float32 by XLA-CPU, and a last-bit difference can
move a path.  Measured at these sizes: every frame identical, and the
exact ray counts equal.
"""

import numpy as np
import pytest

from dsrt_tpu.config import RenderConfig
from dsrt_tpu.models import presets as jpresets
from dsrt_tpu.ops.camera import make_camera as jmake_camera
from dsrt_tpu.render import render_frame as jrender
from dsrt_tpu_torch.models import presets as tpresets
from dsrt_tpu_torch.ops import sphere_kernel
from dsrt_tpu_torch.ops.camera import make_camera
from dsrt_tpu_torch.render import fused_kind, render_frame_fused
from test_torch_render import assert_images_match

LOOK = ((0.0, 0.6, 2.0), (0.0, 0.0, -1.0))
PRESETS = {
    "rtiow_smoke_scene": RenderConfig(width=32, height=16, spp=2,
                                      max_depth=6),
    "sphere_light_scene": RenderConfig(width=40, height=20, spp=2,
                                       max_depth=8),
    "volumetric_scene": RenderConfig(width=32, height=16, spp=2,
                                     max_depth=6),
}
# exact ray counts of the JAX sphere kernel at 32x16, spp 2, depth 6
# (interpret mode; tests/test_torch_sphere_kernel.py re-derives them)
RAYS_32x16 = {"rtiow_smoke_scene": 2464, "volumetric_scene": 2102}


@pytest.mark.parametrize("name", list(PRESETS))
def test_sphere_preset_matches_parity_renderer(name):
    cfg = PRESETS[name]
    kw = dict(vfov=50, width=cfg.width, height=cfg.height)
    ts = getattr(tpresets, name)()
    assert fused_kind(ts, cfg) == "sphere"
    before = dict(sphere_kernel.LAUNCHES)
    got, nrays = render_frame_fused(ts, make_camera(*LOOK, **kw), cfg,
                                    with_count=True)
    assert sphere_kernel.LAUNCHES == before     # CPU: the plain version
    want = jrender(getattr(jpresets, name)(), jmake_camera(*LOOK, **kw),
                   cfg)
    assert (got > 0).mean() > 0.05, "scene not in frame"
    if name == "rtiow_smoke_scene":
        np.testing.assert_array_equal(got, want)
    else:
        assert_images_match(got, want)
    if name in RAYS_32x16:
        assert nrays == RAYS_32x16[name]


def test_depth_of_field_and_motion_blur_match_parity_renderer():
    """Aperture 0.2 (the lens disk after the jitter pair), shutter
    0.2-0.8 (one draw per sample, held for the whole path), a moving
    sphere and the sun (shadow queries at the path's shutter time)."""
    from test_fused_spheres import _dof_motion_scene
    cfg = RenderConfig(width=48, height=24, spp=2, max_depth=8,
                       aperture=0.2, time0=0.2, time1=0.8)
    kw = dict(vfov=60, width=cfg.width, height=cfg.height, aperture=0.2)
    look = ((0.0, 0.4, 1.2), (0.0, 0.0, -1.0))
    got = render_frame_fused(tpresets.dof_motion_scene(sun=True),
                             make_camera(*look, **kw), cfg)
    want = jrender(_dof_motion_scene(sun=True), jmake_camera(*look, **kw),
                   cfg)
    assert (got > 0).mean() > 0.05
    assert_images_match(got, want)
    # the shutter moves the picture: the same frame with it closed differs
    closed = render_frame_fused(
        tpresets.dof_motion_scene(sun=True), make_camera(*look, **kw),
        RenderConfig(width=48, height=24, spp=2, max_depth=8, aperture=0.2))
    assert (closed != got).any()


def test_environment_sky_frame_matches_parity_renderer():
    from test_envmap import _env_array, _scene
    cfg = RenderConfig(width=32, height=16, spp=2, max_depth=6)
    kw = dict(vfov=60, width=cfg.width, height=cfg.height)
    look = ((0.0, 0.2, 0.5), (0.0, 0.0, -2.0))
    got = render_frame_fused(
        tpresets.env_sphere_scene(_env_array(), rotation_deg=30.0,
                                  scale=1.5),
        make_camera(*look, **kw), cfg)
    want = jrender(_scene(rotation_deg=30.0, scale=1.5),
                   jmake_camera(*look, **kw), cfg)
    assert (got > 0).mean() > 0.9, "sky expected around the spheres"
    assert_images_match(got, want)
