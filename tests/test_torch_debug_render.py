"""The debug and radiance renders of the port (dsrt_tpu_torch.render
render_frame_debug and render_radiance, their plain walks on CPU scenes)
against the JAX package's, run op by op (`jax.disable_jit()`, so XLA-CPU
fuses no multiply-add; its sample loop, a `jax.lax.fori_loop`, then runs
as the Python loop below, which hands the body a jnp.int32 index as the
traced loop does) with the reference on its per-ray walk.

Tolerance: the debug frames u8-exact, the radiance float32-exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import dsrt_tpu.ops.trace as jtrace
from dsrt_tpu.config import RenderConfig as JRenderConfig
from dsrt_tpu.exec_opts import OPTS as JOPTS
from dsrt_tpu.models import mesh_gen as jmesh
from dsrt_tpu.models import presets as jpresets
from dsrt_tpu.ops.camera import make_camera as jmake_camera
from dsrt_tpu.ops.camera import point_camera_at as jpoint
from dsrt_tpu.render import render_frame_debug as jdebug
from dsrt_tpu.render import render_radiance as jradiance
from dsrt_tpu_torch.config import RenderConfig
from dsrt_tpu_torch.models.mesh_gen import write_panel_texture
from dsrt_tpu_torch.models.scene import scene_from_reference
from dsrt_tpu_torch.ops.camera import camera_from_reference
from dsrt_tpu_torch.render import render_frame_debug, render_radiance

FRAME = dict(width=32, height=16, spp=2, max_depth=6)
SUNLIT = (-20.0, -30.0, -95.0)   # the stand-in's sunlit side


def _fori_loop(lower, upper, body, init):
    carry = init
    for i in range(lower, upper):
        carry = body(jnp.int32(i), carry)
    return carry


@pytest.fixture
def lane_forced(monkeypatch):
    """The reference on its per-ray walk (the port's walk), Pallas off,
    its sample loops run op by op."""
    monkeypatch.setattr(jtrace, "LANE_SWITCH_TRIS", 0)
    monkeypatch.setattr(JOPTS, "pallas", "off")
    monkeypatch.setattr(jax.lax, "fori_loop", _fori_loop)


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    """name -> (JAX scene, JAX camera): the textured stand-in seen from
    its sunlit side, and the Cornell box (a quad light)."""
    kw = dict(width=FRAME["width"], height=FRAME["height"])
    tex = str(tmp_path_factory.mktemp("tex") / "panel.png")
    write_panel_texture(tex, size=16)
    return {
        "textured standin": (jmesh.iss_standin_scene(detail=2, tex_path=tex),
                             jpoint(SUNLIT, vfov=40.0, **kw)),
        "cornell": (jpresets.cornell_box_scene(),
                    jmake_camera((0.5, 0.5, -1.3), (0.5, 0.5, 0.5),
                                 vfov=40.0, **kw))}


@pytest.mark.parametrize("name,sky", [("textured standin", "solid"),
                                      ("textured standin", "gradient"),
                                      ("cornell", "gradient")])
def test_debug_frame_matches_reference(lane_forced, cases, name, sky):
    js, jc = cases[name]
    extra = dict(sky_type=sky, sky_solid=(0.1, 0.2, 0.3))
    with jax.disable_jit():
        want = np.asarray(jdebug(js, jc, JRenderConfig(**FRAME, **extra)))
    got = render_frame_debug(scene_from_reference(js, device="cpu"),
                             camera_from_reference(jc, device="cpu"),
                             RenderConfig(**FRAME, **extra))
    assert got.shape == want.shape == (16, 32, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got.reshape(-1, 3), axis=0)) > 8, "a flat frame"


def test_radiance_matches_reference(lane_forced, cases):
    js, jc = cases["textured standin"]
    frame = dict(FRAME, max_depth=2)
    with jax.disable_jit():
        want = np.asarray(jradiance(js, jc, JRenderConfig(**frame)))
    got = render_radiance(scene_from_reference(js, device="cpu"),
                          camera_from_reference(jc, device="cpu"),
                          RenderConfig(**frame))
    assert got.shape == want.shape == (16, 32, 3)
    assert got.dtype == want.dtype == np.float32
    assert (got > 0).mean() > 0.05
    np.testing.assert_array_equal(got, want)
