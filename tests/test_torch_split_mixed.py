"""The split pipeline (render_frame_wavefront, render_frame_queue) on
scenes the path kernel now also covers: quads with a quad light, and a
smooth (vn) mesh, whose walk goes through the traversal kernel's
(t, u, v, tri) and blends the vertex normals after it.  Against the JAX
wave loops on their per-lane walk, by the rule of
tests/test_torch_wavefront.py: at least 99% of pixels identical, mean
|d| <= 0.5 u8 (jitted XLA-CPU contracts a*b+c into fused multiply-adds),
exact ray counts.
"""

import numpy as np
import pytest

import dsrt_tpu.ops.trace as jtrace
from dsrt_tpu.config import RenderConfig as JRenderConfig
from dsrt_tpu.exec_opts import OPTS as JOPTS
from dsrt_tpu.models.materials import Material as JMaterial
from dsrt_tpu.models.scene import SceneBuilder as JSceneBuilder
from dsrt_tpu.ops.camera import make_camera as jmake_camera
from dsrt_tpu.render import render_frame_queue as jrender_queue
from dsrt_tpu.render import render_frame_wavefront as jrender_wavefront
from dsrt_tpu_torch.config import RenderConfig
from dsrt_tpu_torch.models import feature_scenes as fs
from dsrt_tpu_torch.models.scene import scene_from_reference
from dsrt_tpu_torch.ops.camera import camera_from_reference
from dsrt_tpu_torch.render import render_frame_queue, render_frame_wavefront
from test_torch_render import assert_images_match

CFG = dict(width=32, height=24, spp=4, max_depth=8)


@pytest.fixture
def lane_forced(monkeypatch):
    """The reference on its per-lane walk (the port's walk), Pallas off."""
    monkeypatch.setattr(jtrace, "LANE_SWITCH_TRIS", 0)
    monkeypatch.setattr(JOPTS, "pallas", "off")


def _case(name):
    fn, frm, at, vfov, _ = fs.CASES[name]
    js = fn(JSceneBuilder, JMaterial).build()
    jc = jmake_camera(frm, at, vfov=vfov, width=CFG["width"],
                      height=CFG["height"])
    return (js, jc, scene_from_reference(js, device="cpu"),
            camera_from_reference(jc, device="cpu"))


@pytest.mark.parametrize("name", ["quad_light", "smooth"])
def test_render_frame_wavefront_matches_jax(lane_forced, name):
    js, jc, ts, tc = _case(name)
    assert ts.n_quads or ts.has_smooth
    got, n = render_frame_wavefront(ts, tc, RenderConfig(**CFG), spp_batch=2,
                                    with_count=True)
    want, jn = jrender_wavefront(js, jc, JRenderConfig(**CFG), spp_batch=2,
                                 with_count=True)
    assert_images_match(got, np.asarray(want))
    assert n == jn
    assert (got > 0).mean() > 0.05


def test_render_frame_queue_matches_jax_on_quads(lane_forced):
    js, jc, ts, tc = _case("quad_light")
    got = render_frame_queue(ts, tc, RenderConfig(**CFG))
    want = jrender_queue(js, jc, JRenderConfig(**CFG))
    assert_images_match(got, np.asarray(want))
    assert (got > 0).mean() > 0.05
