"""Whole frames of the path kernel's wider scope: the port's plain renderer
(dsrt_tpu_torch.render.render_frame_fused on CPU scenes, the plain
version of `dsrt_path_render`) against the JAX package.

One case per feature group (dsrt_tpu_torch/models/feature_scenes.py,
built by the JAX builder and converted with scene_from_reference), plus
the mixed preset, the mixed stand-in and the volumetric-mesh scene.  The
JAX side is its parity renderer, on its per-lane walk, which the JAX
package's own tests hold bit-identical to its fused TPU kernel
(tests/test_fused_mixed.py, test_fused_media.py, test_fused_shaded.py);
the sphere mix is also held against that kernel itself, interpreted on
the CPU (tests/test_torch_cornell.py and tests/test_torch_media_mesh.py
hold two more cases so).

Tolerance: u8-exact and equal ray counts.  (test_torch_render.py's
allowance of >= 99% identical pixels and mean |d| <= 0.5 u8, for jitted
XLA-CPU's fused multiply-adds, is not needed on these cases.)
"""

import numpy as np
import pytest

import dsrt_tpu.ops.trace as jtrace
from dsrt_tpu.config import RenderConfig as JRenderConfig
from dsrt_tpu.exec_opts import OPTS as JOPTS
from dsrt_tpu.models import mesh_gen as jmesh
from dsrt_tpu.models import presets as jpresets
from dsrt_tpu.models.materials import Material as JMaterial
from dsrt_tpu.models.scene import SceneBuilder as JSceneBuilder
from dsrt_tpu.ops.camera import make_camera as jmake_camera
from dsrt_tpu.ops.camera import point_camera_at as jpoint
from dsrt_tpu.render import render_frame as jrender
from dsrt_tpu_torch.config import RenderConfig
from dsrt_tpu_torch.models import feature_scenes as fs
from dsrt_tpu_torch.models import mesh_gen as tmesh
from dsrt_tpu_torch.models.scene import scene_from_reference
from dsrt_tpu_torch.ops.camera import camera_from_reference
from dsrt_tpu_torch.render import render_frame_fused
from test_torch_render import reference_ray_count

FRAME = dict(width=32, height=16, spp=2, max_depth=6)
STANDIN_CAM = (-20.0, -30.0, -95.0)   # the stand-in's sunlit side


@pytest.fixture
def lane_forced(monkeypatch):
    """The reference on its per-lane walk (the port's walk), Pallas off."""
    monkeypatch.setattr(jtrace, "LANE_SWITCH_TRIS", 0)
    monkeypatch.setattr(JOPTS, "pallas", "off")


def jax_case(name, tex_path=""):
    """(JAX scene, JAX camera, config extras) of a frame case."""
    if name == "mixed_preset":
        cam = jmake_camera((0, 0.8, 2.6), (0, 0.3, -1), vfov=50,
                           width=FRAME["width"], height=FRAME["height"])
        return jpresets.mixed_scene(), cam, {}
    if name == "mixed_standin":
        return (jmesh.iss_mixed_scene(detail=2),
                jpoint(STANDIN_CAM, vfov=40.0, width=FRAME["width"],
                       height=FRAME["height"]), {})
    if name == "volumetric_mesh":
        scene = fs.volumetric_mesh(JSceneBuilder, JMaterial,
                                   standin_mesh=jmesh.iss_standin_mesh,
                                   detail=2).build()
        return (scene, jpoint(STANDIN_CAM, vfov=40.0, width=FRAME["width"],
                              height=FRAME["height"]), {})
    fn, frm, at, vfov, extra = fs.CASES[name]
    scene = fn(JSceneBuilder, JMaterial, tex_path=tex_path).build()
    cam = jmake_camera(frm, at, vfov=vfov, width=FRAME["width"],
                       height=FRAME["height"],
                       aperture=extra.get("aperture", 0.0))
    return scene, cam, extra


def port_render(js, jc, extra):
    """The port's frame and exact ray count on CPU copies."""
    return render_frame_fused(scene_from_reference(js, device="cpu"),
                              camera_from_reference(jc, device="cpu"),
                              RenderConfig(**FRAME, **extra), with_count=True)


def assert_same_frame(got, want):
    assert got.shape == want.shape and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


FRAME_CASES = list(fs.CASES) + ["mixed_preset", "mixed_standin",
                                "volumetric_mesh"]


@pytest.mark.parametrize("name", FRAME_CASES)
def test_frame_matches_parity_renderer(lane_forced, name, tmp_path):
    tex = str(tmp_path / "panel.png")
    tmesh.write_panel_texture(tex, size=16)
    js, jc, extra = jax_case(name, tex)
    jcfg = JRenderConfig(**FRAME, **extra)
    want = np.asarray(jrender(js, jc, jcfg))
    got, nrays = port_render(js, jc, extra)
    assert (got > 0).mean() > 0.01, "dark frame"
    assert_same_frame(got, want)
    assert nrays == reference_ray_count(js, jc, jcfg)


def interpret_check(name, tex_path=""):
    """A case against the JAX fused TPU kernel itself (pallas_path
    `_path_kernel`), interpreted on the CPU: u8 frame and ray count."""
    from jax.experimental.pallas import tpu as pltpu
    from dsrt_tpu.render import render_frame_fused as jfused
    js, jc, extra = jax_case(name, tex_path)
    with pltpu.force_tpu_interpret_mode():
        want, jn = jfused(js, jc, JRenderConfig(**FRAME, **extra),
                          with_count=True)
    got, nrays = port_render(js, jc, extra)
    assert (got > 0).mean() > 0.05, "dark frame"
    assert_same_frame(got, np.asarray(want))
    assert nrays == jn


def test_sphere_mix_matches_the_tpu_kernel_interpreted():
    interpret_check("sphere_mix")


def test_shutter_draw_on_a_static_triangle_scene(lane_forced):
    """A shutter-open config on a static triangle scene still takes the
    shutter draw (the JAX renderer draws on time1 > time0 alone)."""
    js, jc, _ = jax_case("dof")
    extra = dict(time0=0.0, time1=1.0)
    base, _ = port_render(js, jc, {})
    shut, _ = port_render(js, jc, extra)
    assert (base != shut).any()
    want = np.asarray(jrender(js, jc, JRenderConfig(**FRAME, **extra)))
    assert_same_frame(shut, want)
