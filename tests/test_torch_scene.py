"""dsrt_tpu_torch scene compiler against the JAX reference compiler.

Every table the port keeps must be np.array_equal to the reference
Scene's, including the build-time bf16 quantizations (UV pairs in
tri_pack lanes 13-15 and the texture pool).
"""

import os

import numpy as np
import pytest
import torch

from dsrt_tpu.models.materials import Material
from dsrt_tpu.models.obj import load_obj
from dsrt_tpu.models import mesh_gen as jmesh
from dsrt_tpu.models import presets as jpresets
from dsrt_tpu.models.scene import SceneBuilder as JSceneBuilder
from dsrt_tpu_torch.models import mesh_gen as tmesh
from dsrt_tpu_torch.models import presets as tpresets
from dsrt_tpu_torch.models.scene import (META, TABLES, SceneBuilder,
                                         scene_from_reference)
from test_envmap import _env_array as env_array
from test_envmap import _scene as jenv_scene
from test_fused_spheres import _dof_motion_scene as jdof_motion_scene

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")


def mixed_material_scene(builder_cls, n: int = 90, rng_seed: int = 11):
    """Triangle scene with every material the path kernel shades
    (lambertian, metal, dielectric, diffuse_light) over a floor, sun on;
    built by either SceneBuilder (JAX reference or port) from the same
    Material objects."""
    rng = np.random.default_rng(rng_seed)
    b = builder_cls(sun_enabled=True, sun_dir=(-0.3, -1.0, -0.5),
                    sun_radiance=(5.0, 4.8, 4.5), seed=1337)
    mats = [Material.lambertian((0.7, 0.4, 0.3)),
            Material.metal((0.8, 0.8, 0.85), fuzz=0.2),
            Material.dielectric(1.5),
            Material.diffuse_light((4.0, 3.5, 3.0)),
            Material.metal((0.9, 0.6, 0.3), fuzz=0.0)]
    floor = Material.lambertian((0.6, 0.6, 0.6))
    b.add_triangle((-6.0, -1.2, 2.0), (6.0, -1.2, 2.0), (6.0, -1.2, -9.0),
                   floor)
    b.add_triangle((-6.0, -1.2, 2.0), (6.0, -1.2, -9.0), (-6.0, -1.2, -9.0),
                   floor)
    centers = rng.uniform([-1.8, -1.0, -4.5], [1.8, 1.2, -2.0], (n, 3))
    for i in range(n):
        c = centers[i]
        e1 = rng.normal(0, 0.25, 3)
        e2 = rng.normal(0, 0.25, 3)
        b.add_triangle(c, c + e1, c + e2, mats[i % len(mats)])
    return b.build()


def assert_same_tables(port, ref):
    for name, dtype in TABLES:
        want = np.asarray(getattr(ref, name)).astype(dtype)
        got = getattr(port, name).cpu().numpy()
        assert got.shape == want.shape, name
        assert np.array_equal(got, want), name
    for name in META:
        assert getattr(port, name) == getattr(ref, name), name


def test_station_obj_tables_match():
    obj = os.path.join(FIXTURES, "station.obj")
    fallback = Material.lambertian((0.73, 0.73, 0.73))

    def build(cls):
        b = cls(sun_enabled=True, sun_dir=(0.0, 1.0, 0.0), seed=1337,
                bvh_method="sbvh")
        b.add_mesh(load_obj(obj, fallback, 1.0))
        return b.build()

    port, ref = build(SceneBuilder), build(JSceneBuilder)
    assert port.has_image_tex and port.n_tris == 21
    assert_same_tables(port, ref)


def test_tri_soup_tables_match():
    assert_same_tables(tpresets.random_tri_soup_scene(n=200),
                       jpresets.random_tri_soup_scene(n=200))


def test_single_triangle_tables_match():
    assert_same_tables(tpresets.single_triangle_scene(sun=False),
                       jpresets.single_triangle_scene(sun=False))


def test_mixed_material_tables_match():
    port = mixed_material_scene(SceneBuilder)
    ref = mixed_material_scene(JSceneBuilder)
    kinds = set(port.mat_pack[:, 0].tolist())
    assert kinds == {0.0, 1.0, 2.0, 3.0}
    assert_same_tables(port, ref)


def test_textured_standin_tables_match(tmp_path):
    tex = str(tmp_path / "panel.png")
    tmesh.write_panel_texture(tex)
    port = tmesh.iss_standin_scene(detail=2, tex_path=tex)
    ref = jmesh.iss_standin_scene(detail=2, tex_path=tex)
    assert port.has_image_tex
    # bf16-quantized pool and packed bf16 UV lanes are part of the tables
    pool = port.tex_pool.numpy().view(np.uint32)
    assert (pool & 0xFFFF).max() == 0
    assert_same_tables(port, ref)
    # scene_from_reference carries the reference tables over unchanged
    assert_same_tables(scene_from_reference(ref), ref)


@pytest.mark.slow
def test_flagship_scene_round_trip(tmp_path):
    """The flagship: textured detail-12 stand-in (51k triangles)."""
    tex = str(tmp_path / "panel.png")
    tmesh.write_panel_texture(tex)
    port = tmesh.iss_standin_scene(detail=12, tex_path=tex)
    ref = jmesh.iss_standin_scene(detail=12, tex_path=tex)
    assert port.n_tris > 50000
    assert_same_tables(port, ref)
    assert_same_tables(scene_from_reference(ref), ref)


SPHERE_SCENES = {
    "rtiow": (tpresets.rtiow_smoke_scene, jpresets.rtiow_smoke_scene),
    "sphere_light": (tpresets.sphere_light_scene,
                     jpresets.sphere_light_scene),
    "volumetric": (tpresets.volumetric_scene, jpresets.volumetric_scene),
    "dof_motion": (lambda: tpresets.dof_motion_scene(sun=True),
                   lambda: jdof_motion_scene(sun=True)),
    "env": (lambda: tpresets.env_sphere_scene(env_array(), 30.0, 1.5),
            lambda: jenv_scene(30.0, 1.5)),
}


@pytest.mark.parametrize("name", SPHERE_SCENES)
def test_sphere_scene_tables_match(name):
    """Spheres, moving centres, media, the light list and the sky: the
    port's presets against the reference scenes they mirror, and
    scene_from_reference on the reference scene."""
    make_port, make_ref = SPHERE_SCENES[name]
    port, ref = make_port(), make_ref()
    assert port.n_spheres > 0 and port.n_tris == 0
    assert_same_tables(port, ref)
    assert_same_tables(scene_from_reference(ref), ref)


def test_sphere_scene_contents():
    vol = tpresets.volumetric_scene()
    assert (vol.n_media, vol.n_lights, vol.has_ptex) == (1, 1, True)
    assert vol.med_neg_inv_density.tolist() == [np.float32(-1.0 / 2.5)]
    dof = tpresets.dof_motion_scene()
    assert dof.has_moving and dof.n_lights == 1
    assert dof.light_idx.tolist() == [3]
    env = tpresets.env_sphere_scene(env_array(), 90.0, 2.0)
    assert env.has_env and not env.has_image_tex
    assert env.env_rotation == pytest.approx(np.pi / 2)
    assert not tpresets.rtiow_smoke_scene().has_env


def test_unported_primitives_raise():
    b = SceneBuilder()
    m = Material.lambertian()
    for call in (lambda: b.add_quad((0, 0, 0), (1, 0, 0), (0, 1, 0), m),
                 lambda: b.add_box((0, 0, 0), (1, 1, 1), m)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            call()


def test_with_sun_swaps_only_the_sun():
    s = tpresets.single_triangle_scene()
    s2 = s.with_sun((0.0, 0.0, 1.0))
    assert s2.sun_dir.tolist() == [0.0, 0.0, 1.0]
    assert s2.tri_pack is s.tri_pack and s2.bvh_pack is s.bvh_pack
    s3 = s.to("cpu")
    assert torch.equal(s3.tri_pack, s.tri_pack)
