"""dsrt_tpu_torch scene compiler against the JAX reference compiler.

Every table the port keeps must be np.array_equal to the reference
Scene's, including the build-time bf16 quantizations (UV pairs in
tri_pack lanes 13-15 and the texture pool).
"""

import os

import numpy as np
import pytest
import torch

from dsrt_tpu import native as jnative
from dsrt_tpu.models.materials import Material as JMaterial
from dsrt_tpu.models.obj import load_obj as jload_obj
from dsrt_tpu.models import mesh_gen as jmesh
from dsrt_tpu.models import presets as jpresets
from dsrt_tpu.models.scene import SceneBuilder as JSceneBuilder
from dsrt_tpu_torch import native as tnative
from dsrt_tpu_torch.models import bvh_build as tbvh
from dsrt_tpu_torch.models import mesh_gen as tmesh
from dsrt_tpu_torch.models.materials import Material
from dsrt_tpu_torch.models.obj import load_obj
from dsrt_tpu_torch.models import presets as tpresets
from dsrt_tpu_torch.models.scene import (META, REF_TABLES, SceneBuilder,
                                         pack_wide, scene_from_reference)
from test_envmap import _env_array as env_array
from test_envmap import _scene as jenv_scene
from test_fused_spheres import _dof_motion_scene as jdof_motion_scene

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")


def mixed_material_scene(builder_cls, n: int = 90, rng_seed: int = 11,
                         **build_kw):
    """Triangle scene with every material the path kernel shades
    (lambertian, metal, dielectric, diffuse_light) over a floor, sun on;
    built by either SceneBuilder (JAX reference or port), each with its
    own package's Material."""
    mat = Material if builder_cls is SceneBuilder else JMaterial
    rng = np.random.default_rng(rng_seed)
    b = builder_cls(sun_enabled=True, sun_dir=(-0.3, -1.0, -0.5),
                    sun_radiance=(5.0, 4.8, 4.5), seed=1337)
    mats = [mat.lambertian((0.7, 0.4, 0.3)),
            mat.metal((0.8, 0.8, 0.85), fuzz=0.2),
            mat.dielectric(1.5),
            mat.diffuse_light((4.0, 3.5, 3.0)),
            mat.metal((0.9, 0.6, 0.3), fuzz=0.0)]
    floor = mat.lambertian((0.6, 0.6, 0.6))
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
    return b.build(**build_kw)


def assert_same_tables(port, ref):
    for name, dtype in REF_TABLES:
        want = np.asarray(getattr(ref, name)).astype(dtype)
        got = getattr(port, name).cpu().numpy()
        assert got.shape == want.shape, name
        assert np.array_equal(got, want), name
    for name in META:
        assert getattr(port, name) == getattr(ref, name), name
    # the port's own table, derived from the shared ones
    wide, _, stack = pack_wide(np.asarray(ref.bvh_pack),
                               np.asarray(ref.thr_pack), int(ref.n_nodes))
    assert np.array_equal(port.wide_pack.cpu().numpy().view(np.uint32),
                          wide.view(np.uint32))
    assert port.wide_stack == stack


def test_station_obj_tables_match():
    obj = os.path.join(FIXTURES, "station.obj")

    def build(cls, mat, load, **build_kw):
        b = cls(sun_enabled=True, sun_dir=(0.0, 1.0, 0.0), seed=1337,
                bvh_method="sbvh")
        b.add_mesh(load(obj, mat.lambertian((0.73, 0.73, 0.73)), 1.0))
        return b.build(**build_kw)

    port = build(SceneBuilder, Material, load_obj, device="cpu")
    ref = build(JSceneBuilder, JMaterial, jload_obj)
    assert port.has_image_tex and port.n_tris == 21
    assert_same_tables(port, ref)


def test_native_sbvh_is_bit_identical_to_the_jax_package():
    """The port's own build of csrc/bvh_builder.cpp against the JAX
    package's library: the same SBVH node for node, and the stand-in's
    four walk tables bit for bit."""
    assert tnative.available() and jnative.available()
    mesh = jmesh.iss_standin_mesh(2)
    a = jnative.build_bvh(mesh.v0, mesh.v1, mesh.v2, "sbvh")
    b = tnative.build_bvh(mesh.v0, mesh.v1, mesh.v2, "sbvh")
    for f in ("bbox_min", "bbox_max", "left", "right", "tri_offset",
              "tri_count", "tri_indices"):
        np.testing.assert_array_equal(getattr(b, f), getattr(a, f))
    port = tmesh.iss_standin_scene(detail=2, device="cpu")
    ref = jmesh.iss_standin_scene(detail=2)
    for name in ("bvh_pack", "thr_pack", "tri_pack", "tri_shade"):
        want = np.asarray(getattr(ref, name))
        got = getattr(port, name).numpy()
        assert got.shape == want.shape, name
        assert np.array_equal(got.view(np.uint32), want.view(np.uint32)), name


def test_native_builder_without_gxx_falls_back_to_numpy(monkeypatch,
                                                         tmp_path):
    monkeypatch.setattr(tnative, "_LIB", None)
    monkeypatch.setattr(tnative, "_TRIED", False)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path)
    monkeypatch.delenv("CXX", raising=False)
    monkeypatch.setattr(tnative.shutil, "which", lambda name: None)
    assert not tnative.available()
    assert not list(tmp_path.iterdir())
    mesh = jmesh.iss_standin_mesh(1)
    got = tbvh.build_bvh(mesh.v0, mesh.v1, mesh.v2, method="sah")
    want = tbvh.build_bvh(mesh.v0, mesh.v1, mesh.v2, method="sah",
                          prefer_native=False)
    for f in ("bbox_min", "left", "tri_count", "tri_indices"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))


def test_tri_soup_tables_match():
    assert_same_tables(tpresets.random_tri_soup_scene(n=200, device="cpu"),
                       jpresets.random_tri_soup_scene(n=200))


def test_single_triangle_tables_match():
    assert_same_tables(tpresets.single_triangle_scene(sun=False, device="cpu"),
                       jpresets.single_triangle_scene(sun=False))


def test_mixed_material_tables_match():
    port = mixed_material_scene(SceneBuilder, device="cpu")
    ref = mixed_material_scene(JSceneBuilder)
    kinds = set(port.mat_pack[:, 0].tolist())
    assert kinds == {0.0, 1.0, 2.0, 3.0}
    assert_same_tables(port, ref)


def test_textured_standin_tables_match(tmp_path):
    tex = str(tmp_path / "panel.png")
    tmesh.write_panel_texture(tex)
    port = tmesh.iss_standin_scene(detail=2, tex_path=tex, device="cpu")
    ref = jmesh.iss_standin_scene(detail=2, tex_path=tex)
    assert port.has_image_tex
    # bf16-quantized pool and packed bf16 UV lanes are part of the tables
    pool = port.tex_pool.numpy().view(np.uint32)
    assert (pool & 0xFFFF).max() == 0
    assert_same_tables(port, ref)
    # scene_from_reference carries the reference tables over unchanged
    assert_same_tables(scene_from_reference(ref, device="cpu"), ref)


@pytest.mark.parametrize("bvh_method", ["sah", "sbvh"])
def test_standin_scene_options_tables_match(tmp_path, bvh_method):
    """iss_standin_scene's JAX options (four wing maps, sun, seed, BVH
    method, SBVH split gate) reach the same tables as JAX's."""
    texs = []
    for k in range(4):
        texs.append(str(tmp_path / f"wing{k}.png"))
        tmesh.write_panel_texture(texs[-1], size=16 + 8 * k)
    kw = dict(detail=2, sun_dir=(-0.2, 0.9, 0.1),
              sun_radiance=(3.0, 2.0, 1.0), seed=7, bvh_method=bvh_method,
              sbvh_alpha=0.0, tex_paths=tuple(texs))
    port = tmesh.iss_standin_scene(**kw, device="cpu")
    ref = jmesh.iss_standin_scene(**kw)
    assert port.n_textures == 4 and port.seed == 7
    assert_same_tables(port, ref)
    if bvh_method == "sbvh":
        # the gate reached the builder: alpha 1 tries no spatial split
        unsplit = tmesh.iss_standin_scene(**dict(kw, sbvh_alpha=1.0),
                                          device="cpu")
        assert port.n_tris > unsplit.n_tris


def test_mixed_scene_options_reach_the_builder():
    kw = dict(detail=1, sun_dir=(0.1, -0.5, 0.8), seed=3, bvh_method="sbvh",
              sbvh_alpha=0.0)
    assert_same_tables(tmesh.iss_mixed_scene(**kw, device="cpu"),
                       jmesh.iss_mixed_scene(**kw))


@pytest.mark.slow
def test_flagship_scene_round_trip(tmp_path):
    """The flagship: textured detail-12 stand-in (51k triangles)."""
    tex = str(tmp_path / "panel.png")
    tmesh.write_panel_texture(tex)
    port = tmesh.iss_standin_scene(detail=12, tex_path=tex, device="cpu")
    ref = jmesh.iss_standin_scene(detail=12, tex_path=tex)
    assert port.n_tris > 50000
    assert_same_tables(port, ref)
    assert_same_tables(scene_from_reference(ref, device="cpu"), ref)


SPHERE_SCENES = {
    "rtiow": (lambda: tpresets.rtiow_smoke_scene(device="cpu"),
              jpresets.rtiow_smoke_scene),
    "sphere_light": (lambda: tpresets.sphere_light_scene(device="cpu"),
                     jpresets.sphere_light_scene),
    "volumetric": (lambda: tpresets.volumetric_scene(device="cpu"),
                   jpresets.volumetric_scene),
    "dof_motion": (lambda: tpresets.dof_motion_scene(sun=True, device="cpu"),
                   lambda: jdof_motion_scene(sun=True)),
    "env": (lambda: tpresets.env_sphere_scene(env_array(), 30.0, 1.5,
                                              device="cpu"),
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
    assert_same_tables(scene_from_reference(ref, device="cpu"), ref)


def test_sphere_scene_contents():
    vol = tpresets.volumetric_scene(device="cpu")
    assert (vol.n_media, vol.n_lights, vol.has_ptex) == (1, 1, True)
    assert vol.med_neg_inv_density.tolist() == [np.float32(-1.0 / 2.5)]
    dof = tpresets.dof_motion_scene(device="cpu")
    assert dof.has_moving and dof.n_lights == 1
    assert dof.light_idx.tolist() == [3]
    env = tpresets.env_sphere_scene(env_array(), 90.0, 2.0, device="cpu")
    assert env.has_env and not env.has_image_tex
    assert env.env_rotation == pytest.approx(np.pi / 2)
    assert not tpresets.rtiow_smoke_scene(device="cpu").has_env


def test_unported_primitives_raise():
    """Quads and boxes were the builder's last unported primitives; they
    now build (six quads a box), and the Scene keeps the quad tables."""
    b = SceneBuilder()
    m = Material.lambertian()
    b.add_quad((0, 0, 0), (1, 0, 0), (0, 1, 0), m)
    b.add_box((0, 0, 0), (1, 1, 1), m)
    s = b.build(device="cpu")
    assert s.n_quads == 7 and s.n_tris == 0
    assert s.quad_q.shape == (7, 3) and s.quad_mat.tolist() == [0] * 7
    assert not hasattr(SceneBuilder, "_queued")


def test_with_sun_swaps_only_the_sun():
    s = tpresets.single_triangle_scene(device="cpu")
    s2 = s.with_sun((0.0, 0.0, 1.0))
    assert s2.sun_dir.tolist() == [0.0, 0.0, 1.0]
    assert s2.tri_pack is s.tri_pack and s2.bvh_pack is s.bvh_pack
    s3 = s.to("cpu")
    assert torch.equal(s3.tri_pack, s.tri_pack)
