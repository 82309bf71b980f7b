"""The path kernel's wider scope, module by module, against the JAX
reference: quad, box, smooth-normal and area-light tables of the scene
compiler (bit-equal), the quad pass and the smooth-normal interpolation
on random rays, the quad-light sampler, the path kernel's parameter
packing and its routing bounds.

Inputs are numpy arrays made from a seed, handed to both sides; the JAX
side runs with jit disabled (op by op, no fused multiply-adds).
Tolerance: exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dsrt_tpu.ops.trace as jtrace
from dsrt_tpu.models import mesh_gen as jmesh
from dsrt_tpu.models import presets as jpresets
from dsrt_tpu.models.materials import Material as JMaterial
from dsrt_tpu.models.obj import load_obj as jload_obj
from dsrt_tpu.models.scene import SceneBuilder as JSceneBuilder
from dsrt_tpu.ops import shade as jshade
from dsrt_tpu_torch.config import RenderConfig
from dsrt_tpu_torch.models import feature_scenes as fs
from dsrt_tpu_torch.models import mesh_gen as tmesh
from dsrt_tpu_torch.models import presets as tpresets
from dsrt_tpu_torch.models.materials import Material
from dsrt_tpu_torch.models.obj import load_obj
from dsrt_tpu_torch.models.scene import SceneBuilder, scene_from_reference
from dsrt_tpu_torch.ops import path_kernel as pk
from dsrt_tpu_torch.ops import shade as tshade
from dsrt_tpu_torch.ops import trace as ttrace
from dsrt_tpu_torch.ops.camera import make_camera
from dsrt_tpu_torch.render import fused_kind, render_frame_fused
from test_torch_scene import assert_same_tables
from test_torch_sphere_ops import FIELDS, jax_empty_hit
from test_torch_textures import jv, tv

N = 4096
T_MIN, T_MAX = 1e-3, 1e9
CFG = RenderConfig(width=16, height=8, spp=1, max_depth=3)

SMOOTH_OBJ = """
v -1 -1 -2
v  1 -1 -2
v  0  1 -2
v  0.2 0.1 -2.6
vn -0.5 0 0.8660254
vn  0.5 0 0.8660254
vn  0   0.5 0.8660254
f 1//1 2//2 3//3
f 2//2 4 3//3
"""


def write_texture(tmp_path) -> str:
    path = str(tmp_path / "panel.png")
    tmesh.write_panel_texture(path, size=16)
    return path


def smooth_obj_scene(builder_cls, mat_cls, load, path, **build_kw):
    """The smooth OBJ twice: as loaded, and rotated, moved and flipped
    (the flip negates and swaps the vertex normals); one corner has no
    vn, so it takes the face normal."""
    b = builder_cls(sun_enabled=True, sun_dir=(0.2, -0.4, -1.0),
                    sun_radiance=(1.2, 1.2, 1.2))
    mesh = load(path, mat_cls.lambertian((0.7, 0.7, 0.7)), smooth=True)
    b.add_mesh(mesh)
    b.add_mesh(mesh, translate=(0.5, 0.2, -0.5), rotate_y_deg=30.0,
               flip_face=True)
    return b.build(**build_kw)


def quads_and_boxes(builder_cls, mat_cls, **build_kw):
    b = builder_cls(sun_enabled=True, seed=7)
    m = mat_cls.lambertian((0.5, 0.6, 0.7))
    b.add_triangle((-1, -1, -3), (1, -1, -3), (0, 1, -3), m)
    b.add_quad((-2, -1, -4), (4, 0, 0), (0, 3, 0), m)
    b.add_quad((0.3, -0.2, -2.5), (0.7, 0.1, 0.0), (0.0, 0.6, 0.2),
               mat_cls.diffuse_light((5.0, 4.0, 3.0)), flip_face=True)
    b.add_box((-0.8, -1.0, -2.9), (-0.2, -0.3, -2.2), mat_cls.metal(
        (0.8, 0.8, 0.8), fuzz=0.1))
    b.add_sphere((0.5, -0.6, -2.0), 0.3, mat_cls.diffuse_light((2, 2, 2)))
    return b.build(**build_kw)


def both(name, tmp_path):
    """(port scene, JAX scene) of a table case, each package's builder."""
    if name == "quads_boxes":
        return (quads_and_boxes(SceneBuilder, Material, device="cpu"),
                quads_and_boxes(JSceneBuilder, JMaterial))
    if name == "cornell_preset":
        return (tpresets.cornell_box_scene(device="cpu"),
                jpresets.cornell_box_scene())
    if name == "mixed_preset":
        return tpresets.mixed_scene(device="cpu"), jpresets.mixed_scene()
    if name == "smooth_obj":
        path = tmp_path / "smooth.obj"
        path.write_text(SMOOTH_OBJ)
        return (smooth_obj_scene(SceneBuilder, Material, load_obj, str(path),
                                 device="cpu"),
                smooth_obj_scene(JSceneBuilder, JMaterial, jload_obj,
                                 str(path)))
    if name == "volumetric_mesh":
        return (fs.volumetric_mesh(SceneBuilder, Material,
                                   standin_mesh=tmesh.iss_standin_mesh,
                                   detail=1).build(device="cpu"),
                fs.volumetric_mesh(JSceneBuilder, JMaterial,
                                   standin_mesh=jmesh.iss_standin_mesh,
                                   detail=1).build())
    fn = fs.CASES[name][0]
    tex = write_texture(tmp_path)
    return (fn(SceneBuilder, Material, tex_path=tex).build(device="cpu"),
            fn(JSceneBuilder, JMaterial, tex_path=tex).build())


TABLE_CASES = (["quads_boxes", "cornell_preset", "mixed_preset",
                "smooth_obj", "volumetric_mesh"] + list(fs.CASES))


@pytest.mark.parametrize("name", TABLE_CASES)
def test_scene_tables_match(name, tmp_path):
    """Every table (quads, light kinds, tri_aux, materials, walk tables)
    bit-equal to the JAX builder's, and scene_from_reference carries the
    JAX scene over unchanged."""
    port, ref = both(name, tmp_path)
    assert_same_tables(port, ref)
    assert_same_tables(scene_from_reference(ref, device="cpu"), ref)


def test_scene_contents(tmp_path):
    s = quads_and_boxes(SceneBuilder, Material, device="cpu")
    assert (s.n_tris, s.n_quads, s.n_spheres) == (1, 8, 1)
    # spheres first, then quads, in the light list
    assert s.light_kind.tolist() == [0, 1] and s.light_idx.tolist() == [0, 1]
    # material rows in insertion order: triangles, spheres, quads
    assert s.sph_mat.tolist() == [1] and s.quad_mat.tolist()[:2] == [0, 2]
    # the flipped quad's normal is -(u x v)/|u x v| of the given edges
    cr = np.cross([0.7, 0.1, 0.0], [0.0, 0.6, 0.2])
    np.testing.assert_allclose(s.quad_n[1].numpy(), -cr / np.linalg.norm(cr),
                               rtol=1e-6)
    path = tmp_path / "smooth.obj"
    path.write_text(SMOOTH_OBJ)
    sm = smooth_obj_scene(SceneBuilder, Material, load_obj, str(path),
                          device="cpu")
    assert sm.has_smooth and sm.n_tris == 4
    assert sm.tri_aux.shape == sm.tri_pack.shape
    flat = tpresets.single_triangle_scene(device="cpu")
    assert not flat.has_smooth
    np.testing.assert_array_equal(flat.tri_aux[0, 0:3].numpy(),
                                  flat.tri_shade[0, 0:3].numpy())
    cb = tpresets.cornell_box_scene(device="cpu")
    assert cb.n_tris == 0 and cb.n_quads == 18 and cb.n_lights == 1


def _rays(seed, lo, hi, targets):
    rng = np.random.default_rng(seed)
    o = rng.uniform(lo, hi, (N, 3)).T
    tgt = targets[rng.integers(0, len(targets), N)].T
    d = tgt + rng.normal(scale=0.3, size=(3, N)) - o
    d[:, : N // 8] = rng.normal(size=(3, N // 8))
    d *= rng.uniform(0.5, 2.0, N)
    act = rng.random(N) < 0.9
    return o.astype(np.float32), d.astype(np.float32), act


def test_quad_pass_matches_reference_exactly():
    js = jpresets.cornell_box_scene()
    ts = tpresets.cornell_box_scene(device="cpu")
    targets = np.array([[0.5, 0.5, 0.5], [0.3, 0.3, 0.25], [0.7, 0.15, 0.65],
                        [0.5, 1.0, 0.5]])
    o, d, act = _rays(31, [0.05, 0.05, -1.0], [0.95, 0.95, 0.95], targets)
    with jax.disable_jit():
        want = jtrace.quad_pass(js, jv(o), jv(d), T_MIN, jax_empty_hit(),
                                jnp.asarray(act))
    got = ttrace.quad_pass(ts, tv(o), tv(d), T_MIN,
                           ttrace.empty_hit((N,), T_MAX, torch.device("cpu")),
                           torch.from_numpy(act))
    assert 0.5 < float(got.hit.float().mean()) < 0.95
    for f in FIELDS + ("u", "v", "tu", "tv", "tex", "tri"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)


def test_smooth_normals_match_reference_exactly():
    """The walk's winner on a smooth mesh: the port's walk plus
    smooth_normals against JAX scene_hit_flat_lane (which blends the
    vertex normals the same way), spheres after it."""
    mesh = fs.uv_sphere_mesh(Material, (0.0, 0.0, -2.0), 0.8)
    jmesh_ = fs.uv_sphere_mesh(JMaterial, (0.0, 0.0, -2.0), 0.8)

    def build(cls, m, mat_cls, **kw):
        b = cls(sun_enabled=False)
        b.add_mesh(m)
        b.add_sphere((0.6, 0.6, -1.5), 0.3, mat_cls.lambertian())
        return b.build(**kw)

    ts = build(SceneBuilder, mesh, Material, device="cpu")
    js = build(JSceneBuilder, jmesh_, JMaterial)
    assert ts.has_smooth and js.has_smooth
    o, d, act = _rays(41, [-2.0, -2.0, 0.5], [2.0, 2.0, 2.0],
                      np.array([[0.0, 0.0, -2.0], [0.6, 0.6, -1.5]]))
    with jax.disable_jit():
        want, _ = jtrace.scene_hit_flat_lane(js, jv(o), jv(d), T_MIN, T_MAX,
                                             jnp.asarray(act))
    got, _ = ttrace.scene_hit(ts, tv(o), tv(d), T_MIN, T_MAX,
                              torch.from_numpy(act), None)
    tri_hit = got.tri >= 0
    assert 0.3 < float(tri_hit.float().mean()) < 0.9
    for f in FIELDS + ("tri", "u", "v"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)
    # the shading normal is not the face normal
    flat = ttrace.hit_from_kernel(ts, tv(o), tv(d), got.t, got.u, got.v,
                                  got.tri, T_MAX)
    assert (flat.nx != got.nx)[tri_hit].float().mean() > 0.5


def test_quad_light_sampler_matches_reference_exactly():
    rng = np.random.default_rng(51)
    n = N

    def vec(scale=1.0, shift=0.0):
        return (rng.normal(size=(3, n)) * scale + shift).astype(np.float32)

    q, eu, ev = vec(0.5), vec(0.6), vec(0.6)
    qn = np.cross(eu.T, ev.T).T
    area = np.linalg.norm(qn, axis=0).astype(np.float32)
    qn = (qn / area).astype(np.float32)
    area[: n // 16] = 0.0
    origin = vec(1.5)
    origin[:, n // 16: n // 8] = q[:, n // 16: n // 8]   # on the light
    u1, u2 = (rng.random(n).astype(np.float32) for _ in range(2))
    with jax.disable_jit():
        wi_j, pdf_j = jshade.quad_light_from_uniforms(
            jv(q), jv(eu), jv(ev), jv(qn), jnp.asarray(area), jv(origin),
            jnp.asarray(u1), jnp.asarray(u2))
    wi_t, pdf_t = tshade.quad_light_from_uniforms(
        tv(q), tv(eu), tv(ev), tv(qn), torch.from_numpy(area), tv(origin),
        torch.from_numpy(u1), torch.from_numpy(u2))
    assert 0.5 < float((pdf_t > 0).float().mean()) < 0.99
    for g, w in zip(list(wi_t) + [pdf_t], list(wi_j) + [pdf_j]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_parameter_packing_and_instances(tmp_path):
    s = quads_and_boxes(SceneBuilder, Material, device="cpu")
    p = pk.pack_params(s)
    assert p.shape == (pk.PARAM_LEN,) and p.dtype == torch.float32
    assert pk.pack_params(s) is p                       # once per scene
    assert pk.pack_params(s.with_sun((0.0, 0.0, 1.0))) is p
    assert pk.pack_params(s.to("cpu")) is not p         # a copy repacks
    sph = p[:8 * pk.MAX_SPH].reshape(pk.MAX_SPH, 8)
    quad = p[8 * pk.MAX_SPH:8 * pk.MAX_SPH + 18 * pk.MAX_QUADS].reshape(
        pk.MAX_QUADS, 18)
    lit = p[8 * pk.MAX_SPH + 18 * pk.MAX_QUADS:][:2 * pk.MAX_LIGHTS]
    np.testing.assert_array_equal(sph[0, :5].numpy(),
                                  np.float32([0.5, -0.6, -2.0, 0.3, 1.0]))
    assert torch.equal(quad[1, 9:12], s.quad_n[1])
    assert torch.equal(quad[1, 12:15], s.quad_w[1])
    assert quad[1, 15] == s.quad_d[1] and quad[1, 17] == s.quad_area[1]
    assert lit[:4].tolist() == [0.0, 0.0, 1.0, 1.0]
    assert not quad[s.n_quads:].any() and not sph[1:].any()
    cfg = RenderConfig(width=8, height=4)
    assert pk.instance_of(tpresets.single_triangle_scene(device="cpu"),
                          cfg) == 0
    assert pk.instance_of(s, cfg) == pk.K_PRIMS | pk.K_LIGHTS
    shut = dataclasses.replace(cfg, time0=0.0, time1=1.0)
    assert pk.instance_of(s, shut) == pk.K_PRIMS | pk.K_LIGHTS | pk.K_EXTRA
    assert pk.flags_of(s, shut) == pk.SUN_ON | pk.SHUTTER
    vm = fs.volumetric_mesh(SceneBuilder, Material,
                            standin_mesh=tmesh.iss_standin_mesh,
                            detail=1).build(device="cpu")
    assert pk.instance_of(vm, cfg) == pk.K_MEDIA


def _over(kind):
    """The sphere-mix scene with one primitive past a path-kernel bound."""
    b = fs.sphere_mix(SceneBuilder, Material)
    if kind == "spheres":
        for i in range(pk.MAX_SPH - 3 + 1):
            b.add_sphere((0.1 * i, 2.0, -3.0), 0.05, Material.lambertian())
    elif kind == "quads":
        for i in range(pk.MAX_QUADS + 1):
            b.add_quad((0.1 * i, 2.0, -3.0), (0.05, 0, 0), (0, 0.05, 0),
                       Material.lambertian())
    elif kind == "lights":
        for i in range(pk.MAX_LIGHTS + 1):
            b.add_quad((0.1 * i, 2.0, -3.0), (0.05, 0, 0), (0, 0.05, 0),
                       Material.diffuse_light((1, 1, 1)))
    else:
        for i in range(pk.MAX_MED + 1):
            b.add_constant_medium_sphere((0.1 * i, 2.0, -3.0), 0.05, 1.0,
                                         (0.5, 0.5, 0.5))
    return b.build(device="cpu")


@pytest.mark.parametrize("kind", ["spheres", "quads", "lights", "media"])
def test_routing_bounds(kind):
    """Every feature case routes to the path kernel; one past each bound
    (13 spheres, 25 quads, 9 lights, 5 media) routes nowhere and the
    fused entry raises."""
    for name, (fn, *_rest, extra) in fs.CASES.items():
        scene = fn(SceneBuilder, Material).build(device="cpu")
        assert fused_kind(scene, RenderConfig(width=8, height=4,
                                              **extra)) == "tri", name
    assert fused_kind(tpresets.cornell_box_scene(device="cpu"), CFG) == "tri"
    assert fused_kind(tpresets.mixed_scene(device="cpu"), CFG) == "tri"
    at = fs.sphere_mix(SceneBuilder, Material)
    for i in range(pk.MAX_SPH - 3):
        at.add_sphere((0.1 * i, 2.0, -3.0), 0.05, Material.lambertian())
    assert fused_kind(at.build(device="cpu"), CFG) == "tri"
    over = _over(kind)
    assert fused_kind(over, CFG) is None
    assert pk.scope_error(over, CFG) is not None
    cam = make_camera((0, 0, 1.0), (0, 0, -2), vfov=50, width=16, height=8,
                      device="cpu")
    with pytest.raises(NotImplementedError):
        render_frame_fused(over, cam, CFG)
    with pytest.raises((ValueError, RuntimeError, NotImplementedError)):
        pk.path_render(over.to("meta"), cam, CFG)
    assert pk.LAUNCHES["dsrt_path_render"] == 0
