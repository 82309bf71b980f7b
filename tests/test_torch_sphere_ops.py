"""dsrt_tpu_torch sphere-scene modules against the JAX reference: the
sphere pass (static and moving centres), the constant-medium pass (its
draws and its hits), the thin-lens raygen and the sphere-light sampler.

Inputs are numpy arrays made from a seed, handed to both sides; the JAX
side runs with jit disabled (op by op, no fused multiply-adds).
Tolerance: exact, with two stated exceptions.  The medium's free path
takes a log, which the port takes in float64 and rounds once (the kernel
too) and XLA-CPU takes in float32: the hit verdicts and the draws are
held exactly, the hit distances within 2 ulp (measured: 47 of 4,096
lanes differ, by at most 2 ulp).  The sphere-light sampler takes cos and
sin the same way: it is held exactly with the reference's cos and sin
taken in float64 too, and within the bounds its test states without.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dsrt_tpu.ops.trace as jtrace
from dsrt_tpu.models import presets as jpresets
from dsrt_tpu.models.materials import Material
from dsrt_tpu.models.scene import SceneBuilder as JSceneBuilder
from dsrt_tpu.ops import camera as jcam
from dsrt_tpu.ops import rng as jrng
from dsrt_tpu.ops import shade as jshade
from dsrt_tpu_torch.models import presets as tpresets
from dsrt_tpu_torch.models.scene import SceneBuilder
from dsrt_tpu_torch.ops import camera as tcam
from dsrt_tpu_torch.ops import rng as trng
from dsrt_tpu_torch.ops import shade as tshade
from dsrt_tpu_torch.ops import trace as ttrace
from test_fused_spheres import _dof_motion_scene as jdof_motion_scene
from test_torch_rng_camera import _ulp_diff as ulp_diff
from test_torch_textures import jv, tv

N = 4096
T_MIN, T_MAX = 1e-3, 1e9


def rays_at(scene_centres, seed):
    """Origins around the scene; 3/4 of the rays aimed at a sphere."""
    rng = np.random.default_rng(seed)
    o = rng.uniform([-2.0, -0.3, -3.0], [2.0, 2.5, 2.0], (N, 3)).T
    tgt = scene_centres[rng.integers(0, len(scene_centres), N)].T
    tgt = tgt + rng.normal(scale=0.4, size=(3, N))
    d = tgt - o
    d[:, : N // 4] = rng.normal(size=(3, N // 4))
    d *= rng.uniform(0.5, 2.0, N)          # not unit length
    act = rng.random(N) < 0.85
    return o.astype(np.float32), d.astype(np.float32), act


def states(seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2 ** 32, N, dtype=np.uint64).astype(np.uint32)


def jax_empty_hit():
    f0 = jnp.zeros(N, jnp.float32)
    none = jnp.full(N, -1, jnp.int32)
    return jtrace.Hit(hit=jnp.zeros(N, bool),
                      t=jnp.full(N, T_MAX, jnp.float32), nx=f0, ny=f0,
                      nz=f0, front=jnp.zeros(N, bool),
                      mat=jnp.zeros(N, jnp.int32), tex=none, tri=none,
                      u=f0, v=f0, tu=f0, tv=f0, medium=none)


FIELDS = ("hit", "t", "nx", "ny", "nz", "front", "mat", "medium")


@pytest.mark.parametrize("moving", [False, True], ids=["static", "moving"])
def test_sphere_pass_matches_reference_exactly(moving):
    js = (jdof_motion_scene(sun=True) if moving
          else jpresets.rtiow_smoke_scene())
    ts = (tpresets.dof_motion_scene(sun=True, device="cpu") if moving
          else tpresets.rtiow_smoke_scene(device="cpu"))
    assert ts.has_moving == moving
    o, d, act = rays_at(ts.sph_center.numpy()[1:], 11)
    tm = np.random.default_rng(12).uniform(0.2, 0.8, N).astype(np.float32)
    with jax.disable_jit():
        want = jtrace.sphere_pass(js, jv(o), jv(d), T_MIN, jax_empty_hit(),
                                  jnp.asarray(act),
                                  time=jnp.asarray(tm) if moving else None)
    got = ttrace.sphere_pass(
        ts, tv(o), tv(d), T_MIN,
        ttrace.empty_hit((N,), T_MAX, torch.device("cpu")),
        torch.from_numpy(act), time=torch.from_numpy(tm) if moving else None)
    assert 0.3 < float(got.hit.float().mean()) < 0.95
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)


def _media_scene(builder_cls, **build_kw):
    """A sphere medium and a box medium around two surfaces."""
    b = builder_cls(sun_enabled=True, seed=1337)
    b.add_sphere((0.0, -100.5, -1.0), 100.0, Material.lambertian())
    b.add_sphere((0.6, 0.0, -1.0), 0.4, Material.metal((0.8, 0.8, 0.8)))
    b.add_constant_medium_sphere((-0.7, 0.1, -1.0), 0.6, density=2.5,
                                 albedo=(0.8, 0.85, 0.9))
    b.add_constant_medium_box((-0.2, -0.5, -2.0), (1.2, 0.8, -0.5),
                              density=0.7, albedo=(0.5, 0.6, 0.7))
    return b.build(**build_kw)


def test_media_pass_draws_and_hits_match_reference():
    js = _media_scene(JSceneBuilder)
    ts = _media_scene(SceneBuilder, device="cpu")
    assert ts.n_media == 2
    o, d, act = rays_at(np.array([[-0.7, 0.1, -1.0], [0.5, 0.15, -1.25]]),
                        21)
    st = states(22)
    with jax.disable_jit():
        h0 = jtrace.sphere_pass(js, jv(o), jv(d), T_MIN, jax_empty_hit(),
                                jnp.asarray(act))
        want, jst = jtrace.media_pass(js, jv(o), jv(d), T_MIN, h0,
                                      jnp.asarray(act), jnp.asarray(st))
    th0 = ttrace.sphere_pass(ts, tv(o), tv(d), T_MIN,
                             ttrace.empty_hit((N,), T_MAX,
                                              torch.device("cpu")),
                             torch.from_numpy(act))
    got, tst = ttrace.media_pass(ts, tv(o), tv(d), T_MIN, th0,
                                 torch.from_numpy(act),
                                 torch.from_numpy(st.astype(np.int64)))
    # one draw per medium on every active lane
    np.testing.assert_array_equal(tst.numpy().astype(np.uint32),
                                  np.asarray(jst))
    med = got.medium.numpy()
    assert (med == 0).sum() > 50 and (med == 1).sum() > 50
    for f in ("hit", "front", "mat", "medium", "nx", "ny", "nz"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)
    assert ulp_diff(got.t.numpy(), np.asarray(want.t)).max() <= 2


def test_thin_lens_raygen_matches_reference_exactly():
    rng = np.random.default_rng(31)
    w, h = 64, 36
    px = rng.integers(0, w, N).astype(np.int32)
    py = rng.integers(0, h, N).astype(np.int32)
    jx, jy = rng.random((2, N)).astype(np.float32)
    st = states(32)
    mask = rng.random(N) < 0.7
    kw = dict(vfov=60, width=w, height=h, aperture=0.2)
    jc = jcam.make_camera((0, 0.4, 1.2), (0, 0, -1), **kw)
    tc = tcam.make_camera((0, 0.4, 1.2), (0, 0, -1), **kw, device="cpu")
    with jax.disable_jit():
        jo, jd, jst = jcam.generate_rays_dof(
            jc, jnp.asarray(px), jnp.asarray(py), jnp.asarray(jx),
            jnp.asarray(jy), jnp.asarray(st), jnp.asarray(mask))
    to, td, tst = tcam.camera_rays(
        tc, torch.from_numpy(px), torch.from_numpy(py), torch.from_numpy(jx),
        torch.from_numpy(jy), torch.from_numpy(st.astype(np.int64)),
        torch.from_numpy(mask), aperture_on=True)
    # 2 draws per disk attempt, on the masked lanes only
    np.testing.assert_array_equal(tst.numpy().astype(np.uint32),
                                  np.asarray(jst))
    assert (tst.numpy().astype(np.uint32) == st)[~mask].all()
    for a, b in zip(list(to) + list(td), list(jo) + list(jd)):
        np.testing.assert_array_equal(a.numpy()[mask], np.asarray(b)[mask])


def test_random_unit_vector_matches_reference_exactly():
    st = states(41)
    mask = np.random.default_rng(42).random(N) < 0.5
    with jax.disable_jit():
        jd, jst = jrng.random_unit_vector(jnp.asarray(st), jnp.asarray(mask))
    td, tst = trng.random_unit_vector(torch.from_numpy(st.astype(np.int64)),
                                      torch.from_numpy(mask))
    np.testing.assert_array_equal(tst.numpy().astype(np.uint32),
                                  np.asarray(jst))
    for a, b in zip(td, jd):
        np.testing.assert_array_equal(a.numpy()[mask], np.asarray(b)[mask])


class _Float64Trig:
    """jax.numpy with cos and sin taken in float64 and rounded once, as
    the port takes them (concrete arrays only: jit is disabled)."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    @staticmethod
    def cos(x):
        return jnp.asarray(np.cos(np.asarray(x, np.float64)), jnp.float32)

    @staticmethod
    def sin(x):
        return jnp.asarray(np.sin(np.asarray(x, np.float64)), jnp.float32)


def _light_inputs():
    rng = np.random.default_rng(51)
    c = rng.uniform(-1.0, 1.0, (3, N)).astype(np.float32)
    c[1] += 2.2
    r = rng.uniform(0.2, 0.9, N).astype(np.float32)
    origin = rng.uniform(-1.0, 1.0, (3, N)).astype(np.float32)
    uz, uphi = rng.random((2, N)).astype(np.float32)
    return c, r, origin, uz, uphi


def _light_samples():
    c, r, origin, uz, uphi = _light_inputs()
    with jax.disable_jit():
        jwi, jpdf = jshade.sphere_light_from_uniforms(
            jv(c), jnp.asarray(r), jv(origin), jnp.asarray(uz),
            jnp.asarray(uphi))
    twi, tpdf = tshade.sphere_light_from_uniforms(
        tv(c), torch.from_numpy(r), tv(origin), torch.from_numpy(uz),
        torch.from_numpy(uphi))
    return ([a.numpy() for a in twi] + [tpdf.numpy()],
            [np.asarray(b) for b in jwi] + [np.asarray(jpdf)])


def test_sphere_light_sample_exact_with_the_same_cos_and_sin(monkeypatch):
    """Everything but cos and sin, the reciprocal-multiply normalisation
    included, is the reference's arithmetic."""
    monkeypatch.setattr(jshade, "jnp", _Float64Trig())
    got, want = _light_samples()
    assert (got[3] > 0).mean() > 0.3
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_sphere_light_sample_within_2ulp():
    """Against the reference as it is: XLA-CPU's float32 cos and sin are
    within 1 ulp of the correctly rounded values the port uses, which
    moves each direction component by at most 2 ulp of the unit vector's
    length (2^-23 absolute; a component near zero, where the difference
    p_light - origin cancels, can differ by more ulps of its own: measured
    56 on a component of 0.015) and the pdf by at most 2^-20 relative
    (measured: 13 of 4,096 x components differ, max |d| 6e-8; pdf max
    relative 7.7e-7)."""
    got, want = _light_samples()
    assert ((got[3] > 0) == (want[3] > 0)).all()
    for a, b in zip(got[:3], want[:3]):
        assert np.abs(a - b).max() <= 2.0 ** -23
    rel = np.abs(got[3] - want[3]) / np.maximum(np.abs(want[3]), 1e-30)
    assert rel.max() <= 2.0 ** -20
