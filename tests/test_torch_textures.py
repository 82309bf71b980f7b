"""dsrt_tpu_torch texture evaluation against dsrt_tpu/ops/textures.py:
the polynomial atan2/acos, the equirect sky, the integer-hash Perlin and
the checker / marble / noise procedural albedo.

Inputs are numpy arrays made from a seed and handed to both sides; the
JAX side runs with jit disabled (op by op, so XLA-CPU cannot contract
a*b+c into fused multiply-adds).  Tolerance: exact, except where a value
goes through sin: the port takes sin in float64 and rounds once (the
kernel does the same), while XLA-CPU's float32 sin is not correctly
rounded, so the marble albedo 0.5 (1 + sin) may differ by the rounding
of sin: at most 2^-23 absolute, one ulp of sin at its largest (measured:
34 of 6,000 marble lanes differ, by at most 6e-8).  The checker
verdict only reads the sign of the sines and is held exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsrt_tpu.models import presets as jpresets
from dsrt_tpu.models.materials import Material
from dsrt_tpu.models.scene import SceneBuilder as JSceneBuilder
from dsrt_tpu.ops import textures as jtex
from dsrt_tpu.ops.linalg import V3 as JV3
from dsrt_tpu_torch.models import presets as tpresets
from dsrt_tpu_torch.models.scene import SceneBuilder
from dsrt_tpu_torch.ops import textures as ttex
from dsrt_tpu_torch.ops.linalg import V3

RNG = np.random.default_rng(20261016)


def jv(a):
    return JV3(*(jnp.asarray(c) for c in a))


def tv(a):
    return V3(*(torch.from_numpy(np.ascontiguousarray(c)) for c in a))


def close_after_sin(got, want):
    """Within the rounding of a float32 sin of magnitude <= 1."""
    d = np.abs(np.asarray(got) - np.asarray(want))
    assert d.size == 0 or d.max() <= 2.0 ** -23, d.max()


def same(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    bad = got != want
    assert not bad.any(), (f"{bad.sum()} of {bad.size} differ, max |d| "
                           f"{np.abs(got - want).max()}")


def test_atan2_and_acos_polynomials_match_reference():
    y, x = RNG.uniform(-5.0, 5.0, (2, 20000)).astype(np.float32)
    # axes, zeros, equal magnitudes and signed zeros: the quadrant fix-up
    edge = np.array([0.0, -0.0, 1.0, -1.0, 2.5, -2.5, 1e-30, -3e-8],
                    np.float32)
    y = np.concatenate([y, np.repeat(edge, edge.size)])
    x = np.concatenate([x, np.tile(edge, edge.size)])
    c = RNG.uniform(-1.0, 1.0, 20000).astype(np.float32)
    c = np.concatenate([c, np.array([-1.0, 1.0, 0.0, -0.0], np.float32)])
    with jax.disable_jit():
        want_a = jtex.atan2f(jnp.asarray(y), jnp.asarray(x))
        want_c = jtex.acosf(jnp.asarray(c))
    same(ttex.atan2f(torch.from_numpy(y), torch.from_numpy(x)), want_a)
    same(ttex.acosf(torch.from_numpy(c)), want_c)


def test_lattice_hash_matches_reference():
    ijk = RNG.integers(-2 ** 20, 2 ** 20, (3, 5000)).astype(np.int32)
    with jax.disable_jit():
        want = jtex._hash3(*(jnp.asarray(c) for c in ijk))
    got = ttex.hash3(*(torch.from_numpy(c.astype(np.int64)) for c in ijk))
    same(got, np.asarray(want).astype(np.int64))


@pytest.mark.parametrize("span", [1.0, 40.0])
def test_perlin_noise_and_turbulence_match_reference(span):
    p = RNG.uniform(-span, span, (3, 4000)).astype(np.float32)
    with jax.disable_jit():
        want_n = jtex.perlin_noise(None, jv(p))
        want_t = jtex.perlin_turb(None, jv(p))
    same(ttex.perlin_noise(tv(p)), want_n)
    same(ttex.perlin_turb(tv(p)), want_t)


def _ptex_scene(builder_cls):
    """All three procedural kinds and a solid colour."""
    b = builder_cls(sun_enabled=False, seed=1337)
    b.add_sphere((0.0, -100.5, -1.0), 100.0,
                 Material.checker((0.2, 0.3, 0.1), (0.9, 0.9, 0.9),
                                  scale=4.0))
    b.add_sphere((0.7, 0.0, -1.1), 0.5, Material.marble(scale=2.0))
    b.add_sphere((-0.7, 0.0, -1.1), 0.5, Material.noise(scale=3.0))
    b.add_sphere((0.0, 1.0, -1.0), 0.3, Material.lambertian((0.5, 0.4, 0.3)))
    return b.build()


def test_procedural_albedo_matches_reference():
    js, ts = _ptex_scene(JSceneBuilder), _ptex_scene(SceneBuilder)
    n = 6000
    mat = RNG.integers(0, ts.mat_pack.shape[0], n).astype(np.int32)
    base = RNG.uniform(0.0, 1.0, (3, n)).astype(np.float32)
    p = RNG.uniform(-3.0, 3.0, (3, n)).astype(np.float32)
    mask = RNG.random(n) < 0.8
    with jax.disable_jit():
        want = jtex.sample_procedural(js, jnp.asarray(mat), jv(base), jv(p),
                                      mask=jnp.asarray(mask))
    got = ttex.sample_procedural(ts, torch.from_numpy(mat.astype(np.int64)),
                                 tv(base), tv(p),
                                 mask=torch.from_numpy(mask))
    kinds = ts.mat_pack[:, 9][torch.from_numpy(mat.astype(np.int64))]
    assert set(kinds.tolist()) == {0.0, 1.0, 2.0, 3.0}
    kinds = kinds.numpy()
    marble = kinds == 3
    # lanes outside the mask never read the turbulence
    keep = (mask | (kinds == 0) | (kinds == 1)) & ~marble
    for g, w in zip(got, want):
        same(g.numpy()[keep], np.asarray(w)[keep])
        close_after_sin(g.numpy()[mask & marble],
                        np.asarray(w)[mask & marble])


def test_volumetric_preset_procedural_albedo_matches_reference():
    js, ts = jpresets.volumetric_scene(), tpresets.volumetric_scene()
    n = 3000
    mat = RNG.integers(0, ts.mat_pack.shape[0], n).astype(np.int32)
    base = RNG.uniform(0.0, 1.0, (3, n)).astype(np.float32)
    p = RNG.uniform(-2.0, 2.0, (3, n)).astype(np.float32)
    with jax.disable_jit():
        want = jtex.sample_procedural(js, jnp.asarray(mat), jv(base), jv(p))
    got = ttex.sample_procedural(ts, torch.from_numpy(mat.astype(np.int64)),
                                 tv(base), tv(p))
    marble = (ts.mat_pack[:, 9].numpy() == 3)[mat]
    assert marble.any() and (~marble).any()
    for g, w in zip(got, want):
        same(g.numpy()[~marble], np.asarray(w)[~marble])
        close_after_sin(g.numpy()[marble], np.asarray(w)[marble])


@pytest.mark.parametrize("rotation_deg,scale", [(0.0, 1.0), (75.0, 2.5)])
def test_environment_sky_matches_reference(rotation_deg, scale):
    env = RNG.uniform(0.0, 3.0, (16, 32, 3)).astype(np.float32)
    b = JSceneBuilder(sun_enabled=False, seed=1337)
    b.add_sphere((0.0, 0.0, -2.0), 0.5, Material.lambertian())
    b.set_environment(env, rotation_deg=rotation_deg, scale=scale)
    js = b.build()
    ts = tpresets.env_sphere_scene(env, rotation_deg=rotation_deg,
                                   scale=scale)
    # directions of any length, the poles and the seam included
    d = RNG.normal(size=(3, 20000)).astype(np.float32)
    d *= RNG.uniform(0.1, 10.0, 20000).astype(np.float32)
    axes = np.array([[0, 0, 1, -1, 1, -1], [1, -1, 0, 0, 0, 0],
                     [0, 0, 0, 0, 1e-7, -1e-7]], np.float32)
    d = np.concatenate([d, axes], axis=1)
    with jax.disable_jit():
        want = jtex.sample_env(js, jv(d))
    got = ttex.sample_env(ts, tv(d))
    assert float(got.x.max()) > 0
    for g, w in zip(got, want):
        same(g, w)
