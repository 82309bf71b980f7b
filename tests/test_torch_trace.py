"""dsrt_tpu_torch plain BVH walk and hit assembly against the JAX reference
(dsrt_tpu.ops.trace.lane_traverse / hit_from_kernel).

The JAX side runs op by op (jit disabled): jitted, XLA-CPU contracts the
Moller-Trumbore dot products into fused multiply-adds, which neither the
port nor its CUDA kernel (built with -fmad=false) performs.  Op by op the
two must agree exactly in (t, u, v, tri).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dsrt_tpu.ops.trace as jtrace
from dsrt_tpu.models.mesh_gen import iss_standin_scene as jscene
from dsrt_tpu.models.presets import random_tri_soup_scene as jsoup
from dsrt_tpu.ops.linalg import V3 as JV3
from dsrt_tpu_torch.models.scene import scene_from_reference
from dsrt_tpu_torch.ops import traverse
from dsrt_tpu_torch.ops.linalg import V3
from dsrt_tpu_torch.ops.trace import hit_from_kernel, lane_traverse

N = 4096
SCENES = {"soup": (lambda: jsoup(n=256), 1.5),
          "standin3": (lambda: jscene(detail=3), 40.0)}
_cache = {}


def _scene(name):
    if name not in _cache:
        make, scale = SCENES[name]
        _cache[name] = (make(), scale)
    return _cache[name]


def _rays(scale, seed=5):
    """Half the rays aimed into the scene, half in random directions."""
    rng = np.random.default_rng(seed)
    o = rng.normal(scale=scale, size=(3, N)).astype(np.float32)
    tgt = rng.normal(scale=scale * 0.3, size=(3, N // 2)).astype(np.float32)
    if scale < 2:
        o[2] += 2.0
        tgt[2] -= 3.0
    d = rng.normal(size=(3, N)).astype(np.float32)
    d[:, : N // 2] = tgt - o[:, : N // 2]
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    return o, d


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
@pytest.mark.parametrize("name", ["soup", "standin3"])
def test_walk_matches_reference_exactly(name, any_hit):
    js, scale = _scene(name)
    o, d = _rays(scale)
    act = np.ones(N, bool)
    act[::7] = False
    with jax.disable_jit():
        want = jtrace.lane_traverse(js, JV3(*map(jnp.asarray, o)),
                                    JV3(*map(jnp.asarray, d)), 1e-3, 1e9,
                                    jnp.asarray(act), any_hit=any_hit)
    got = lane_traverse(scene_from_reference(js, device="cpu"),
                        V3(*map(torch.from_numpy, o)),
                        V3(*map(torch.from_numpy, d)), 1e-3, 1e9,
                        torch.from_numpy(act), any_hit=any_hit)
    hits = np.asarray(want[3]) >= 0
    assert 200 < hits.sum() < N
    assert not hits[~act].any()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_hit_assembly_matches_reference():
    js, scale = _scene("standin3")
    o, d = _rays(scale, seed=6)
    s = scene_from_reference(js, device="cpu")
    to, td = V3(*map(torch.from_numpy, o)), V3(*map(torch.from_numpy, d))
    t, u, v, tri = lane_traverse(s, to, td, 1e-3, 1e9,
                                 torch.ones(N, dtype=torch.bool))
    want = jtrace.hit_from_kernel(js, JV3(*map(jnp.asarray, o)),
                                  JV3(*map(jnp.asarray, d)),
                                  *(jnp.asarray(a.numpy()) for a in
                                    (t, u, v, tri)), 1e9)
    got = hit_from_kernel(s, to, td, t, u, v, tri, 1e9)
    assert got.hit.any()
    for f in got._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)


def test_closest_hit_wrapper_takes_plain_walk_on_cpu():
    js, scale = _scene("soup")
    o, d = _rays(scale, seed=8)
    s = scene_from_reference(js, device="cpu")
    before = dict(traverse.LAUNCHES)
    ro, rd = V3(*map(torch.from_numpy, o)), V3(*map(torch.from_numpy, d))
    act = torch.ones(N, dtype=torch.bool)
    got = traverse.traverse(s, ro, rd, act, 1e-3, 1e9)
    want = lane_traverse(s, ro, rd, 1e-3, 1e9, act)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert traverse.LAUNCHES == before   # no kernel launch on the CPU
