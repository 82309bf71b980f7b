"""The split pipeline's traversal (dsrt_tpu_torch/ops/traverse.py) against
the JAX reference: `traverse_plain` and `traverse_with_sun_plain` against
dsrt_tpu.ops.pallas_trace.traverse / traverse_with_sun run in interpret
mode, and against the JAX per-lane walk (dsrt_tpu.ops.trace.lane_traverse).

The rays are aimed into a soup of 2,100 triangles (above the JAX
package's 2,048-triangle packet-walk switch), about 10% of lanes
inactive.  Tolerance: exact in (t, u, v, tri) on closest hits, equal hit
masks on any-hit queries, `blocked` equal on hit lanes.  The TPU kernel
walks one octant per block and the port each ray's own, which changes
only the visit order; the exact agreement shows no tie fell differently.
The CUDA kernels' wide instance is held here through its spec: the sun
query composed of `wide_walk_plain` walks, as the kernel composes it,
against the plain version and the interpret-mode kernel.

The interpret-mode kernels run in a subprocess whose XLA may not use FMA
instructions (--xla_cpu_max_isa=AVX): with them XLA-CPU contracts the
Moller-Trumbore products into fused multiply-adds, which neither the port
nor its CUDA kernel (built with -fmad=false) performs, and t, u, v then
differ in the last bit.  The per-lane walk runs op by op (jit disabled)
for the same reason.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dsrt_tpu.ops.trace as jtrace
from dsrt_tpu.models.presets import random_tri_soup_scene as jsoup
from dsrt_tpu.ops.linalg import V3 as JV3
from dsrt_tpu_torch.models.presets import random_tri_soup_scene
from dsrt_tpu_torch.ops import traverse as tv
from dsrt_tpu_torch.ops.linalg import V3
from dsrt_tpu_torch.ops.trace import walk_counter, wide_walk_plain

ROOT = Path(__file__).resolve().parent.parent
NTRI = 2100
N = 1024
T_MIN, T_MAX, BIAS = 1e-3, 1e9, 1e-3
_ld = np.array([-0.2, -0.9, 0.3], np.float32)
LDIR = (_ld / np.linalg.norm(_ld)).astype(np.float32)

# run by the subprocess: the interpret-mode TPU kernels on the rays saved
# by the test; writes their outputs next to them
INTERPRET = """
import sys
import numpy as np
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu
from dsrt_tpu.models.presets import random_tri_soup_scene
from dsrt_tpu.ops import pallas_trace
from dsrt_tpu.ops.linalg import V3
rays = np.load(sys.argv[1])
scene = random_tri_soup_scene(n=int(rays["ntri"]))
J = lambda a: jnp.asarray(a.reshape(-1, 1024))
ro, rd = V3(*map(J, rays["o"])), V3(*map(J, rays["d"]))
act = J(rays["act"])
ld = V3(*(jnp.float32(c) for c in rays["ldir"]))
out = {}
with pltpu.force_tpu_interpret_mode():
    for name, any_hit in (("closest", False), ("any", True)):
        res = pallas_trace.traverse(scene, ro, rd, act, 1e-3, 1e9,
                                    any_hit=any_hit)
        for k, a in zip("tuvi", res):
            out[name + k] = np.asarray(a).reshape(-1)
    res = pallas_trace.traverse_with_sun(scene, ro, rd, act, 1e-3, 1e9, ld,
                                         1e-3)
    for k, a in zip("tuvib", res):
        out["sun" + k] = np.asarray(a).reshape(-1)
np.savez(sys.argv[2], **out)
"""


def _rays(seed=5):
    """Rays from around the soup aimed at points of its box, ~10% of the
    lanes inactive (numpy, from a seed)."""
    rng = np.random.default_rng(seed)
    o = rng.normal(scale=1.5, size=(3, N)).astype(np.float32)
    o[2] += 2.0
    tgt = rng.uniform([-1.5, -1.0, -4.0], [1.5, 1.0, -2.0], (N, 3)).T
    d = tgt.astype(np.float32) - o
    d = (d / np.linalg.norm(d, axis=0, keepdims=True)).astype(np.float32)
    return o, d, rng.random(N) > 0.1


@pytest.fixture(scope="module")
def port_scene():
    return random_tri_soup_scene(n=NTRI, device="cpu")


@pytest.fixture(scope="module")
def jax_kernels(tmp_path_factory):
    """Outputs of the interpret-mode TPU kernels on `_rays()`."""
    d = tmp_path_factory.mktemp("interpret")
    o, dr, act = _rays()
    np.savez(d / "rays.npz", o=o, d=dr, act=act, ldir=LDIR, ntri=NTRI)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT),
               XLA_FLAGS="--xla_cpu_max_isa=AVX")
    proc = subprocess.run(
        [sys.executable, "-c", INTERPRET, str(d / "rays.npz"),
         str(d / "out.npz")], cwd=str(ROOT), env=env, capture_output=True,
        text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(np.load(d / "out.npz"))


def _torch_rays():
    o, d, act = _rays()
    return (V3(*map(torch.from_numpy, o)), V3(*map(torch.from_numpy, d)),
            torch.from_numpy(act))


def _sun():
    return V3(*(torch.tensor(float(c)) for c in LDIR))


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
def test_traverse_plain_matches_interpret_mode_kernel(port_scene, jax_kernels,
                                                      any_hit):
    ro, rd, act = _torch_rays()
    got = tv.traverse_plain(port_scene, ro, rd, act, T_MIN, T_MAX,
                            any_hit=any_hit)
    key = "any" if any_hit else "closest"
    want_tri = jax_kernels[key + "i"]
    hits = want_tri >= 0
    assert 200 < hits.sum() < act.sum()
    assert not hits[~act.numpy()].any()
    np.testing.assert_array_equal(got[3].numpy() >= 0, hits)
    if not any_hit:
        for g, k in zip(got, "tuvi"):
            np.testing.assert_array_equal(g.numpy(), jax_kernels[key + k])


def test_traverse_with_sun_plain_matches_interpret_mode_kernel(port_scene,
                                                               jax_kernels):
    ro, rd, act = _torch_rays()
    got = tv.traverse_with_sun_plain(port_scene, ro, rd, act, T_MIN, T_MAX,
                                     _sun(), BIAS)
    for g, k in zip(got[:4], "tuvi"):
        np.testing.assert_array_equal(g.numpy(), jax_kernels["sun" + k])
    hits = jax_kernels["suni"] >= 0
    blocked = jax_kernels["sunb"][hits]
    assert 0 < blocked.sum() < hits.sum()
    np.testing.assert_array_equal(got[4].numpy()[hits], blocked)


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
def test_traverse_plain_matches_jax_lane_walk(port_scene, any_hit):
    o, d, act = _rays()
    js = jsoup(n=NTRI)
    with jax.disable_jit():
        want = jtrace.lane_traverse(js, JV3(*map(jnp.asarray, o)),
                                    JV3(*map(jnp.asarray, d)), T_MIN, T_MAX,
                                    jnp.asarray(act), any_hit=any_hit)
    ro, rd, tact = _torch_rays()
    got = tv.traverse_plain(port_scene, ro, rd, tact, T_MIN, T_MAX,
                            any_hit=any_hit)
    want = [np.asarray(w) for w in want]
    assert (want[3] >= 0).sum() > 200
    np.testing.assert_array_equal(got[3].numpy() >= 0, want[3] >= 0)
    if not any_hit:
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w)


def test_wrappers_take_the_plain_versions_on_cpu(port_scene):
    ro, rd, act = _torch_rays()
    before = dict(tv.LAUNCHES)
    got = tv.traverse(port_scene, ro, rd, act, T_MIN, T_MAX)
    want = tv.traverse_plain(port_scene, ro, rd, act, T_MIN, T_MAX)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    got = tv.traverse_with_sun(port_scene, ro, rd, act, T_MIN, T_MAX,
                               _sun(), BIAS)
    want = tv.traverse_with_sun_plain(port_scene, ro, rd, act, T_MIN, T_MAX,
                                      _sun(), BIAS)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert tv.LAUNCHES == before


def test_non_cpu_rays_never_fall_back_to_the_plain_version(port_scene):
    ro = V3(*(torch.zeros(8, device="meta") for _ in range(3)))
    act = torch.ones(8, dtype=torch.bool, device="meta")
    with pytest.raises((ValueError, RuntimeError)):
        tv.traverse(port_scene, ro, ro, act, T_MIN, T_MAX)
    with pytest.raises((ValueError, RuntimeError)):
        tv.traverse_with_sun(port_scene, ro, ro, act, T_MIN, T_MAX, _sun(),
                             BIAS)
    assert tv.LAUNCHES == {"dsrt_traverse": 0, "dsrt_traverse_sun": 0}


def test_walk_counter_and_bound(port_scene):
    ro, rd, act = _torch_rays()
    with walk_counter() as c:
        tv.traverse_plain(port_scene, ro, rd, act, T_MIN, T_MAX)
    visits, tests = int(c["visits"]), int(c["tests"])
    assert visits >= int(act.sum()) and tests > 0
    n_act = int(act.sum())
    rays_in = tv.ray_bytes(ro, rd, n_act)
    assert rays_in == 24 * n_act
    ms, by = tv.bound_ms(port_scene, N, rays_in, visits, tests)
    flops = visits * tv.SLAB_FLOPS + tests * tv.MT_FLOPS
    tables = sum(getattr(port_scene, k).numel() * 4
                 for k in ("bvh_pack", "thr_pack", "tri_pack"))
    assert ms == pytest.approx(max(flops / 67e12, (N * tv.LANE_BYTES
                                                   + 24 * n_act + tables)
                                   / 3.35e12) * 1e3)
    assert by in ("bytes", "operations")
    sun_ms, _ = tv.bound_ms(port_scene, N, rays_in, visits, tests,
                            with_sun=True)
    assert sun_ms >= ms


def test_ray_bytes_counts_active_rays_and_one_value_components():
    """An inactive lane reads no ray; a component that is one value for
    every ray (the shadow query's sun direction, 0-dim or expanded) is
    read once."""
    ro, rd, _ = _torch_rays()
    assert tv.ray_bytes(ro, rd, 0) == 0
    assert tv.ray_bytes(ro, rd, 7) == 24 * 7
    sd = V3(torch.tensor(0.5), torch.tensor(0.5).expand(N),
            torch.tensor(0.5).reshape(1).expand(N))
    assert tv.ray_bytes(ro, sd, 7) == 12 * 7 + 12


def test_walk_rule_takes_the_wide_walk_up_to_its_stack(port_scene):
    """The kernels walk the 8-ary table while the scene's worst stack
    height fits the wide walk's WIDE_STACK (256) entries, and the binary
    walk (any depth) above it."""
    assert tv.WIDE_STACK == 256
    assert port_scene.wide_stack <= tv.WIDE_STACK
    assert tv.walk_of(port_scene) == "wide"
    for stack, walk in ((tv.WIDE_STACK, "wide"), (tv.WIDE_STACK + 1, "binary"),
                        (257, "binary")):
        assert tv.walk_of(dataclasses.replace(port_scene,
                                              wide_stack=stack)) == walk
    assert set(tv.INSTANCE_LAUNCHES) == {(q, w) for q in tv.QUERIES
                                         for w in tv.WALKS}


def _wide_sun(scene, ro, rd, act):
    """The sun kernel's composition on its wide instance's spec: closest
    hit by wide_walk_plain, sun_origin, then the any-hit walk."""
    return tv.traverse_with_sun_plain(scene, ro, rd, act, T_MIN, T_MAX,
                                      _sun(), BIAS, walk=wide_walk_plain)


def test_wide_sun_composition_equals_plain_version(port_scene):
    ro, rd, act = _torch_rays()
    got = _wide_sun(port_scene, ro, rd, act)
    want = tv.traverse_with_sun_plain(port_scene, ro, rd, act, T_MIN, T_MAX,
                                      _sun(), BIAS)
    hits = want[3] >= 0
    assert 200 < int(hits.sum()) and 0 < int(want[4][hits].sum())
    for g, w in zip(got[:4], want[:4]):
        assert torch.equal(g, w)
    assert torch.equal(got[4][hits], want[4][hits])


def test_wide_sun_composition_matches_interpret_mode_kernel(port_scene,
                                                            jax_kernels):
    ro, rd, act = _torch_rays()
    got = _wide_sun(port_scene, ro, rd, act)
    for g, k in zip(got[:4], "tuvi"):
        np.testing.assert_array_equal(g.numpy(), jax_kernels["sun" + k])
    hits = jax_kernels["suni"] >= 0
    np.testing.assert_array_equal(got[4].numpy()[hits],
                                  jax_kernels["sunb"][hits])


def test_ray_layouts_the_kernels_read_without_copies():
    """Full contiguous components are passed as they are, a component
    that is one value for every ray (0-dim or expanded, as a shadow
    query's direction) by its one address with its bit set, any other
    layout copied."""
    act = torch.ones((4, 8), dtype=torch.bool)
    full = torch.arange(32, dtype=torch.float32).reshape(4, 8)
    one = torch.tensor(2.0)
    strided = torch.zeros((8, 4)).t()
    ro = V3(full, one, one.expand(4, 8))
    rd = V3(strided, full, full)
    ptrs, keep, bcast = tv._rays(ro, rd, act)
    assert bcast == 0b000110
    assert ptrs[0] == full.data_ptr() and ptrs[1] == one.data_ptr()
    assert ptrs[2] == one.data_ptr() and ptrs[4] == full.data_ptr()
    assert keep[3].is_contiguous() and ptrs[3] != strided.data_ptr()
    assert torch.equal(keep[3], strided)
    with pytest.raises(ValueError):
        tv._rays(V3(full.double(), one, one), rd, act)


def test_sun_vector_is_ldir_and_bias():
    v = tv.sun_vector(_sun(), BIAS)
    assert v.dtype == torch.float32 and v.shape == (4,)
    assert v.tolist() == [float(np.float32(c)) for c in LDIR] + [
        float(np.float32(BIAS))]
