"""The path kernel's 8-ary walk: the packer's table (models/scene.py
`pack_wide`) and the walk's plain spec (ops/trace.py `wide_walk_plain`),
held hit for hit against the binary walk `lane_traverse` of the port and
of the JAX package.

The JAX side runs op by op (jit disabled), as in test_torch_trace.py.  The
cube mesh has shared edges and vertices at integer coordinates, flat
faces (whose padded leaf boxes poke out of their parents' boxes, so the
packer's containment rule is exercised) and rays aimed exactly at its
vertices and edges, whose triangles then tie in t bit for bit.  The
nested triangles (models/feature_scenes.py `nested_triangles`) grow a tree
whose walk needs more than 64 stack entries (the most the path kernel
held before it took the TPU kernel's 256).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dsrt_tpu.models.materials as jmaterials
import dsrt_tpu.models.scene as jscene_mod
import dsrt_tpu.ops.trace as jtrace
from dsrt_tpu.models.mesh_gen import iss_standin_scene as jscene
from dsrt_tpu.ops.linalg import V3 as JV3
from dsrt_tpu_torch.config import RenderConfig
from dsrt_tpu_torch.models import feature_scenes as fs
from dsrt_tpu_torch.models.materials import Material
from dsrt_tpu_torch.models.mesh_gen import iss_standin_scene
from dsrt_tpu_torch.models.obj import MeshData
from dsrt_tpu_torch.models.scene import (WIDE_ARITY, SceneBuilder,
                                         pack_wide, scene_from_reference)
from dsrt_tpu_torch.ops import path_kernel
from dsrt_tpu_torch.ops.linalg import V3
from dsrt_tpu_torch.ops.trace import (lane_traverse, walk_counter,
                                      wide_walk_plain)

N = 1 << 14
CUBE = 6
_cache = {}


def _cube_scene():
    """The cube [0, CUBE]^3, each face a grid of unit cells of two
    triangles with one winding."""
    tris = []
    for axis in range(3):
        for side in (0, CUBE):
            for i in range(CUBE):
                for j in range(CUBE):
                    def p(a, b):
                        q = [0.0, 0.0, 0.0]
                        q[axis], q[(axis + 1) % 3], q[(axis + 2) % 3] = (
                            side, a, b)
                        return q
                    a, b, c, d = p(i, j), p(i + 1, j), p(i + 1, j + 1), p(i, j + 1)
                    tris += [(a, b, c), (a, c, d)]
    v = np.asarray(tris, np.float32)
    n = len(v)
    uv = np.zeros((n, 2), np.float32)
    mesh = MeshData(v[:, 0], v[:, 1], v[:, 2], uv, uv, uv,
                    [Material.lambertian()] * n, [""] * n)
    b = SceneBuilder(sun_enabled=False, bvh_method="sbvh")
    b.add_mesh(mesh)
    return b.build(device="cpu")


def _scene(name):
    if name not in _cache:
        _cache[name] = {
            "standin4": lambda: iss_standin_scene(detail=4, device="cpu"),
            "cube": _cube_scene,
            "nested": lambda: fs.nested_triangles(
                SceneBuilder, Material, sun=False).build(device="cpu"),
        }[name]()
    return _cache[name]


def _random_rays(scale, centre, seed):
    """Half the rays aimed into the scene, half in random directions."""
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(3, N))
    o *= scale * (1.5 + 3.0 * rng.random(N)) / np.linalg.norm(o, axis=0)
    o += np.asarray(centre)[:, None]
    tgt = rng.normal(scale=scale * 0.3, size=(3, N)) + np.asarray(centre)[:, None]
    d = rng.normal(size=(3, N))
    d[:, : N // 2] = tgt[:, : N // 2] - o[:, : N // 2]
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def _tie_rays():
    """Rays hitting each cube face at t = 3 exactly, at every vertex, edge
    midpoint and cell centre inside the face (on the cube's own edges
    the rays graze the boxes, which the strict slab test rejects), along
    four integer directions."""
    o, d = [], []
    grid = np.arange(1, 2 * CUBE) / 2.0
    for axis in range(3):
        for side, sgn in ((0, 1.0), (CUBE, -1.0)):
            for a in grid:
                for b in grid:
                    for da, db in ((1, 1), (-1, 2), (2, -1), (-2, -3)):
                        dv = [0.0, 0.0, 0.0]
                        dv[axis], dv[(axis + 1) % 3], dv[(axis + 2) % 3] = (
                            8.0 * sgn, da, db)
                        hit = [0.0, 0.0, 0.0]
                        hit[axis], hit[(axis + 1) % 3], hit[(axis + 2) % 3] = (
                            side, a, b)
                        o.append(np.asarray(hit) - 3.0 * np.asarray(dv))
                        d.append(dv)
    return (np.asarray(o, np.float32).T.copy(),
            np.asarray(d, np.float32).T.copy())


def _axis_rays(n, seed):
    """Rays from near (0, 0, 2) towards the nested triangles' common
    centre, each crossing dozens of them."""
    rng = np.random.default_rng(seed)
    o = np.zeros((3, n))
    o[0:2] = rng.normal(scale=0.05, size=(2, n))
    o[2] = 2.0
    d = np.zeros((3, n))
    d[0:2] = rng.normal(scale=0.02, size=(2, n))
    d[2] = -1.0
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def _rays(name):
    if name == "standin4":
        return _random_rays(40.0, (0.0, 0.0, 0.0), 5)
    if name == "nested":
        o, d = _random_rays(1.0, (0.0, 0.0, -0.25), 8)
        oa, da = _axis_rays(N // 4, 9)
        return np.concatenate([o, oa], 1), np.concatenate([d, da], 1)
    o, d = _random_rays(CUBE, (CUBE / 2,) * 3, 6)
    ot, dt = _tie_rays()
    return np.concatenate([o, ot], 1), np.concatenate([d, dt], 1)


def _t(a):
    return V3(*map(torch.from_numpy, a))


def _brute_ties(scene, o, d):
    """Per ray, how many triangles accept at the closest t (every
    triangle tested in _leaf_scan's arithmetic, numpy float32)."""
    n_tris = scene.n_tris
    tp = scene.tri_pack.numpy()[:n_tris]
    v0, e1, e2 = tp[:, 0:3], tp[:, 3:6], tp[:, 6:9]
    ox, oy, oz = (o[k][:, None] for k in range(3))
    dx, dy, dz = (d[k][:, None] for k in range(3))
    with np.errstate(divide="ignore", invalid="ignore"):
        pvx = dy * e2[:, 2] - dz * e2[:, 1]
        pvy = dz * e2[:, 0] - dx * e2[:, 2]
        pvz = dx * e2[:, 1] - dy * e2[:, 0]
        det = e1[:, 0] * pvx + e1[:, 1] * pvy + e1[:, 2] * pvz
        ok = np.abs(det) >= np.float32(1e-8)
        inv_det = np.float32(1.0) / np.where(ok, det, np.float32(1.0))
        tvx, tvy, tvz = ox - v0[:, 0], oy - v0[:, 1], oz - v0[:, 2]
        u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det
        qvx = tvy * e1[:, 2] - tvz * e1[:, 1]
        qvy = tvz * e1[:, 0] - tvx * e1[:, 2]
        qvz = tvx * e1[:, 1] - tvy * e1[:, 0]
        v = (dx * qvx + dy * qvy + dz * qvz) * inv_det
        t = (e2[:, 0] * qvx + e2[:, 1] * qvy + e2[:, 2] * qvz) * inv_det
    ok &= (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1)
    ok &= (t >= np.float32(1e-3)) & (t <= np.float32(1e9))
    tm = np.where(ok, t, np.inf)
    return (ok & (tm == tm.min(axis=1, keepdims=True))).sum(axis=1)


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
@pytest.mark.parametrize("name", ["standin4", "cube", "nested"])
def test_wide_walk_equals_lane_traverse(name, any_hit):
    scene = _scene(name)
    o, d = _rays(name)
    act = np.ones(o.shape[1], bool)
    act[::7] = False
    args = (scene, _t(o), _t(d), 1e-3, 1e9, torch.from_numpy(act))
    with walk_counter() as wc:
        want = lane_traverse(*args, any_hit=any_hit)
        got = wide_walk_plain(*args, any_hit=any_hit)
    hits = want[3] >= 0
    assert 1000 < int(hits.sum()) < act.sum()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    # the same leaves are scanned, in fewer dependent steps
    assert int(wc["wide_tests"]) == int(wc["tests"])
    assert 0 < int(wc["wide_visits"]) < int(wc["visits"]) / 2


def test_tie_rays_meet_exact_ties():
    """The cube's tie rays hit two or more triangles at the same float32
    t, and both walks pick the same one of them."""
    scene = _scene("cube")
    o, d = _tie_rays()
    ties = _brute_ties(scene, o, d)
    assert (ties >= 2).sum() >= 1000
    act = torch.ones(o.shape[1], dtype=torch.bool)
    want = lane_traverse(scene, _t(o), _t(d), 1e-3, 1e9, act)
    got = wide_walk_plain(scene, _t(o), _t(d), 1e-3, 1e9, act)
    assert torch.equal(want[0], torch.full_like(want[0], 3.0))
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
def test_wide_walk_equals_jax_lane_traverse(any_hit):
    js = jscene(detail=3)
    o, d = _random_rays(40.0, (0.0, 0.0, 0.0), 7)
    o, d = o[:, :4096], d[:, :4096]
    act = np.ones(4096, bool)
    act[::5] = False
    with jax.disable_jit():
        want = jtrace.lane_traverse(js, JV3(*map(jnp.asarray, o)),
                                    JV3(*map(jnp.asarray, d)), 1e-3, 1e9,
                                    jnp.asarray(act), any_hit=any_hit)
    got = wide_walk_plain(scene_from_reference(js, device="cpu"), _t(o),
                          _t(d), 1e-3, 1e9, torch.from_numpy(act),
                          any_hit=any_hit)
    assert (np.asarray(want[3]) >= 0).sum() > 200
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _wide_kids(scene):
    wide = scene.wide_pack.numpy()
    ints = wide.view(np.int32)[:, :8 * WIDE_ARITY].reshape(-1, WIDE_ARITY, 8)
    return wide, ints[:, :, 6], ints[:, :, 7]


@pytest.mark.parametrize("name", ["standin4", "cube"])
def test_packer_leaves_are_the_binary_leaves(name):
    """Every binary leaf is exactly one wide leaf child (same rows, same
    count, same box), and every interior child is a wide node."""
    scene = _scene(name)
    wide, ref, cnt = _wide_kids(scene)
    bp = scene.bvh_pack.numpy()[:scene.n_nodes]
    leaf = bp[:, 8] > 0
    binary = sorted(zip(bp[leaf, 7].astype(int), bp[leaf, 8].astype(int),
                        map(tuple, bp[leaf, 0:6])))
    boxes = wide[:, :8 * WIDE_ARITY].reshape(-1, WIDE_ARITY, 8)[:, :, 0:6]
    kids = sorted(zip(ref[cnt > 0].tolist(), cnt[cnt > 0].tolist(),
                      map(tuple, boxes[cnt > 0])))
    assert kids == binary
    inner = ref[(cnt == 0) & (ref >= 0)]
    assert sorted(inner.tolist()) == list(range(1, len(wide)))


def _leaf_order_of_thread_table(scene, octant):
    bp, thr = scene.bvh_pack.numpy(), scene.thr_pack.numpy()
    end, n, out = scene.n_nodes, 0, []
    while n != end:
        if bp[n, 8] > 0:
            out.append(int(bp[n, 7]))
            n = int(thr[n, 2 * octant + 1])
        else:
            n = int(thr[n, 2 * octant])
    return out


def _leaf_order_of_wide(scene, octant):
    wide, ref, cnt = _wide_kids(scene)
    ranks = wide.view(np.int32)[:, 8 * WIDE_ARITY + octant]
    out = []

    def visit(j):
        rank = [(int(ranks[j]) >> (3 * k)) & 7 for k in range(WIDE_ARITY)]
        for k in sorted(range(WIDE_ARITY), key=lambda k: rank[k]):
            if cnt[j, k] > 0:
                out.append(int(ref[j, k]))
            elif ref[j, k] >= 0:
                visit(int(ref[j, k]))

    visit(0)
    return out


@pytest.mark.parametrize("name", ["standin4", "cube"])
def test_packer_order_is_the_thread_tables_order(name):
    """Each octant's rank words order the leaves as the binary thread
    table (thr_pack) visits them, and each word is a permutation."""
    scene = _scene(name)
    ranks = scene.wide_pack.numpy().view(np.int32)[:, 8 * WIDE_ARITY:]
    for word in ranks.ravel():
        assert sorted((int(word) >> (3 * k)) & 7 for k in range(8)) == list(
            range(8))
    for octant in range(8):
        assert (_leaf_order_of_wide(scene, octant)
                == _leaf_order_of_thread_table(scene, octant))


def test_cube_exercises_the_containment_rule():
    """Padded flat leaves poke out of their parents' boxes; the packer
    keeps such parents as wide nodes of their own."""
    scene = _scene("cube")
    bp = scene.bvh_pack.numpy()[:scene.n_nodes]
    skip = bp[:, 6].astype(int)
    loose = [n for n in range(scene.n_nodes)
             if bp[n, 8] == 0 and skip[n] > n + 1
             and any((bp[c, 0:3] < bp[n, 0:3]).any()
                     or (bp[c, 3:6] > bp[n, 3:6]).any()
                     for c in (n + 1, skip[n + 1]))]
    assert loose
    table, depth, stack = pack_wide(scene.bvh_pack.numpy(),
                                    scene.thr_pack.numpy(), scene.n_nodes)
    assert np.array_equal(table.view(np.uint32),
                          scene.wide_pack.numpy().view(np.uint32))
    assert stack == scene.wide_stack and 1 < depth <= stack


def test_scene_from_reference_derives_the_same_wide_table():
    js = jscene(detail=3)
    from dsrt_tpu_torch.models.mesh_gen import iss_standin_scene as tscene
    port = tscene(detail=3, device="cpu")
    ref = scene_from_reference(js, device="cpu")
    assert np.array_equal(port.wide_pack.numpy().view(np.uint32),
                          ref.wide_pack.numpy().view(np.uint32))
    assert port.wide_stack == ref.wide_stack


def test_flagship_stack_fits_the_kernel():
    scene = iss_standin_scene(detail=12, device="cpu")
    assert scene.n_tris > 50000
    assert scene.wide_stack <= path_kernel.WIDE_STACK


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
def test_deep_tree_walk_equals_jax_lane_traverse(any_hit):
    """On the nested triangles, built by the JAX package's builder: the
    same tables as the port's, and the wide walk hit for hit equal to
    JAX's binary walk."""
    js = fs.nested_triangles(jscene_mod.SceneBuilder, jmaterials.Material,
                             sun=False).build()
    ref = scene_from_reference(js, device="cpu")
    port = _scene("nested")
    assert 64 < ref.wide_stack <= path_kernel.WIDE_STACK
    for name in ("bvh_pack", "thr_pack", "tri_pack", "wide_pack"):
        assert np.array_equal(getattr(ref, name).numpy().view(np.uint32),
                              getattr(port, name).numpy().view(np.uint32))
    o, d = _rays("nested")
    o, d = o[:, -2048:], d[:, -2048:]
    act = np.ones(o.shape[1], bool)
    act[::5] = False
    with jax.disable_jit():
        want = jtrace.lane_traverse(js, JV3(*map(jnp.asarray, o)),
                                    JV3(*map(jnp.asarray, d)), 1e-3, 1e9,
                                    jnp.asarray(act), any_hit=any_hit)
    got = wide_walk_plain(ref, _t(o), _t(d), 1e-3, 1e9,
                          torch.from_numpy(act), any_hit=any_hit)
    assert (np.asarray(want[3]) >= 0).sum() > 1000
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_wrapper_takes_trees_up_to_the_tpu_kernels_stack():
    """Trees up to WIDE_STACK (256, the TPU kernel's) pass the stack check
    (and fail only on the CPU tensors after it), the triangle-only
    instance 0 among them; deeper ones are refused."""
    deep = _scene("nested")
    assert path_kernel.WIDE_STACK == 256
    assert 64 < deep.wide_stack
    assert path_kernel.instance_of(deep, RenderConfig()) == 0
    for stack in (deep.wide_stack, path_kernel.WIDE_STACK):
        with pytest.raises(ValueError, match="CUDA tensor"):
            path_kernel._wide_tables(dataclasses.replace(deep,
                                                         wide_stack=stack))
    with pytest.raises(ValueError, match="holds at most 256"):
        path_kernel._wide_tables(dataclasses.replace(deep, wide_stack=257))


def test_wrapper_refuses_a_tree_deeper_than_the_stack():
    scene = dataclasses.replace(_scene("cube"),
                                wide_stack=path_kernel.WIDE_STACK + 1)
    with pytest.raises(ValueError, match="stack"):
        path_kernel._wide_tables(scene)


def test_sun_composition_on_the_deep_tree_equals_plain_version():
    """The sun kernel's composition (closest hit, `sun_origin`, any-hit
    toward the sun) on the wide walk equals `traverse_with_sun_plain` on
    the nested triangles, whose walk needs more than 64 stack entries:
    (t, u, v, tri) exact, `blocked` equal on hit lanes."""
    from dsrt_tpu_torch.ops import traverse as tv
    scene = _scene("nested")
    o, d = _rays("nested")
    o, d = o[:, -4096:], d[:, -4096:]
    o[0, ::2] += 0.4
    act = np.ones(o.shape[1], bool)
    act[::6] = False
    ld = np.array([0.35, 0.2, 1.0], np.float32)
    ld /= np.linalg.norm(ld)
    sun = V3(*(torch.tensor(float(c)) for c in ld))
    args = (scene, _t(o), _t(d), torch.from_numpy(act), 1e-3, 1e9, sun,
            1e-3)
    got = tv.traverse_with_sun_plain(*args, walk=wide_walk_plain)
    want = tv.traverse_with_sun_plain(*args)
    hits = want[3] >= 0
    assert 1000 < int(hits.sum()) and 0 < int(want[4][hits].sum()) < int(
        hits.sum())
    for g, w in zip(got[:4], want[:4]):
        assert torch.equal(g, w)
    assert torch.equal(got[4][hits], want[4][hits])
