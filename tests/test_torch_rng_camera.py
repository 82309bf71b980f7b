"""dsrt_tpu_torch RNG and camera against the JAX reference (dsrt_tpu.ops).

The LCG is integer arithmetic, so states, draws and rejection-sampler draw
counts must be identical.  cos/sin lower differently in XLA-CPU and in
PyTorch's CPU kernels, so the cosine direction is held to 2 ulp.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dsrt_tpu.ops import camera as jcam
from dsrt_tpu.ops import rng as jrng
from dsrt_tpu_torch.ops import camera as tcam
from dsrt_tpu_torch.ops import rng as trng

N = 4096


def _states(seed):
    rng = np.random.default_rng(seed)
    s = rng.integers(0, 2 ** 32, size=N, dtype=np.uint64).astype(np.uint32)
    mask = rng.random(N) < 0.6
    return s, mask


def _j(state_u32):
    return jnp.asarray(state_u32)


def _t(state_u32):
    return torch.from_numpy(state_u32.astype(np.int64))


def _ulp_diff(a, b):
    """|a - b| in units in the last place of float32 (same-sign values)."""
    ia = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    ib = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(ia - ib)


def test_seed_pixels_matches():
    rng = np.random.default_rng(0)
    px = rng.integers(0, 1920, N).astype(np.int32)
    py = rng.integers(0, 1080, N).astype(np.int32)
    for seed in (1337, 0xFFFFFFFF, 7):
        want = np.asarray(jrng.seed_pixels(jnp.asarray(px), jnp.asarray(py),
                                           1920, seed))
        got = trng.seed_pixels(torch.from_numpy(px), torch.from_numpy(py),
                               1920, seed).numpy()
        np.testing.assert_array_equal(got.astype(np.uint32), want)


@pytest.mark.parametrize("masked", [False, True])
def test_draws_match(masked):
    s, mask = _states(1)
    js, ts = _j(s), _t(s)
    jm = jnp.asarray(mask) if masked else None
    tm = torch.from_numpy(mask) if masked else None
    for _ in range(5):
        ju, js = jrng.draw(js, jm)
        tu, ts = trng.draw(ts, tm)
        np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
        np.testing.assert_array_equal(ts.numpy().astype(np.uint32),
                                      np.asarray(js))


def test_random_in_unit_sphere_states_and_points_match():
    s, mask = _states(2)
    jp, js = jrng.random_in_unit_sphere(_j(s), jnp.asarray(mask))
    tp, ts = trng.random_in_unit_sphere(_t(s), torch.from_numpy(mask))
    np.testing.assert_array_equal(ts.numpy().astype(np.uint32),
                                  np.asarray(js))
    for a, b in zip(tp, jp):
        np.testing.assert_array_equal(a.numpy()[mask], np.asarray(b)[mask])
    # draw counts: 3 per attempt, at least one attempt per masked lane
    steps = np.zeros(N, np.int64)
    st = s.astype(np.uint64)
    fin = ts.numpy().astype(np.uint64)
    for i in range(N):
        cur = st[i]
        while cur != fin[i]:
            cur = (cur * 1664525 + 1013904223) & 0xFFFFFFFF
            steps[i] += 1
    assert (steps[~mask] == 0).all()
    assert (steps[mask] % 3 == 0).all() and (steps[mask] >= 3).all()
    assert (steps[mask] > 3).any()   # some lanes retried


def test_cosine_direction_within_2ulp():
    """cos/sin: XLA-CPU and PyTorch-CPU lowerings differ by ulps; the
    sqrt terms and the draw schedule are exact."""
    s, mask = _states(3)
    jv, js = jrng.random_cosine_direction(_j(s), jnp.asarray(mask))
    tv, ts = trng.random_cosine_direction(_t(s), torch.from_numpy(mask))
    np.testing.assert_array_equal(ts.numpy().astype(np.uint32),
                                  np.asarray(js))
    np.testing.assert_array_equal(tv.z.numpy(), np.asarray(jv.z))
    for a, b in ((tv.x, jv.x), (tv.y, jv.y)):
        a, b = a.numpy(), np.asarray(b)
        same_sign = np.sign(a) == np.sign(b)
        assert (same_sign | (np.abs(a - b) < 1e-6)).all()
        assert _ulp_diff(a[same_sign], b[same_sign]).max() <= 2


@pytest.mark.parametrize("dims", [(48, 32), (800, 450)])
def test_generate_rays_bit_identical(dims):
    """Raygen op by op (jit disabled, as XLA-CPU would otherwise contract
    ll + u*hz into a fused multiply-add that neither PyTorch nor the CUDA
    kernel built with -fmad=false performs)."""
    w, h = dims
    rng = np.random.default_rng(4)
    px = rng.integers(0, w, N).astype(np.int32)
    py = rng.integers(0, h, N).astype(np.int32)
    jx = rng.random(N).astype(np.float32)
    jy = rng.random(N).astype(np.float32)
    pose = ((40.0, 60.0, 190.0), (0.0, 0.0, 0.0))
    jc = jcam.point_camera_at(pose[0], pose[1], vfov=40.0, width=w, height=h)
    tc = tcam.point_camera_at(pose[0], pose[1], vfov=40.0, width=w, height=h,
                              device="cpu")
    for f in ("origin", "lower_left", "horizontal", "vertical", "u", "v",
              "w"):
        np.testing.assert_array_equal(getattr(tc, f).numpy(),
                                      np.asarray(getattr(jc, f)))
    with jax.disable_jit():
        jo, jd = jcam.generate_rays(jc, jnp.asarray(px), jnp.asarray(py),
                                    jnp.asarray(jx), jnp.asarray(jy))
    to, td = tcam.generate_rays(tc, torch.from_numpy(px),
                                torch.from_numpy(py), torch.from_numpy(jx),
                                torch.from_numpy(jy))
    for a, b in zip(list(to) + list(td), list(jo) + list(jd)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_camera_from_reference_and_aperture():
    jc = jcam.point_camera_at((1.0, 2.0, 30.0), vfov=50.0, width=32,
                              height=24)
    tc = tcam.camera_from_reference(jc, device="cpu")
    np.testing.assert_array_equal(tc.lower_left.numpy(),
                                  np.asarray(jc.lower_left))
    assert (tc.width, tc.height) == (32, 24)
    # a thin-lens camera: same basis, lens radius half the aperture
    jl = jcam.make_camera((0, 0.4, 1.2), (0, 0, -1), vfov=60, width=32,
                          height=24, aperture=0.25, focus_dist=1.7)
    tl = tcam.make_camera((0, 0.4, 1.2), (0, 0, -1), vfov=60, width=32,
                          height=24, aperture=0.25, focus_dist=1.7,
                          device="cpu")
    for cam in (tl, tcam.camera_from_reference(jl, device="cpu")):
        assert float(cam.lens_radius) == float(np.asarray(jl.lens_radius))
        for f in ("lower_left", "horizontal", "vertical", "u", "v"):
            np.testing.assert_array_equal(getattr(cam, f).numpy(),
                                          np.asarray(getattr(jl, f)))
