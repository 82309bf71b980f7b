"""The port's numeric sanitization helpers (dsrt_tpu_torch/utils/debug.py)
against the JAX package's (dsrt_tpu/utils/debug.py) on the CPU.

Tolerance: the stats within 1e-6 relative (float32 means summed in
another order), counts identical; a non-finite value raises
FloatingPointError wherever JAX's helpers raise.
"""

import numpy as np
import pytest
import torch

from dsrt_tpu.utils import debug as jax_debug
from dsrt_tpu_torch.config import RenderConfig
from dsrt_tpu_torch.ops.camera import make_camera
from dsrt_tpu_torch.render import (render_frame, render_radiance,
                                   tonemap_device)
from dsrt_tpu_torch.models.presets import single_triangle_scene
from dsrt_tpu_torch.utils import debug

CFG = RenderConfig(width=8, height=6, spp=1, max_depth=3)


def _images():
    rng = np.random.default_rng(0)
    u8 = rng.integers(0, 256, (6, 8, 3), dtype=np.uint8)
    u8[0] = 0
    f = rng.normal(0, 1, (6, 8, 3)).astype(np.float32)
    f[1, 2, 0] = np.nan
    f[2, 3, 1] = np.inf
    return {"u8": u8, "float": f, "flipped": u8[::-1]}


@pytest.mark.parametrize("kind", ["u8", "float", "flipped"])
def test_image_stats_equal_jax(kind):
    img = _images()[kind]
    want = pytest.approx(jax_debug.image_stats(img), rel=1e-6, nan_ok=True)
    assert debug.image_stats(img) == want
    assert debug.image_stats(torch.from_numpy(np.ascontiguousarray(img))) \
        == want


def test_assert_finite_raises_as_jax_does():
    f = _images()["float"]
    tree = {"a": np.zeros(3, np.float32), "b": [torch.ones(2), f]}
    with pytest.raises(FloatingPointError, match="leaf 2 has 2") as ours:
        debug.assert_finite(tree, "x")
    with pytest.raises(FloatingPointError) as theirs:
        jax_debug.assert_finite(tree | {"b": [np.ones(2, np.float32), f]},
                                "x")
    assert str(ours.value) == str(theirs.value)
    debug.assert_finite({"ok": np.arange(4), "img": _images()["u8"]})


def test_checked_render_passes_a_finite_frame():
    scene = single_triangle_scene(device="cpu")
    cam = make_camera((0, 0, 1.0), (0, 0, -2), vfov=50, width=8, height=6,
                      device="cpu")
    img = debug.checked_render(render_frame, scene, cam, CFG)
    assert np.array_equal(img, render_frame(scene, cam, CFG))
    rad = debug.checked_render(render_radiance, scene, cam, CFG)
    assert rad.dtype == np.float32 and np.isfinite(rad).all()


def test_non_finite_accumulators_raise_inside_debug_nans_only():
    acc = torch.zeros(6, 8, 3)
    acc[3, 4, 1] = float("nan")
    tonemap_device(acc, CFG, 1)            # outside the scope: no check
    with debug.debug_nans():
        with pytest.raises(FloatingPointError, match="accumulator"):
            tonemap_device(acc, CFG, 1)
        with debug.debug_nans(False):
            tonemap_device(acc, CFG, 1)
    with pytest.raises(FloatingPointError, match="accumulator"):
        debug.checked_render(tonemap_device, acc, CFG, 1)
    with pytest.raises(FloatingPointError, match="render output"):
        debug.checked_render(lambda: acc)
