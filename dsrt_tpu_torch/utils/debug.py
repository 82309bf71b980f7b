"""Numeric sanitization helpers.

Port of dsrt_tpu/utils/debug.py.  JAX traps NaNs per op (`jax_debug_nans`
re-runs the op that made one and raises there) and checks a render with
`checkify`.  PyTorch has no per-op NaN trap like `jax_debug_nans` (its
anomaly mode covers only the backward pass), and the kernels' work is
not made of PyTorch ops anyway.  So the port checks where a frame's float
sums become its image: inside `debug_nans`, `render.tonemap_device` raises
FloatingPointError on a non-finite accumulator; `checked_render` runs a
render in that scope and checks its result too.
"""

from __future__ import annotations

import contextlib
import contextvars

import numpy as np
import torch

_CHECKING = contextvars.ContextVar("dsrt_tpu_torch_debug_nans",
                                   default=False)


@contextlib.contextmanager
def debug_nans(enable: bool = True):
    """Check every frame's accumulators for non-finite values in the
    scope (`check_accumulator`); each check waits for the device."""
    token = _CHECKING.set(enable)
    try:
        yield
    finally:
        _CHECKING.reset(token)


def check_accumulator(accum, name: str = "accumulator") -> None:
    """Inside `debug_nans`: raise FloatingPointError when `accum` holds a
    non-finite value.  Outside: nothing."""
    if _CHECKING.get():
        assert_finite(accum, name)


def checked_render(render_fn, *args, **kwargs):
    """Run a render function with its accumulators checked (`debug_nans`)
    and check its float results; raises FloatingPointError on the first
    non-finite accumulator or image value."""
    with debug_nans(True):
        out = render_fn(*args, **kwargs)
    assert_finite(out, "render output")
    return out


def _tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(np.ascontiguousarray(x))


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif tree is not None:
        yield tree


def image_stats(img) -> dict:
    """Quick sanity stats for a rendered frame (u8 or float, a tensor or
    an array)."""
    fa = _tensor(img).float()
    return {
        "min": float(fa.min()),
        "max": float(fa.max()),
        "mean": float(fa.mean()),
        "nonzero_frac": float((fa != 0).float().mean()),
        "nan_count": int(torch.isnan(fa).sum()),
        "inf_count": int(torch.isinf(fa).sum()),
    }


def assert_finite(tree, name: str = "value") -> None:
    """Finiteness assertion over the float tensors and arrays of a
    nested dict / list / tuple."""
    for i, leaf in enumerate(_leaves(tree)):
        t = _tensor(leaf)
        if t.is_floating_point():
            bad = int((~torch.isfinite(t)).sum())
            if bad:
                raise FloatingPointError(
                    f"{name}: leaf {i} has {bad} non-finite values")
