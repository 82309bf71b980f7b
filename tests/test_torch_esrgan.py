"""The port's RRDBNet (dsrt_tpu_torch/models/esrgan.py) against the JAX
package's (dsrt_tpu/models/esrgan.py) on the CPU, on the same seeded
parameters.

`init_params` alone gives outputs of ~1e-4 (every u8 pixel 0), so the
weights here are scaled x5 with N(0, 0.05) biases, and each test first
requires >= 25% of its u8 outputs strictly inside (0, 255).  That share
varies from seed to seed at these widths (about 10-70%); the seeds here
are ones that reach it.

Tolerances: float max |d| <= 1e-5 * max |out| (the two conv libraries
sum in other orders); tiles in one batch against one at a time <= 1e-6
relative; u8 >= 99.9% identical and max |d| <= 1.
"""

import numpy as np
import pytest
import torch

from dsrt_tpu.models import esrgan as jax_esrgan
from dsrt_tpu_torch.models import esrgan

SMALL = dict(num_feat=8, num_block=2, num_grow_ch=4)
FULL = dict(num_feat=64, num_block=23, num_grow_ch=32)


def lively(params, rng):
    """init_params' pytree with weights x5 and N(0, 0.05) biases, drawn
    from `rng` in the pytree's order."""
    def walk(node):
        if isinstance(node, dict):
            if set(node) == {"w", "b"}:
                return {"w": node["w"] * np.float32(5),
                        "b": rng.normal(0.0, 0.05, node["b"].shape
                                        ).astype(np.float32)}
            return {k: walk(v) for k, v in node.items()}
        return [walk(v) for v in node]
    return walk(params)


def seeded(seed, scale, widths=SMALL):
    rng = np.random.default_rng(seed)
    spec = jax_esrgan.rrdbnet_spec(scale=scale, **widths)
    return lively(jax_esrgan.init_params(rng, spec), rng), rng


def to_u8(y):
    return np.clip(np.rint(y * 255.0), 0, 255).astype(np.uint8)


def require_in_range(u8):
    inside = float(((u8 > 0) & (u8 < 255)).mean())
    assert inside >= 0.25, f"only {inside:.1%} of u8 values inside (0, 255)"


def forward(net, img):
    with torch.inference_mode():
        out = net(torch.from_numpy(img.transpose(0, 3, 1, 2)))
    return out.permute(0, 2, 3, 1).numpy()


def assert_close(out, ref, rel=1e-5):
    assert out.shape == ref.shape
    err = np.abs(out - ref).max()
    assert err <= rel * np.abs(ref).max(), (err, np.abs(ref).max())


@pytest.mark.parametrize("widths,scale", [(SMALL, 4), (SMALL, 2), (SMALL, 1),
                                          (FULL, 4)],
                         ids=["small-x4", "small-x2", "small-x1",
                              "full-x4"])
def test_forward_matches_jax(widths, scale):
    params, rng = seeded(0, scale, widths)
    img = rng.random((1, 16, 16, 3), np.float32)
    ref = np.asarray(jax_esrgan.rrdbnet_forward(params, img, scale=scale))
    require_in_range(to_u8(ref))
    net = esrgan.rrdbnet_from_params(params, scale, device="cpu")
    out = forward(net, img)
    assert out.shape == (1, 16 * scale, 16 * scale, 3)
    assert_close(out, ref)


def test_init_params_equal_jax():
    spec = jax_esrgan.rrdbnet_spec(scale=2, **SMALL)
    assert esrgan.rrdbnet_spec(scale=2, **SMALL) == spec
    a = jax_esrgan.init_params(np.random.default_rng(11), spec)
    b = esrgan.init_params(np.random.default_rng(11), spec)
    la, lb = [], []

    def flat(node, out):
        if isinstance(node, dict):
            for k in sorted(node):
                flat(node[k], out)
        elif isinstance(node, list):
            for v in node:
                flat(v, out)
        else:
            out.append(node)
    flat(a, la)
    flat(b, lb)
    assert len(la) == len(lb) == 2 * (1 + 15 * 2 + 5)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and np.array_equal(x, y)


def test_upscale_tiled_matches_jax_and_batches_agree():
    params, rng = seeded(1, 4, dict(SMALL, num_block=1))
    img = rng.random((40, 56, 3), np.float32)
    ref = jax_esrgan.upscale_tiled(params, img, scale=4, tile=32, overlap=8)
    require_in_range(to_u8(ref))
    net = esrgan.rrdbnet_from_params(params, 4, device="cpu")
    one_batch = esrgan.upscale_tiled(net, img, tile=32, overlap=8)
    assert one_batch.shape == (160, 224, 3)
    assert_close(one_batch, ref)
    # the grid is 2 x 3 tiles, and one batch holds all six
    tiles, origins = esrgan.tile_grid(img, 32, 8)
    assert len(origins) == 6 and esrgan.tile_batch(net, 32, 6) == 6
    singly = esrgan.stitch(
        np.concatenate([esrgan.forward_tiles(net, t[None]) for t in tiles]),
        origins, 40, 56, 32, 8)
    assert_close(one_batch, singly, rel=1e-6)


def test_upscale_u8_matches_jax():
    params, rng = seeded(2, 4, dict(SMALL, num_block=1))
    img = rng.integers(0, 256, (40, 56, 3), dtype=np.uint8)
    ref = jax_esrgan.upscale_u8(params, img, 4, tile=32, overlap=8)
    require_in_range(ref)
    net = esrgan.rrdbnet_from_params(params, 4, device="cpu")
    out = esrgan.upscale_u8(net, img, tile=32, overlap=8)
    assert out.shape == ref.shape == (160, 224, 3) and out.dtype == np.uint8
    d = np.abs(out.astype(int) - ref.astype(int))
    assert (d == 0).mean() >= 0.999 and d.max() <= 1


@pytest.mark.parametrize("wrapper", ["params_ema", "params", "state_dict",
                                     None])
def test_checkpoint_loads_as_jax_loads_it(tmp_path, wrapper):
    params, rng = seeded(0, 4)
    sd = esrgan.state_dict_from_params(params)
    path = str(tmp_path / "x4.pth")
    torch.save(sd if wrapper is None else {wrapper: sd}, path)
    img = rng.random((1, 12, 16, 3), np.float32)
    ref = np.asarray(jax_esrgan.rrdbnet_forward(
        jax_esrgan.load_torch_checkpoint(path, num_block=2, scale=4), img,
        scale=4))
    require_in_range(to_u8(ref))
    net = esrgan.load_torch_checkpoint(path, num_block=2, scale=4,
                                       device="cpu")
    assert isinstance(net, esrgan.RRDBNet)
    assert_close(forward(net, img), ref)


def test_checkpoint_of_another_depth_raises(tmp_path):
    params, _ = seeded(4, 4)
    path = str(tmp_path / "x4.pth")
    torch.save({"params_ema": esrgan.state_dict_from_params(params)}, path)
    with pytest.raises(RuntimeError, match="body.2"):
        esrgan.load_torch_checkpoint(path, num_block=3, scale=4,
                                     device="cpu")


def test_the_network_defaults_to_the_card(monkeypatch):
    params, _ = seeded(5, 4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        esrgan.rrdbnet_from_params(params, 4)
