"""The port's SwinIR (dsrt_tpu_torch/models/swinir.py) against the
benchmark's plain reference (portbench/stages/SwinIR.py `forward`) on the
CPU, on the reference's seeded weights (`make_weights`, the
configuration `rdv_a_swinir`'s recipe); the checkpoint loader's choice of
architecture; the stage's precision scope and tile bytes; and, at
SwinIR-L's width over one RSTB, that the attention is visible to the
stage's check.

Small size: 48 wide, 2 RSTBs of 2 layers, 8 heads, window 8, 3conv, x4,
on inputs of 32x32 and 20x28 (the second reflect-padded to 24x32 and
cropped back).  The JAX package has no SwinIR, so the reference is the
benchmark's.

Tolerances, program against reference: u8 equal on >= 99.9% of values
and max |d| <= 1, and in float max |d| <= 1e-5 x max |out|: both are
FP32 with the same equations, but the program batches windows and tiles
where the reference runs the same ops on other shapes, and a library may
sum those in another order.  The reference in bfloat16 fails them.
"""

import os

import numpy as np
import pytest
import torch

from dsrt_tpu_torch.models import esrgan, swinir
from portbench import pngio, registry
from portbench.registry import Bench

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = registry.stage("SwinIR")
CONFIG = Bench().config("rdv_a_swinir")["upscale"]
SMALL = dict(CONFIG, embed_dim=48, depths=[2, 2], num_heads=[8, 8])
SEED = 2 ** 31 + 41


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two threads, so that this module leaves the other test workers'
    cores alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def small():
    sd = REF.make_weights(SMALL, SEED, "cpu")
    return sd, swinir.from_state_dict(sd, device="cpu")


def _frame_crops(size=32):
    """Three size x size crops of a Run A frame (pose 98, 800x450 at 250
    spp) around the lit station, as (3, 3, size, size) floats."""
    img = pngio.read_rgb8(os.path.join(
        ROOT, "misc", "rendezvous250_frame_0098.png")).astype(np.float32)
    crops = [img[y:y + size, x:x + size]
             for y, x in ((180, 300), (200, 500), (240, 100))]
    return torch.from_numpy(np.stack(crops).transpose(0, 3, 1, 2) / 255.0)


def _u8(y):
    return torch.round(y.float() * 255.0).clamp(0, 255)


def _within(got, want) -> bool:
    d = (_u8(got) - _u8(want)).abs()
    return bool((d == 0).float().mean() >= 0.999 and d.max() <= 1
                and (got.float() - want.float()).abs().max()
                <= 1e-5 * want.abs().max())


@pytest.mark.parametrize("hw", [(32, 32), (20, 28)], ids=["whole", "padded"])
def test_network_matches_the_reference(small, hw):
    sd, net = small
    x = torch.rand(2, 3, *hw, generator=torch.Generator().manual_seed(7))
    with torch.inference_mode():
        got = net(x)
        want = REF.forward(sd, x, SMALL)
        low = REF.forward({k: v.to(torch.bfloat16) for k, v in sd.items()},
                          x.to(torch.bfloat16), SMALL)
    assert got.shape == want.shape == (2, 3, 4 * hw[0], 4 * hw[1])
    u8 = _u8(want)
    assert ((u8 >= 1) & (u8 <= 254)).float().mean() > 0.9 and u8.std() > 5
    assert _within(got, want)
    assert not _within(low, want)


def test_widths_and_depths_come_from_the_file(small):
    _, net = small
    assert len(net.layers) == 2
    assert [len(layer.residual_group.blocks) for layer in net.layers] == [2, 2]
    blocks = [b for layer in net.layers for b in layer.residual_group.blocks]
    assert [b.shift for b in blocks] == [0, 4, 0, 4]
    assert all(b.attn.num_heads == 8 and b.ws == 8 for b in blocks)
    assert blocks[0].mlp.fc1.out_features == 96
    assert net.conv_first.out_channels == 48 and net.scale == 4
    assert not any(k.endswith(swinir.DERIVED_KEYS)
                   for k in net.state_dict())
    assert sum(p.numel() for p in net.parameters()) == REF.param_count(SMALL)


def test_index_and_mask_are_made_per_size_and_kept(small):
    _, net = small
    idx, mask = net.masks(24, 32, torch.device("cpu"))
    assert net.masks(24, 32, torch.device("cpu"))[1] is mask
    assert net.masks(32, 32, torch.device("cpu"))[1] is not mask
    assert torch.equal(idx, REF.position_index(8, "cpu"))
    assert torch.equal(mask, REF.region_mask(24, 32, 8, 4, "cpu"))
    assert mask.shape == (12, 64, 64)
    assert set(mask.unique().tolist()) == {0.0, -100.0}


def _save(tmp_path, sd, wrapper="params_ema"):
    path = str(tmp_path / "w.pth")
    torch.save({wrapper: sd} if wrapper else sd, path)
    return path


def test_loader_picks_swinir_and_ignores_the_files_buffers(tmp_path, small):
    sd, net = small
    assert "layers.0.residual_group.blocks.1.attn_mask" in sd
    assert "layers.1.residual_group.blocks.0.attn." \
           "relative_position_index" in sd
    # buffers that disagree with the size the network runs at: ignored
    odd = {k: (torch.zeros_like(v) if k.endswith(swinir.DERIVED_KEYS)
               else v) for k, v in sd.items()}
    loaded = esrgan.load_torch_checkpoint(_save(tmp_path, odd), device="cpu")
    assert isinstance(loaded, swinir.SwinIR)
    x = torch.rand(1, 3, 16, 24, generator=torch.Generator().manual_seed(2))
    with torch.inference_mode():
        assert torch.equal(loaded(x), net(x))


def test_loader_still_picks_rrdbnet(tmp_path):
    rrdb = esrgan.RRDBNet(num_feat=8, num_block=2, num_grow_ch=4)
    path = _save(tmp_path, rrdb.state_dict(), wrapper=None)
    net = esrgan.load_torch_checkpoint(path, num_block=2, device="cpu")
    assert isinstance(net, esrgan.RRDBNet)
    assert all(torch.equal(v, rrdb.state_dict()[k])
               for k, v in net.state_dict().items())


def test_loader_refuses_a_file_of_neither(tmp_path):
    path = _save(tmp_path, {"conv.weight": torch.zeros(3, 3, 3, 3)})
    with pytest.raises(ValueError, match="body.0.rdb1.conv1.weight") as e:
        esrgan.load_torch_checkpoint(path, device="cpu")
    assert esrgan.ARCH_KEYS["SwinIR"] in str(e.value)


def test_loader_refuses_another_swinir_variant(tmp_path, small):
    sd, _ = small
    classical = {k: v for k, v in sd.items()
                 if not k.startswith("conv_up2.")}
    with pytest.raises(ValueError, match="conv_up2.weight"):
        esrgan.load_torch_checkpoint(_save(tmp_path, classical),
                                     device="cpu")
    with pytest.raises(ValueError, match="x4"):
        esrgan.load_torch_checkpoint(_save(tmp_path, sd), scale=2,
                                     device="cpu")


@pytest.mark.parametrize("caller", [False, True], ids=["off", "on"])
def test_precision_scope_turns_tf32_off_and_gives_it_back(caller):
    mm = torch.backends.cuda.matmul
    saved = mm.allow_tf32
    try:
        mm.allow_tf32 = caller
        with esrgan.fp32_scope():
            assert mm.allow_tf32 is False
            assert torch.backends.cudnn.allow_tf32 is False
        assert mm.allow_tf32 is caller
    finally:
        mm.allow_tf32 = saved


def test_a_frame_is_one_forward_on_the_card():
    """Each network's bytes for a 128-pixel tile: RRDBNet's as before,
    SwinIR-L's (scores, qkv, the MLP and the 512^2 tail) so that the
    frame's 28 tiles take one forward within half of 80 GB."""
    rrdb = esrgan.RRDBNet()
    assert rrdb.tile_bytes(128, 128) == 16 * 64 * 512 ** 2
    large = swinir.SwinIR()
    per_tile = large.tile_bytes(128, 128)
    scores = 4 * 128 * 128 * 64 * 8
    assert per_tile > 2 * scores + 16 * 64 * 512 ** 2
    assert 28 * per_tile < esrgan.TILE_MEMORY_SHARE * 80e9


def _drop(net, what):
    """The network with one part of its attention left out."""
    blocks = [b for m in net.layers for b in m.residual_group.blocks]
    if what == "shift":
        for b in blocks:
            b.shift = 0
    elif what == "position_bias":
        for b in blocks:
            b.attn.relative_position_bias_table.data.zero_()
    else:
        masks = net.masks
        net.masks = lambda h, w, d: (masks(h, w, d)[0],
                                     torch.zeros_like(masks(h, w, d)[1]))
    return net


@pytest.mark.parametrize("what", ["shift", "position_bias", "mask"])
def test_the_check_sees_the_attention(what):
    """At the configuration's recipe and width over one RSTB, leaving out
    the shift, the position bias or the mask changes more of the u8
    output than the stage's limit lets through."""
    up = dict(CONFIG, depths=[6], num_heads=[8])
    sd = REF.make_weights(up, SEED, "cpu")
    x = _frame_crops()
    with torch.inference_mode():
        want = _u8(swinir.from_state_dict(sd, device="cpu")(x))
        got = _u8(_drop(swinir.from_state_dict(sd, device="cpu"), what)(x))
    changed = 100.0 * (got != want).float().mean().item()
    assert changed > CONFIG["check"]["limits"]["up_mismatch_pct"]
