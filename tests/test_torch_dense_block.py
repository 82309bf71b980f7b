"""The RRDB trunk on channels-last buffers (models/esrgan.py `dense_trunk`)
and the dense blocks' conv kernel (ops/rdb_conv.py, csrc/rdb_conv.cu).

On the CPU the buffer layout's plain version (`rdb_conv_plain`: each
conv reads a channel prefix, writes its own channel slice, and does the
block's elementwise steps in the modules' order) is held against the
`ResidualDenseBlock` / `RRDB` forwards, which it reproduces bit for bit
there (the same convs on the same contiguous tensors); the tolerance
below is FP32's.  The `cuda` tests hold the kernel against the plain
version on the card:
    python -m pytest tests/test_torch_dense_block.py -m cuda
Tolerances on the card: max |d| <= 1e-5 x max |out| per block output
(the kernel's fused multiply-adds sum in another order than cuDNN), and
the u8 output of a 28-tile frame identical on >= 99.99% of its values.
"""

import functools
from unittest import mock

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from dsrt_tpu_torch.models import esrgan
from dsrt_tpu_torch.ops import rdb_conv

WIDTHS = [(8, 4), (64, 32)]
IDS = ["8/4", "64/32"]


def seeded_body(nf, gc, blocks=2, seed=0):
    torch.manual_seed(seed)
    body = torch.nn.Sequential(*[esrgan.RRDB(nf, gc) for _ in range(blocks)])
    with torch.no_grad():
        for m in body.modules():
            if isinstance(m, torch.nn.Conv2d):
                m.bias.normal_(0.0, 0.05)
    return body


def recorder(conv, outs):
    """`conv`, keeping a copy of each dense block's output."""
    def run(src, cin, m, dst, off, mode):
        conv(src, cin, m, dst, off, mode)
        if mode != rdb_conv.LRELU:
            outs.append(dst[..., :m.out_channels].clone())
    return run


def rel_err(a, b):
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.parametrize("nf,gc", WIDTHS, ids=IDS)
def test_plain_buffer_trunk_matches_the_modules(nf, gc):
    body = seeded_body(nf, gc)
    feat = torch.randn(3, nf, 12, 20)
    blocks = []
    with torch.inference_mode():
        x = feat
        for rrdb in body:
            a = rrdb.rdb1(x)
            x = rrdb(x)
            blocks += [a, rrdb.rdb2(a), x]
        got = []
        out = esrgan.dense_trunk(body, feat,
                                 recorder(rdb_conv.rdb_conv_plain, got))
        want = body(feat)
    assert out.shape == feat.shape and out.is_contiguous()
    assert rel_err(out, want) <= 1e-6
    assert len(got) == len(blocks) == 6
    for g, want in zip(got, blocks):
        assert rel_err(g.permute(0, 3, 1, 2), want) <= 1e-6


@pytest.mark.parametrize("mode", [rdb_conv.LRELU, rdb_conv.RESIDUAL,
                                  rdb_conv.RRDB_RESIDUAL],
                         ids=["lrelu", "residual", "rrdb-residual"])
def test_plain_conv_reads_its_prefix_and_writes_its_slice(mode):
    nf, gc = 8, 4
    cin, width = nf + 2 * gc, nf + 4 * gc
    torch.manual_seed(1)
    cout = gc if mode == rdb_conv.LRELU else nf
    conv = torch.nn.Conv2d(cin, cout, 3, 1, 1)
    src = torch.randn(2, 9, 11, width)
    src[..., cin:] = float("nan")  # past the prefix: never read
    dst = src if mode == rdb_conv.LRELU else torch.randn(2, 9, 11, width)
    before = dst.clone()
    off = cin if mode == rdb_conv.LRELU else 0
    with torch.inference_mode():
        y = conv(src[..., :cin].permute(0, 3, 1, 2).contiguous()
                 ).permute(0, 2, 3, 1)
        if mode == rdb_conv.LRELU:
            want = F.leaky_relu(y, 0.2)
        else:
            want = src[..., :cout] + 0.2 * y
            if mode == rdb_conv.RRDB_RESIDUAL:
                want = before[..., off:off + cout] + 0.2 * want
        rdb_conv.rdb_conv(src, cin, conv, dst, off, mode)
    assert torch.equal(dst[..., off:off + cout], want)
    keep = torch.ones(dst.shape[3], dtype=torch.bool)
    keep[off:off + cout] = False
    assert torch.equal(dst[..., keep].isnan(), before[..., keep].isnan())
    assert torch.equal(dst[..., keep].nan_to_num(),
                       before[..., keep].nan_to_num())


def test_pack_lays_out_the_weights_as_the_kernel_reads_them():
    torch.manual_seed(2)
    conv = torch.nn.Conv2d(12, 20, 3, 1, 1)
    wt, b = rdb_conv.pack(conv)
    assert wt.shape == (2, 3, 3, rdb_conv.KC, 32) and b.shape == (32,)
    w = conv.weight.detach()
    for c, ky, kx, ci, co in [(0, 0, 0, 0, 0), (1, 2, 1, 3, 19),
                              (0, 1, 2, 7, 5), (1, 0, 0, 1, 11)]:
        assert wt[c, ky, kx, ci, co] == w[co, c * rdb_conv.KC + ci, ky, kx]
    assert not wt[1, :, :, 4:].any() and not wt[..., 20:].any()
    assert torch.equal(b[:20], conv.bias.detach()) and not b[20:].any()
    assert rdb_conv.pack(conv)[0] is wt
    with torch.no_grad():
        conv.weight.mul_(2.0)
    assert rdb_conv.pack(conv)[0] is not wt


@pytest.mark.parametrize("nf,gc", WIDTHS, ids=IDS)
def test_kernel_takes_the_widths_the_repo_runs(nf, gc):
    rdb = esrgan.ResidualDenseBlock(nf, gc)
    buf = torch.zeros(1, 4, 4, nf + 4 * gc)
    for i in range(4):
        conv = getattr(rdb, f"conv{i + 1}")
        assert rdb_conv.shape_error(buf, nf + i * gc, conv, buf, nf + i * gc,
                                    rdb_conv.LRELU) is None
    for mode in (rdb_conv.RESIDUAL, rdb_conv.RRDB_RESIDUAL):
        assert rdb_conv.shape_error(buf, nf + 4 * gc, rdb.conv5, buf, 0,
                                    mode) is None


@pytest.mark.parametrize("nf,gc", [(128, 32), (64, 6), (6, 4)],
                         ids=["nf128", "gc6", "nf6"])
def test_kernel_refuses_widths_it_does_not_take(nf, gc):
    rdb = esrgan.ResidualDenseBlock(nf, gc)
    buf = torch.zeros(1, 4, 4, nf + 4 * gc)
    errs = [rdb_conv.shape_error(buf, nf + i * gc,
                                 getattr(rdb, f"conv{i + 1}"), buf,
                                 nf + i * gc, rdb_conv.LRELU)
            for i in range(4)]
    errs.append(rdb_conv.shape_error(buf, nf + 4 * gc, rdb.conv5, buf, 0,
                                     rdb_conv.RESIDUAL))
    assert any(e is not None for e in errs)


def test_cpu_forward_keeps_the_modules():
    net = esrgan.RRDBNet(num_feat=8, num_block=2, num_grow_ch=4)
    x = torch.rand(1, 3, 8, 8)
    with torch.inference_mode():
        want = net(x)
        with mock.patch.object(esrgan, "dense_trunk",
                               side_effect=AssertionError("dense path")):
            got = net(x)
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def lively_net(device, seed=0):
    """RRDBNet-23 x4 at 64/32: init_params with weights x5 and N(0, 0.05)
    biases (init_params alone gives u8 outputs of 0)."""
    rng = np.random.default_rng(seed)
    params = esrgan.init_params(rng, esrgan.rrdbnet_spec(scale=4))

    def walk(node):
        if isinstance(node, dict):
            if set(node) == {"w", "b"}:
                return {"w": node["w"] * np.float32(5),
                        "b": rng.normal(0.0, 0.05, node["b"].shape
                                        ).astype(np.float32)}
            return {k: walk(v) for k, v in node.items()}
        return [walk(v) for v in node]
    return esrgan.rrdbnet_from_params(walk(params), 4, device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("nf,gc", WIDTHS, ids=IDS)
def test_kernel_matches_plain_on_the_card(cuda, nf, gc):
    body = seeded_body(nf, gc).to(cuda)
    feat = torch.randn(3, nf, 90, 100, device=cuda)
    got, want = [], []
    with torch.inference_mode(), esrgan.fp32_scope():
        esrgan.dense_trunk(body, feat, recorder(rdb_conv.rdb_conv, got))
        esrgan.dense_trunk(body, feat,
                           recorder(rdb_conv.rdb_conv_plain, want))
    torch.cuda.synchronize()
    assert len(got) == 6
    for g, w in zip(got, want):
        assert rel_err(g, w) <= 1e-5


def wavy_frame(seed=3):
    """An 800x450 u8 frame: smooth waves per channel plus noise."""
    yy, xx = np.mgrid[0:450, 0:800].astype(np.float32)
    rng = np.random.default_rng(seed)
    img = np.stack([np.sin(xx / (17 + 9 * c)) * np.cos(yy / (23 + 5 * c))
                    for c in range(3)], -1) * 0.4 + 0.5
    img += rng.normal(0.0, 0.05, img.shape).astype(np.float32)
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


@pytest.mark.cuda
def test_frame_through_the_kernel_matches_plain_u8(cuda):
    net = lively_net(cuda)
    img = wavy_frame()
    rdb_conv.reset_launches()
    got = esrgan.upscale_u8(net, img)
    torch.cuda.synchronize()
    assert rdb_conv.LAUNCHES["dsrt_rdb_conv"] == 15 * 23
    plain = functools.partial(esrgan.dense_trunk,
                              conv=rdb_conv.rdb_conv_plain)
    with mock.patch.object(esrgan, "dense_trunk", plain):
        want = esrgan.upscale_u8(net, img)
    assert got.shape == want.shape == (1800, 3200, 3)
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert (d == 0).mean() >= 0.9999 and d.max() <= 1


@pytest.mark.cuda
def test_frames_issued_back_to_back_are_upscale_u8s(cuda):
    """Two 800x450 frames issued one after the other (28 tiles, one
    forward each) and only then finished are each `upscale_u8`'s bytes,
    and their issue makes no host-device synchronisation."""
    net = lively_net(cuda)
    imgs = [wavy_frame(seed) for seed in (3, 4)]
    want = [esrgan.upscale_u8(net, img) for img in imgs]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pending = [esrgan.upscale_u8_async(net, img) for img in imgs]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert all(p.done is not None and p.ups.is_pinned() for p in pending)
    for p, w in zip(pending, want):
        got = esrgan.finish_upscale(p)
        assert got.shape == (1800, 3200, 3) and np.array_equal(got, w)


@pytest.mark.cuda
@pytest.mark.parametrize("nf,gc", [(128, 32), (64, 6)], ids=["nf128", "gc6"])
def test_card_refuses_widths_the_kernel_does_not_take(cuda, nf, gc):
    body = torch.nn.Sequential(esrgan.RRDB(nf, gc)).to(cuda)
    with torch.inference_mode(), pytest.raises(ValueError,
                                               match="dsrt_rdb_conv"):
        esrgan.dense_trunk(body, torch.zeros(1, nf, 8, 8, device=cuda))
