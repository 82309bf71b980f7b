"""SwinIR's real-world x4 network (Liang et al., "SwinIR: Image
Restoration Using Swin Transformer", arXiv:2108.10257;
github.com/JingyunLiang/SwinIR `models/network_swinir.py`, as
`main_test_swinir.py --task real_sr --large_model` builds it) as an
upscale stage's architecture: `upscale.arch` "SwinIR" with `embed_dim`,
`depths`, `num_heads`, `window_size`, `mlp_ratio`, `num_feat`,
`img_range`, `img_size` (the release's training size, at which its file
stores the shifted layers' masks), `resi_connection` "3conv", `upsampler`
"nearest+conv" and `scale` 4.  Imports nothing of the program.

The equations (float32; the check's controls cast `sd` and `x` lower):

- reflect-pad the input to a multiple of the window w, subtract the RGB
  mean (0.4488, 0.4371, 0.4040), times `img_range`; `conv_first` 3x3;
  tokens, `patch_embed.norm` (LayerNorm);
- each RSTB i: x + tokens(conv3(map(its layers(x)))), conv3 being conv C
  -> C/4 3x3, leaky ReLU 0.2, conv C/4 -> C/4 1x1, leaky ReLU 0.2, conv
  C/4 -> C 3x3;
- Swin layer j: x + proj(WA(LN1(x))), then x + fc2(GELU(fc1(LN2(x))));
  WA on windows of w x w tokens: `qkv`, q times head_dim^-0.5, q k^T,
  plus the bias table's rows at the relative position index, on odd j
  (the map rolled by -w/2 first and by +w/2 after) plus the region mask
  (0 within a region of the rolled map, -100 across), softmax, times v;
- LayerNorm `norm`, map, `conv_after_body` (a conv3) plus `conv_first`'s
  output; `conv_before_upsample.0` 3x3 and leaky ReLU 0.01; twice
  (nearest x2, conv, leaky ReLU 0.2) through `conv_up1`, `conv_up2`;
  `conv_hr`, leaky ReLU 0.2, `conv_last`; divided by `img_range`, plus
  the mean; cropped to 4x the input.

The position index and the mask are computed here for the size the
forward runs at and never read from `sd`.

Weights (`make_weights`, recipe `up["weights"]`, `init`
"trunc_normal_he"): the release's `params_ema` key set, in its order
(its `relative_position_index` and `attn_mask` buffers included, the
masks at `img_size`).  Every linear weight is normal with standard
deviation `linear_std`, truncated at two standard deviations, its bias
zero; every bias table the same with `table_std`; every LayerNorm 1 and
0; every conv kernel He-normal (sqrt(2 / fan_in)) times `conv_gain`,
its bias zero but `conv_last`'s, which is `conv_last_bias`.  One seeded
`torch.Generator` on the run's device draws the linears, then the
tables, then the convs, each in one call.

Work (`tile_flops`): 2 per multiply-add over the linears, q k^T, a v and
every conv, at the tile padded to the window (the tail at 2x and 4x
that); norms, softmax, GELU, adds and the gathers are not counted.
SwinIR-L (240, 9 x 6, 8 heads, window 8, MLP 480, 64-wide x4 tail)
comes to 61,339,104 an input pixel and 28,013,059 parameters.
"""

from __future__ import annotations

from collections import OrderedDict

import torch
import torch.nn.functional as F

RGB_MEAN = (0.4488, 0.4371, 0.4040)


def _dims(up: dict) -> dict:
    if up.get("resi_connection", "3conv") != "3conv" \
            or up.get("upsampler", "nearest+conv") != "nearest+conv" \
            or int(up["scale"]) != 4:
        raise ValueError("SwinIR stage: only resi_connection 3conv, "
                         "upsampler nearest+conv, scale 4")
    c = int(up["embed_dim"])
    return {"c": c, "depths": [int(d) for d in up["depths"]],
            "heads": [int(h) for h in up["num_heads"]],
            "ws": int(up["window_size"]),
            "hidden": int(c * float(up["mlp_ratio"])),
            "nf": int(up["num_feat"]), "cin": int(up.get("num_in_ch", 3)),
            "cout": int(up.get("num_out_ch", 3)),
            "img_range": float(up["img_range"])}


def entries(up: dict) -> list:
    """[(key, shape, kind)] of the release's state dict, in its order;
    kind is "linear", "bias", "table", "norm_w", "norm_b", "conv" (its
    fan-in is shape[1] x kh x kw), "index" or "mask" (the buffers)."""
    d = _dims(up)
    c, ws, hid = d["c"], d["ws"], d["hidden"]
    out = []

    def conv(name, co, ci, k):
        out.extend([(f"{name}.weight", (co, ci, k, k), "conv"),
                    (f"{name}.bias", (co,), "bias")])

    def linear(name, co, ci):
        out.extend([(f"{name}.weight", (co, ci), "linear"),
                    (f"{name}.bias", (co,), "bias")])

    def norm(name):
        out.extend([(f"{name}.weight", (c,), "norm_w"),
                    (f"{name}.bias", (c,), "norm_b")])

    def conv3(name):
        conv(f"{name}.0", c // 4, c, 3)
        conv(f"{name}.2", c // 4, c // 4, 1)
        conv(f"{name}.4", c, c // 4, 3)

    conv("conv_first", c, d["cin"], 3)
    norm("patch_embed.norm")
    n_win = (int(up["img_size"]) // ws) ** 2
    for i, (depth, heads) in enumerate(zip(d["depths"], d["heads"])):
        for j in range(depth):
            p = f"layers.{i}.residual_group.blocks.{j}"
            if j % 2:
                out.append((f"{p}.attn_mask", (n_win, ws * ws, ws * ws),
                            "mask"))
            norm(f"{p}.norm1")
            out.append((f"{p}.attn.relative_position_bias_table",
                        ((2 * ws - 1) ** 2, heads), "table"))
            out.append((f"{p}.attn.relative_position_index",
                        (ws * ws, ws * ws), "index"))
            linear(f"{p}.attn.qkv", 3 * c, c)
            linear(f"{p}.attn.proj", c, c)
            norm(f"{p}.norm2")
            linear(f"{p}.mlp.fc1", hid, c)
            linear(f"{p}.mlp.fc2", c, hid)
        conv3(f"layers.{i}.conv")
    norm("norm")
    conv3("conv_after_body")
    conv("conv_before_upsample.0", d["nf"], c, 3)
    for name in ("conv_up1", "conv_up2", "conv_hr"):
        conv(name, d["nf"], d["nf"], 3)
    conv("conv_last", d["cout"], d["nf"], 3)
    return out


def position_index(ws: int, device) -> torch.Tensor:
    """(ws^2, ws^2) int64: the bias table's row for each pair of tokens of
    a window (row-major within the window)."""
    r = torch.arange(ws, device=device)
    ys, xs = torch.meshgrid(r, r, indexing="ij")
    ys, xs = ys.reshape(-1), xs.reshape(-1)
    dy = ys[:, None] - ys[None, :] + ws - 1
    dx = xs[:, None] - xs[None, :] + ws - 1
    return dy * (2 * ws - 1) + dx


def windows(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, H, W, C) -> (B * H/ws * W/ws, ws * ws, C), windows in row-major
    order, tokens row-major within each."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, c)


def unwindows(y: torch.Tensor, ws: int, b: int, h: int,
              w: int) -> torch.Tensor:
    """The inverse of `windows`: (B, H, W, C)."""
    c = y.shape[-1]
    y = y.reshape(b, h // ws, w // ws, ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return y.reshape(b, h, w, c)


def region_mask(h: int, w: int, ws: int, shift: int, device,
                dtype=torch.float32) -> torch.Tensor:
    """(windows, ws^2, ws^2) of a shifted layer on the h x w map: 0 where
    two tokens of a window lie in one region of the rolled map, -100
    where not.  The regions are the 3 x 3 bands [0, h - ws),
    [h - ws, h - shift), [h - shift, h) of each axis."""
    def bands(n):
        k = torch.arange(n, device=device)
        return (k >= n - ws).long() + (k >= n - shift).long()
    region = bands(h)[:, None] * 3 + bands(w)[None, :]
    r = windows(region[None, :, :, None], ws)[..., 0]
    same = r[:, :, None] == r[:, None, :]
    zero = torch.zeros((), dtype=dtype, device=device)
    return torch.where(same, zero, torch.full((), -100.0, dtype=dtype,
                                              device=device))


def _conv(sd, name, x):
    w = sd[f"{name}.weight"]
    return F.conv2d(x, w, sd[f"{name}.bias"], padding=w.shape[-1] // 2)


def _norm(sd, name, x):
    return F.layer_norm(x, x.shape[-1:], sd[f"{name}.weight"],
                        sd[f"{name}.bias"])


def _linear(sd, name, x):
    return F.linear(x, sd[f"{name}.weight"], sd[f"{name}.bias"])


def _conv3(sd, name, x):
    x = F.leaky_relu(_conv(sd, f"{name}.0", x), 0.2)
    x = F.leaky_relu(_conv(sd, f"{name}.2", x), 0.2)
    return _conv(sd, f"{name}.4", x)


def _tokens(x):
    """(B, C, H, W) -> (B, H*W, C)."""
    return x.flatten(2).transpose(1, 2)


def _map(t, h, w):
    """(B, H*W, C) -> (B, C, H, W)."""
    return t.transpose(1, 2).reshape(t.shape[0], t.shape[2], h, w)


def _attention(sd, p, x, heads, index, mask):
    """Window attention of one layer on (windows, N, C) tokens."""
    bw, n, c = x.shape
    qkv = _linear(sd, f"{p}.qkv", x).reshape(bw, n, 3, heads, c // heads)
    q, k, v = qkv.permute(2, 0, 3, 1, 4)
    q = q * (c // heads) ** -0.5
    a = q @ k.transpose(-2, -1)
    table = sd[f"{p}.relative_position_bias_table"]
    a = a + table[index.reshape(-1)].reshape(n, n, heads).permute(
        2, 0, 1)[None]
    if mask is not None:
        nw = mask.shape[0]
        a = (a.reshape(bw // nw, nw, heads, n, n)
             + mask[None, :, None]).reshape(bw, heads, n, n)
    y = (torch.softmax(a, -1) @ v).transpose(1, 2).reshape(bw, n, c)
    return _linear(sd, f"{p}.proj", y)


def _swin_layer(sd, p, t, h, w, heads, ws, shift, index, mask):
    b, _, c = t.shape
    y = _norm(sd, f"{p}.norm1", t).reshape(b, h, w, c)
    if shift:
        y = torch.roll(y, (-shift, -shift), (1, 2))
    y = _attention(sd, f"{p}.attn", windows(y, ws), heads, index,
                   mask if shift else None)
    y = unwindows(y, ws, b, h, w)
    if shift:
        y = torch.roll(y, (shift, shift), (1, 2))
    t = t + y.reshape(b, h * w, c)
    hid = F.gelu(_linear(sd, f"{p}.mlp.fc1", _norm(sd, f"{p}.norm2", t)))
    return t + _linear(sd, f"{p}.mlp.fc2", hid)


def forward(sd: dict, x: torch.Tensor, up: dict) -> torch.Tensor:
    """(N, 3, h, w) float in [0, 1] -> (N, 3, 4h, 4w), in x's dtype."""
    d = _dims(up)
    ws, h, w = d["ws"], x.shape[2], x.shape[3]
    x = F.pad(x, (0, (ws - w % ws) % ws, 0, (ws - h % ws) % ws), "reflect")
    mean = torch.tensor(RGB_MEAN, dtype=x.dtype, device=x.device).reshape(
        1, 3, 1, 1)
    x = (x - mean) * d["img_range"]
    feat = _conv(sd, "conv_first", x)
    hp, wp = feat.shape[2:]
    index = position_index(ws, x.device)
    mask = region_mask(hp, wp, ws, ws // 2, x.device, x.dtype)
    t = _norm(sd, "patch_embed.norm", _tokens(feat))
    for i, (depth, heads) in enumerate(zip(d["depths"], d["heads"])):
        y = t
        for j in range(depth):
            y = _swin_layer(sd, f"layers.{i}.residual_group.blocks.{j}", y,
                            hp, wp, heads, ws, ws // 2 if j % 2 else 0,
                            index, mask)
        t = _tokens(_conv3(sd, f"layers.{i}.conv", _map(y, hp, wp))) + t
    t = _norm(sd, "norm", t)
    feat = _conv3(sd, "conv_after_body", _map(t, hp, wp)) + feat
    feat = F.leaky_relu(_conv(sd, "conv_before_upsample.0", feat), 0.01)
    for name in ("conv_up1", "conv_up2"):
        feat = F.leaky_relu(_conv(sd, name, F.interpolate(
            feat, scale_factor=2, mode="nearest")), 0.2)
    out = _conv(sd, "conv_last", F.leaky_relu(_conv(sd, "conv_hr", feat),
                                              0.2))
    return (out / d["img_range"] + mean)[:, :, :4 * h, :4 * w]


def make_weights(up: dict, seed: int, device) -> "OrderedDict":
    """The release-layout state dict of the recipe `up["weights"]`, drawn
    from `seed` on `device`."""
    rec = up["weights"]
    if rec.get("init") != "trunc_normal_he":
        raise ValueError(f"unknown weight init {rec.get('init')!r}")
    ents = entries(up)
    d = _dims(up)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    draws = {}
    for kind, std in (("linear", float(rec["linear_std"])),
                      ("table", float(rec["table_std"]))):
        n = sum(_numel(s) for _, s, k in ents if k == kind)
        draws[kind] = torch.nn.init.trunc_normal_(
            torch.empty(n, device=device), std=std, a=-2 * std, b=2 * std,
            generator=gen)
    convs = [(s, _numel(s)) for _, s, k in ents if k == "conv"]
    sizes = torch.tensor([n for _, n in convs], device=device)
    std = torch.tensor([float(rec["conv_gain"])
                        * (2.0 / (s[1] * s[2] * s[3])) ** 0.5
                        for s, _ in convs], device=device)
    flat = torch.randn(int(sizes.sum()), generator=gen, device=device)
    draws["conv"] = flat * torch.repeat_interleave(
        std, sizes, output_size=flat.numel())
    at = dict.fromkeys(draws, 0)
    index = position_index(d["ws"], device)
    n_img = int(up["img_size"])
    mask = region_mask(n_img, n_img, d["ws"], d["ws"] // 2, device)
    sd = OrderedDict()
    for key, shape, kind in ents:
        if kind in draws:
            n = _numel(shape)
            sd[key] = draws[kind][at[kind]:at[kind] + n].view(shape)
            at[kind] += n
        elif kind == "index":
            sd[key] = index.clone()
        elif kind == "mask":
            sd[key] = mask.clone()
        else:
            sd[key] = torch.full(shape, 1.0 if kind == "norm_w" else 0.0,
                                 device=device)
    sd["conv_last.bias"] = torch.full((d["cout"],),
                                      float(rec["conv_last_bias"]),
                                      device=device)
    return sd


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def tile_flops(up: dict, th: int, tw: int) -> float:
    """Operations (2 per multiply-add) of one forward over a th x tw tile,
    padded to the window."""
    d = _dims(up)
    c, ws, hid, nf = d["c"], d["ws"], d["hidden"], d["nf"]
    px = (-(-th // ws) * ws) * (-(-tw // ws) * ws)
    layers = sum(d["depths"])
    linear = 2 * (c * 3 * c + c * c + 2 * c * hid)
    attn = 2 * 2 * ws * ws * c
    conv3 = 2 * (9 * c * (c // 4) + (c // 4) ** 2 + 9 * (c // 4) * c)
    tail = 2 * 9 * (c * nf + nf * nf * 4 + nf * nf * 16 * 2
                    + nf * d["cout"] * 16)
    per_px = (layers * (linear + attn) + (len(d["depths"]) + 1) * conv3
              + 2 * 9 * d["cin"] * c + tail)
    return float(per_px * px)


def param_count(up: dict) -> int:
    """The weights (the buffers left out)."""
    return sum(_numel(s) for _, s, k in entries(up)
               if k not in ("index", "mask"))
