"""SwinIR (Liang et al., "SwinIR: Image Restoration Using Swin
Transformer", arXiv:2108.10257) in PyTorch: the real-world x4 network,
with the module names of the release's `network_swinir.py`, so that a
release state dict (`params_ema` of
`003_realSR_BSRGAN_DFOWMFC_s64w8_SwinIR-L_x4_GAN.pth`, SwinIR-L: 240
wide, 9 RSTBs of 6 layers, 8 heads, window 8, MLP ratio 2) loads with
`load_state_dict` once its position-index and mask buffers are dropped.

The network (`resi_connection` "3conv", `upsampler` "nearest+conv",
`img_range` 1, patch norm on):

- reflect-pad the input to a multiple of the window, subtract the RGB
  mean; `conv_first` (3 -> C, 3x3); `patch_embed`: tokens, LayerNorm;
- each RSTB: x + patch_embed(conv3(unembed(its Swin layers(x)))), the
  embed without a norm; conv3 is conv C -> C/4 3x3, leaky ReLU 0.2,
  conv C/4 -> C/4 1x1, leaky ReLU 0.2, conv C/4 -> C 3x3;
- a Swin layer: x + WA(LN1(x)), then x + fc2(GELU(fc1(LN2(x)))); WA is
  attention inside windows of w x w tokens: `qkv`, q scaled by
  head_dim^-0.5, q k^T, plus the relative position bias gathered from a
  (2w-1)^2 x heads table, on every second layer (the map first rolled by
  -w/2 on both axes and rolled back after) plus the region mask (0 or
  -100), softmax, times v, `proj`;
- after the body a LayerNorm, unembed, `conv_after_body` (a conv3) plus
  the long skip from `conv_first`;
- `conv_before_upsample` (C -> 64 3x3, LeakyReLU at slope 0.01), then
  the x4 tail that RRDBNet has too (`esrgan.x4_tail`); add the mean back
  and crop.

The position index and the region mask are computed here for the size a
forward runs at and kept per size and device (`_masks`), whatever the
file holds.  Each RSTB of a forward is a span `swin_rstb`, and the
attention core of each layer (q, k, v to the heads' output before
`proj`) a span `swin_attn` inside it (`utils/timing.span`).  The window
attention is plain PyTorch in the release's order; the forward runs in
float32 inside `esrgan.fp32_scope`, as the stage runs every network.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from dsrt_tpu_torch.device import resolve_device
from dsrt_tpu_torch.models.esrgan import x4_tail
from dsrt_tpu_torch.utils import timing

RGB_MEAN = (0.4488, 0.4371, 0.4040)
MASK_FILL = -100.0
CONV3_SLOPE = 0.2
BEFORE_UPSAMPLE_SLOPE = 0.01
# buffers of the release's modules that this module recomputes
DERIVED_KEYS = ("relative_position_index", "attn_mask")


def position_index(ws: int, device) -> torch.Tensor:
    """(ws*ws, ws*ws) int64: the row of the bias table for each pair of
    tokens in a window, as the release computes it."""
    coords = torch.stack(torch.meshgrid(
        torch.arange(ws, device=device), torch.arange(ws, device=device),
        indexing="ij")).flatten(1)
    rel = (coords[:, :, None] - coords[:, None, :]).permute(1, 2, 0)
    return (rel[..., 0] + ws - 1) * (2 * ws - 1) + rel[..., 1] + ws - 1


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, H, W, C) -> (B * H/ws * W/ws, ws, ws, C)."""
    b, h, w, c = x.shape
    x = x.view(b, h // ws, ws, w // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).contiguous().view(-1, ws, ws, c)


def window_reverse(windows: torch.Tensor, ws: int, h: int,
                   w: int) -> torch.Tensor:
    """The inverse of `window_partition`: (B, H, W, C)."""
    b = windows.shape[0] // ((h // ws) * (w // ws))
    x = windows.view(b, h // ws, w // ws, ws, ws, -1)
    return x.permute(0, 1, 3, 2, 4, 5).contiguous().view(b, h, w, -1)


def region_mask(h: int, w: int, ws: int, shift: int,
                device) -> torch.Tensor:
    """(windows, ws*ws, ws*ws) float32 of a shifted layer on an h x w map:
    0 between tokens of one region of the rolled map, MASK_FILL across
    regions."""
    img = torch.zeros((1, h, w, 1), device=device)
    cnt = 0
    cuts = (slice(0, -ws), slice(-ws, -shift), slice(-shift, None))
    for hs in cuts:
        for wsl in cuts:
            img[:, hs, wsl, :] = cnt
            cnt += 1
    win = window_partition(img, ws).view(-1, ws * ws)
    diff = win.unsqueeze(1) - win.unsqueeze(2)
    return diff.masked_fill(diff != 0, MASK_FILL).masked_fill(diff == 0, 0.0)


def conv3(dim: int) -> nn.Sequential:
    """The "3conv" residual connection: C -> C/4 3x3, lrelu, C/4 -> C/4
    1x1, lrelu, C/4 -> C 3x3."""
    q = dim // 4
    return nn.Sequential(nn.Conv2d(dim, q, 3, 1, 1),
                         nn.LeakyReLU(CONV3_SLOPE),
                         nn.Conv2d(q, q, 1, 1, 0),
                         nn.LeakyReLU(CONV3_SLOPE),
                         nn.Conv2d(q, dim, 3, 1, 1))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class WindowAttention(nn.Module):
    """Multi-head self-attention inside each window of ws x ws tokens,
    with the relative position bias and, on a shifted layer, the region
    mask."""

    def __init__(self, dim: int, ws: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.scale = (dim // num_heads) ** -0.5
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * ws - 1) ** 2, num_heads))
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x, index, mask=None):
        """(windows, N, C) -> (windows, N, C); `index` (N, N) rows of the
        bias table, `mask` (windows of one image, N, N) or None."""
        bw, n, c = x.shape
        qkv = self.qkv(x).reshape(bw, n, 3, self.num_heads,
                                  c // self.num_heads).permute(2, 0, 3, 1, 4)
        with timing.span("swin_attn"):
            q, k, v = qkv[0], qkv[1], qkv[2]
            attn = (q * self.scale) @ k.transpose(-2, -1)
            bias = self.relative_position_bias_table[index.view(-1)].view(
                n, n, -1).permute(2, 0, 1).contiguous()
            attn = attn + bias.unsqueeze(0)
            if mask is not None:
                nw = mask.shape[0]
                attn = (attn.view(bw // nw, nw, self.num_heads, n, n)
                        + mask.unsqueeze(1).unsqueeze(0)).view(
                            -1, self.num_heads, n, n)
            x = (attn.softmax(-1) @ v).transpose(1, 2).reshape(bw, n, c)
        return self.proj(x)


class SwinLayer(nn.Module):
    """One Swin layer (the release's `SwinTransformerBlock`): window
    attention on the map rolled by -shift, then the MLP, each after a
    LayerNorm and added to its input."""

    def __init__(self, dim: int, ws: int, num_heads: int, hidden: int,
                 shift: int):
        super().__init__()
        self.ws, self.shift = ws, shift
        self.norm1 = nn.LayerNorm(dim)
        self.attn = WindowAttention(dim, ws, num_heads)
        self.norm2 = nn.LayerNorm(dim)
        self.mlp = Mlp(dim, hidden)

    def forward(self, x, size, index, mask):
        h, w = size
        b, _, c = x.shape
        ws, s = self.ws, self.shift
        y = self.norm1(x).view(b, h, w, c)
        if s:
            y = torch.roll(y, shifts=(-s, -s), dims=(1, 2))
        y = window_partition(y, ws).view(-1, ws * ws, c)
        y = self.attn(y, index, mask if s else None)
        y = window_reverse(y.view(-1, ws, ws, c), ws, h, w)
        if s:
            y = torch.roll(y, shifts=(s, s), dims=(1, 2))
        x = x + y.view(b, h * w, c)
        return x + self.mlp(self.norm2(x))


class BasicLayer(nn.Module):
    """An RSTB's Swin layers, every second one shifted by ws // 2."""

    def __init__(self, dim: int, depth: int, ws: int, num_heads: int,
                 hidden: int):
        super().__init__()
        self.blocks = nn.ModuleList(
            SwinLayer(dim, ws, num_heads, hidden, 0 if j % 2 == 0 else ws // 2)
            for j in range(depth))

    def forward(self, x, size, index, mask):
        for blk in self.blocks:
            x = blk(x, size, index, mask)
        return x


class RSTB(nn.Module):
    """Residual Swin Transformer block: Swin layers, then a conv3 on the
    map, added to the block's input."""

    def __init__(self, dim: int, depth: int, ws: int, num_heads: int,
                 hidden: int):
        super().__init__()
        self.residual_group = BasicLayer(dim, depth, ws, num_heads, hidden)
        self.conv = conv3(dim)

    def forward(self, x, size, index, mask):
        y = self.residual_group(x, size, index, mask)
        return tokens(self.conv(unembed(y, size))) + x


class PatchEmbed(nn.Module):
    """The map as tokens (B, H*W, C), then a LayerNorm."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = nn.LayerNorm(dim)

    def forward(self, x):
        return self.norm(tokens(x))


def tokens(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, H*W, C)."""
    return x.flatten(2).transpose(1, 2)


def unembed(x: torch.Tensor, size) -> torch.Tensor:
    """(B, H*W, C) -> (B, C, H, W)."""
    return x.transpose(1, 2).reshape(x.shape[0], x.shape[2], *size)


class SwinIR(nn.Module):
    """NCHW float in [0, 1] -> NCHW, 4x the size: SwinIR with a "3conv"
    residual connection and the "nearest+conv" x4 tail."""

    scale = 4

    def __init__(self, in_chans: int = 3, embed_dim: int = 240,
                 depths=(6,) * 9, num_heads=(8,) * 9, window_size: int = 8,
                 mlp_ratio: float = 2.0, num_feat: int = 64):
        super().__init__()
        if in_chans != len(RGB_MEAN):
            raise ValueError(f"in_chans {in_chans}: SwinIR's mean is RGB")
        self.window_size = window_size
        self.register_buffer("mean", torch.tensor(RGB_MEAN).view(1, 3, 1, 1),
                             persistent=False)
        hidden = int(embed_dim * mlp_ratio)
        self.conv_first = nn.Conv2d(in_chans, embed_dim, 3, 1, 1)
        self.patch_embed = PatchEmbed(embed_dim)
        self.layers = nn.ModuleList(
            RSTB(embed_dim, d, window_size, h, hidden)
            for d, h in zip(depths, num_heads))
        self.norm = nn.LayerNorm(embed_dim)
        self.conv_after_body = conv3(embed_dim)
        self.conv_before_upsample = nn.Sequential(
            nn.Conv2d(embed_dim, num_feat, 3, 1, 1),
            nn.LeakyReLU(BEFORE_UPSAMPLE_SLOPE))
        self.conv_up1 = nn.Conv2d(num_feat, num_feat, 3, 1, 1)
        self.conv_up2 = nn.Conv2d(num_feat, num_feat, 3, 1, 1)
        self.conv_hr = nn.Conv2d(num_feat, num_feat, 3, 1, 1)
        self.conv_last = nn.Conv2d(num_feat, in_chans, 3, 1, 1)
        # (h, w, device) -> (position index, region mask) of that size
        self._masks = {}

    def masks(self, h: int, w: int, device):
        """The position index and the region mask of an h x w map on
        `device`, made at the first forward of that size."""
        key = (h, w, str(device))
        if key not in self._masks:
            ws = self.window_size
            self._masks[key] = (position_index(ws, device),
                                region_mask(h, w, ws, ws // 2, device))
        return self._masks[key]

    def tile_bytes(self, th: int, tw: int) -> int:
        """Device bytes one th x tw tile takes at once in a forward: in
        the body, at the tile's tokens, four float32 copies of the stream,
        `qkv`, the attention scores and their softmax, and the MLP's
        hidden layer and its GELU; in the tail, four float32 activations
        of its width at the output size."""
        ws = self.window_size
        t = -(-th // ws) * ws * -(-tw // ws) * ws
        c = self.norm.normalized_shape[0]
        heads = max(layer.residual_group.blocks[0].attn.num_heads
                    for layer in self.layers)
        hidden = self.layers[0].residual_group.blocks[0].mlp.fc1.out_features
        body = t * (4 * c + 3 * c + 2 * ws * ws * heads + 2 * hidden)
        tail = 4 * self.conv_hr.out_channels * (self.scale ** 2) * th * tw
        return 4 * (body + tail)

    def forward(self, x):
        h, w = x.shape[2:]
        ws = self.window_size
        x = F.pad(x, (0, (ws - w % ws) % ws, 0, (ws - h % ws) % ws),
                  "reflect")
        x = x - self.mean
        feat = self.conv_first(x)
        size = tuple(feat.shape[2:])
        index, mask = self.masks(*size, feat.device)
        y = self.patch_embed(feat)
        for layer in self.layers:
            with timing.span("swin_rstb"):
                y = layer(y, size, index, mask)
        feat = self.conv_after_body(unembed(self.norm(y), size)) + feat
        # the body's maps are let go before the tail's 4x maps are made
        del y
        feat = self.conv_before_upsample(feat)
        out = x4_tail(self, feat) + self.mean
        return out[:, :, :h * self.scale, :w * self.scale]


def from_state_dict(sd: dict, scale: int = 4, device=None) -> SwinIR:
    """The SwinIR whose weights `sd` holds (the release's layout), its
    widths read from the tensors' shapes: the window from the bias
    table's rows, the MLP ratio from `fc1`, the depths and heads from the
    keys.  The file's position-index and mask buffers are dropped.  The
    modules are made on the meta device and take the file's tensors as
    they are, so no weight is drawn and then overwritten.  Only the
    "3conv" / "nearest+conv" x4 variant runs: another raises a
    ValueError naming the key it lacks."""
    for key in ("layers.0.conv.0.weight", "conv_before_upsample.0.weight",
                "conv_up2.weight", "patch_embed.norm.weight"):
        if key not in sd:
            raise ValueError(f"SwinIR checkpoint without {key!r}: only the "
                             "3conv, nearest+conv x4 variant is run")
    if scale != SwinIR.scale:
        raise ValueError(f"scale {scale}: SwinIR's nearest+conv tail is x4")
    sd = {k: v for k, v in sd.items()
          if k.rsplit(".", 1)[-1] not in DERIVED_KEYS}
    depths, heads = [], []
    i = 0
    while f"layers.{i}.conv.0.weight" in sd:
        blk = f"layers.{i}.residual_group.blocks"
        depths.append(sum(1 for k in sd if k.startswith(f"{blk}.")
                          and k.endswith(".norm1.weight")))
        heads.append(sd[f"{blk}.0.attn.relative_position_bias_table"]
                     .shape[1])
        i += 1
    table = sd["layers.0.residual_group.blocks.0.attn."
               "relative_position_bias_table"].shape[0]
    ws = (round(table ** 0.5) + 1) // 2
    embed_dim, in_chans = sd["conv_first.weight"].shape[:2]
    fc1 = sd["layers.0.residual_group.blocks.0.mlp.fc1.weight"].shape[0]
    with torch.device("meta"):
        net = SwinIR(in_chans=in_chans, embed_dim=embed_dim, depths=depths,
                     num_heads=heads, window_size=ws,
                     mlp_ratio=fc1 / embed_dim,
                     num_feat=sd["conv_before_upsample.0.weight"].shape[0])
    net.load_state_dict(sd, assign=True)
    net.mean = torch.tensor(RGB_MEAN).view(1, 3, 1, 1)
    return net.to(resolve_device(device)).eval()
