"""Seeded weights for a configuration's upscale stage.

The benchmark makes the stage's weights from the run's seed, as it makes
the mesh, and hands the program a checkpoint file.  `make` draws them
through the architecture's file, `stages/<upscale.arch>.py`
(`make_weights`), from the recipe under the configuration's
`upscale.weights`, in the layout of the architecture's release file.

RRDBNet's recipe (`rrdbnet`): every conv kernel He-normal (standard
deviation sqrt(2 / fan_in), fan_in = input channels x 9) times `gain`,
every bias zero but `conv_last`'s, which is `conv_last_bias`, in a
basicsr-layout state dict (`conv_first`, `body.N.rdbJ.convI`,
`conv_body`, `conv_up1`, `conv_up2`, `conv_hr`, `conv_last`; OIHW
kernels, float32), the layout of Real-ESRGAN's release files.  The draws
are made on the run's device by one seeded `torch.Generator` in a few
large calls, so one seed gives one set of weights on one kind of device.
Imports nothing of the program.
"""

from __future__ import annotations

from collections import OrderedDict

import torch

from portbench import registry


def conv_shapes(up: dict) -> list:
    """[(name, out channels, in channels)] of every 3x3 conv, in the
    state dict's order."""
    nf, gc = int(up["num_feat"]), int(up["num_grow_ch"])
    scale = int(up["scale"])
    cin = int(up.get("num_in_ch", 3)) * {4: 1, 2: 4, 1: 16}[scale]
    out = [("conv_first", nf, cin)]
    for n in range(int(up["num_block"])):
        for j in range(3):
            for i in range(5):
                out.append((f"body.{n}.rdb{j + 1}.conv{i + 1}",
                            gc if i < 4 else nf, nf + i * gc))
    out += [(name, nf, nf) for name in
            ("conv_body", "conv_up1", "conv_up2", "conv_hr")]
    out.append(("conv_last", int(up.get("num_out_ch", 3)), nf))
    return out


def make(up: dict, seed: int, device,
         root=registry.REPO) -> "OrderedDict[str, torch.Tensor]":
    """The state dict of the recipe `up["weights"]` drawn from `seed` on
    `device` by the architecture `up["arch"]` of the benchmark under
    `root` (ValueError naming the file looked for where it has none)."""
    return registry.stage(up.get("arch"), root).make_weights(up, seed,
                                                             device)


def rrdbnet(up: dict, seed: int, device) -> "OrderedDict[str, torch.Tensor]":
    """RRDBNet's state dict of the recipe `up["weights"]` drawn from
    `seed` on `device`."""
    rec = up["weights"]
    if rec.get("init") != "he_normal":
        raise ValueError(f"unknown weight init {rec.get('init')!r}")
    shapes = conv_shapes(up)
    sizes = [co * ci * 9 for _, co, ci in shapes]
    std = torch.tensor([float(rec["gain"]) * (2.0 / (ci * 9)) ** 0.5
                        for _, _, ci in shapes], device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    flat = torch.randn(sum(sizes), generator=gen, device=device,
                       dtype=torch.float32)
    flat *= torch.repeat_interleave(
        std, torch.tensor(sizes, device=device), output_size=sum(sizes))
    bias = torch.zeros(sum(co for _, co, _ in shapes), device=device)
    n_last = shapes[-1][1]
    bias[-n_last:] = float(rec["conv_last_bias"])
    sd = OrderedDict()
    w_at = b_at = 0
    for (name, co, ci), n in zip(shapes, sizes):
        sd[f"{name}.weight"] = flat[w_at:w_at + n].view(co, ci, 3, 3)
        sd[f"{name}.bias"] = bias[b_at:b_at + co]
        w_at, b_at = w_at + n, b_at + co
    return sd


def write(up: dict, seed: int, device, path: str,
          root=registry.REPO) -> str:
    """Write the seeded checkpoint (`make`) to `path`; returns `path`."""
    torch.save(make(up, seed, device, root), path)
    return path


def load(path: str, device) -> "OrderedDict[str, torch.Tensor]":
    """The state dict of a checkpoint `write` made, on `device`."""
    return torch.load(path, map_location=device, weights_only=True)
