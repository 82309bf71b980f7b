"""RRDBNet, the Real-ESRGAN generator (basicsr's layout), as an upscale
stage's architecture: `upscale.arch` "RRDBNet" with `num_feat`,
`num_block`, `num_grow_ch`, `scale` (4, 2 or 1) and optionally
`num_in_ch`, `num_out_ch`.  Each function is the benchmark's RRDBNet code
as it stands: the seeded recipe and draw order of `weights.rrdbnet`, the
plain reference `reference_esrgan.forward`, the work count of
`work_esrgan.flops_per_input_pixel`.  Imports nothing of the program."""

from portbench import reference_esrgan, weights, work_esrgan


def make_weights(up, seed, device):
    return weights.rrdbnet(up, seed, device)


def forward(sd, x, up):
    return reference_esrgan.forward(sd, x, int(up["num_block"]),
                                    int(up["scale"]))


def tile_flops(up, th, tw):
    return work_esrgan.flops_per_input_pixel(up) * th * tw


def param_count(up):
    return sum(co * (ci * 9 + 1) for _, co, ci in weights.conv_shapes(up))
