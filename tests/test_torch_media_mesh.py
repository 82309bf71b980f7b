"""A mesh inside two constant media (box and sphere) beside a sphere
light against the JAX package's fused TPU kernel itself (pallas_path
`_path_kernel`), interpreted on the CPU: the port's plain renderer,
u8-exact with equal ray counts (media draws, shadow-query media draws
and the light mixture on one LCG stream).  Its own file so that the test
runner's workers take it apart from the other interpreted cases.
"""

from test_torch_mixed_frames import interpret_check


def test_mesh_media_light_matches_the_tpu_kernel_interpreted():
    interpret_check("mesh_media_light")
