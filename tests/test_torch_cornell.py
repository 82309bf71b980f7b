"""The Cornell box (quads only, a quad light, no triangles) against the
JAX package's fused TPU kernel itself (pallas_path `_path_kernel`),
interpreted on the CPU: the port's plain renderer, u8-exact with equal
ray counts.  Its own file so that the test runner's workers take it
apart from the other interpreted cases.
"""

from dsrt_tpu_torch.config import RenderConfig
from dsrt_tpu_torch.models.presets import cornell_box_scene
from dsrt_tpu_torch.render import fused_kind
from test_torch_mixed_frames import FRAME, interpret_check


def test_cornell_box_matches_the_tpu_kernel_interpreted():
    scene = cornell_box_scene(device="cpu")
    assert scene.n_tris == 0 and scene.n_quads == 18
    assert fused_kind(scene, RenderConfig(**FRAME)) == "tri"
    interpret_check("cornell")
