"""dsrt_tpu_torch — the Deep-Space Ray Tracer on PyTorch and CUDA.

A port of `dsrt_tpu` (the JAX reference, which stays beside it) for an
NVIDIA H100.  The flagship frame path — stand-in or OBJ triangle scene,
directional sun, image textures, pinhole camera — runs through one
hand-written CUDA megakernel (csrc/path_kernel.cu, one thread per pixel),
and every kernel has a plain PyTorch version that the CPU tests hold
against the JAX reference.

The package imports torch and never jax; it reuses the JAX-free host
modules of dsrt_tpu (config, materials, OBJ loader, textures, BVH
builder, mesh generator, image I/O, poses, orbit CLI).
"""

__version__ = "0.1.0"

from dsrt_tpu.config import RenderConfig, SunConfig  # noqa: F401


def __getattr__(name):
    """Lazy convenience exports (torch is imported on first use)."""
    lazy = {
        "render_frame": ("dsrt_tpu_torch.render", "render_frame"),
        "render_frame_fused": ("dsrt_tpu_torch.render", "render_frame_fused"),
        "make_camera": ("dsrt_tpu_torch.ops.camera", "make_camera"),
        "point_camera_at": ("dsrt_tpu_torch.ops.camera", "point_camera_at"),
        "SceneBuilder": ("dsrt_tpu_torch.models.scene", "SceneBuilder"),
        "iss_standin_scene": ("dsrt_tpu_torch.models.mesh_gen",
                              "iss_standin_scene"),
        "Material": ("dsrt_tpu.models.materials", "Material"),
        "load_obj": ("dsrt_tpu.models.obj", "load_obj"),
    }
    if name in lazy:
        import importlib
        mod, attr = lazy[name]
        return getattr(importlib.import_module(mod), attr)
    raise AttributeError(name)
