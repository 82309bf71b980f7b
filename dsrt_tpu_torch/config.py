"""Render configuration.

A copy of dsrt_tpu/config.py: the port imports nothing of the JAX package.

The reference scatters its knobs across compile-time constants
(src/main.cpp:254-267, src/gpu_scene_builder.cpp:560-598,
src/gpu_render.cu:732, 1013) and a `GPURenderParams` struct whose fields are
mostly set-but-never-read (inc/gpu_scene.h:96-111).  Here every knob is a
field of one dataclass with the reference's defaults, promoted to a real
config per SURVEY.md §5.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class SunConfig:
    """Directional sun light.

    `direction` is the model-frame ISS→Sun direction as documented at
    reference inc/gpu_scene.h:171.  NOTE the reference kernel negates it
    before use (src/gpu_render.cu:802-806), so shadow rays actually travel
    along -direction; we reproduce that verbatim in ops/shade.py.

    `radiance` default matches src/gpu_scene_builder.cpp:598.
    """

    enabled: bool = True
    direction: Tuple[float, float, float] = (0.0, 1.0, 0.0)
    radiance: Tuple[float, float, float] = (100000.0, 95000.0, 90000.0)


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """All render knobs with reference defaults.

    width/height/spp/max_depth/vfov/aperture: src/main.cpp:254-260.
    gamma: src/gpu_scene_builder.cpp:579.  seed: :585.
    firefly_clamp: src/gpu_render.cu:1013.
    rr_start_depth / rr_max_p: src/gpu_render.cu:732-735.
    hit_eps / hit_tmax: src/gpu_render.cu:744 (t range [1e-3, 1e9]).
    shadow_bias: src/gpu_render.cu:812.
    background: black (src/gpu_render.cu:744-747).
    max_depth fallback 12 when <=0: src/gpu_render.cu:723-725.
    """

    width: int = 800
    height: int = 450
    spp: int = 1000
    max_depth: int = 50
    vfov: float = 40.0
    aperture: float = 0.0
    gamma: float = 2.0
    exposure: float = 50.0  # plumbed but dead in the reference; kept for parity
    seed: int = 1337
    firefly_clamp: float = 10.0
    rr_start_depth: int = 5
    rr_max_p: float = 0.95
    hit_eps: float = 1e-3
    hit_tmax: float = 1e9
    shadow_bias: float = 1e-3
    background: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    sun: SunConfig = dataclasses.field(default_factory=SunConfig)
    # Camera shutter interval for motion blur (the book's camera time
    # sampling; the reference's CPU scene graph stores a moving-sphere
    # center ray, inc/sphere.h:143-146, which its GPU path ignores).
    # time1 > time0 adds ONE extra raygen draw per sample (after jitter
    # and aperture) — zero-shutter configs keep the exact legacy stream.
    time0: float = 0.0
    time1: float = 0.0

    # Debug/flat-shade sky (the reference's SkyType enum, inc/gpu_scene.h:
    # 90-94, consumed only by ray_color_debug, src/gpu_render.cu:663-710;
    # the path tracer always uses the black `background`).  The builder
    # hardcodes solid black (src/gpu_scene_builder.cpp:562-568).
    sky_type: str = "solid"          # "solid" | "gradient"
    sky_solid: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    sky_top: Tuple[float, float, float] = (0.5, 0.7, 1.0)
    sky_bottom: Tuple[float, float, float] = (1.0, 1.0, 1.0)

    # TPU execution knobs (no reference analogue).
    packet_size: int = 1024     # rays per traversal packet (8x128 VPU tile)
    spp_chunk: int = 0          # 0 = auto; samples evaluated per device pass

    def resolved_max_depth(self) -> int:
        return self.max_depth if self.max_depth > 0 else 12

    def resolved_spp(self) -> int:
        return max(1, self.spp)
