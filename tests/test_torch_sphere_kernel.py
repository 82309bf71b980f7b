"""The sphere kernel's frame entry on the CPU: its plain version against
the JAX sphere megakernel itself (pallas_sphere._sphere_kernel run in
interpret mode), the kernel's parameter packing, the routing of
render_frame_fused, the salted-chunk schedule, and scenes and cameras
carried across from the JAX package.

Tolerance against the JAX kernel: u8-exact on rtiow_smoke_scene; at
least 99% identical pixels and mean |d| <= 0.5 u8 on volumetric_scene
(the free path's log is taken in float64 by the port and in float32 by
the JAX kernel; measured: identical); the exact ray count equal to the
JAX kernel's stats column 0 on both.
"""

import dataclasses

import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from dsrt_tpu.config import RenderConfig
from dsrt_tpu.models import presets as jpresets
from dsrt_tpu.ops.camera import make_camera as jmake_camera
from dsrt_tpu.render import render_frame_fused as jrender_fused
from dsrt_tpu_torch.models import presets as tpresets
from dsrt_tpu_torch.models.scene import SceneBuilder, scene_from_reference
from dsrt_tpu_torch.ops import sphere_kernel as sk
from dsrt_tpu_torch.ops.camera import camera_from_reference, make_camera
from dsrt_tpu_torch.ops.shade import sun_direction
from dsrt_tpu_torch.render import (fused_chunk_spp, fused_kind,
                                   render_accum_fused, render_frame,
                                   render_frame_fused)
from dsrt_tpu.models.materials import Material
from test_torch_render import assert_images_match

CFG = RenderConfig(width=32, height=16, spp=2, max_depth=6)
LOOK = ((0.0, 0.6, 2.0), (0.0, 0.0, -1.0))


@pytest.mark.parametrize("name", ["rtiow_smoke_scene", "volumetric_scene"])
def test_matches_jax_sphere_kernel_in_interpret_mode(name):
    kw = dict(vfov=50, width=CFG.width, height=CFG.height)
    with pltpu.force_tpu_interpret_mode():
        want, want_rays = jrender_fused(getattr(jpresets, name)(),
                                        jmake_camera(*LOOK, **kw), CFG,
                                        with_count=True)
    got, rays = render_frame_fused(getattr(tpresets, name)(device="cpu"),
                                   make_camera(*LOOK, **kw, device="cpu"), CFG,
                                   with_count=True)
    assert (got > 0).mean() > 0.2
    if name == "rtiow_smoke_scene":
        np.testing.assert_array_equal(got, want)
    else:
        assert_images_match(got, want)
    assert rays == want_rays


def test_parameter_vector_layout():
    """sph stride 8 (c0, r, mat, c2), med stride 15, lit stride 4, the
    19-float camera, then Ldir normalised by a reciprocal multiply,
    radiance and shadow bias (pallas_sphere.trace_fused_spheres)."""
    s = tpresets.volumetric_scene(device="cpu")
    cfg = dataclasses.replace(CFG, aperture=0.3)
    cam = make_camera(*LOOK, vfov=50, width=32, height=16, aperture=0.3,
                      device="cpu")
    vec = sk.pack_params(s, cam, cfg)
    assert vec.numel() == sk.PARAM_LEN == 247 and vec.dtype == torch.float32
    ns = s.n_spheres
    sph = vec[:8 * sk.MAX_SPH].reshape(sk.MAX_SPH, 8)
    assert torch.equal(sph[:ns, 0:3], s.sph_center)
    assert torch.equal(sph[:ns, 3], s.sph_radius)
    assert sph[:ns, 4].tolist() == s.sph_mat.tolist()
    assert torch.equal(sph[:ns, 5:8], s.sph_center2)
    assert not sph[ns:].any()
    med = vec[128:128 + 15 * sk.MAX_MED].reshape(sk.MAX_MED, 15)
    assert med[0].tolist() == (
        [0.0] + s.med_center[0].tolist() + [s.med_radius[0].item()]
        + s.med_min[0].tolist() + s.med_max[0].tolist()
        + [s.med_neg_inv_density[0].item()] + s.med_albedo[0].tolist())
    lit = vec[188:188 + 4 * sk.MAX_LIGHTS].reshape(sk.MAX_LIGHTS, 4)
    li = int(s.light_idx[0])
    assert lit[0].tolist() == s.sph_center[li].tolist() + [
        s.sph_radius[li].item()]
    assert torch.equal(vec[220:239], cam.vector())
    assert float(vec[238]) == pytest.approx(0.15)
    sd = sun_direction(s)
    assert vec[239:242].tolist() == [float(c) for c in sd]
    assert torch.equal(vec[242:245], s.sun_radiance)
    assert float(vec[245]) == np.float32(cfg.shadow_bias)


def test_launch_flags_follow_the_reference():
    """The shutter draw happens whenever time1 > time0, moving spheres or
    not; the centre lerp only with moving spheres."""
    cam = make_camera(*LOOK, vfov=50, width=32, height=16,
                      device="cpu")
    flag = lambda s, cfg: sk.launch_scalars(s, cam, cfg, 2)[0][-1]
    rt, vol, dof = (tpresets.rtiow_smoke_scene(device="cpu"),
                    tpresets.volumetric_scene(device="cpu"),
                    tpresets.dof_motion_scene(sun=True, device="cpu"))
    shutter = dataclasses.replace(CFG, time0=0.2, time1=0.8)
    assert flag(rt, CFG) == sk.SUN_ON
    assert flag(rt, shutter) == sk.SUN_ON | sk.SHUTTER
    assert flag(vol, CFG) == sk.SUN_ON | sk.PTEX
    assert flag(dof, dataclasses.replace(shutter, aperture=0.2)) == (
        sk.SUN_ON | sk.APERTURE | sk.SHUTTER | sk.MOVING)
    ints, floats = sk.launch_scalars(dof, cam, shutter, 3, salt=0x9E3779B9)
    assert ints[4:7] == [3, 0x9E3779B9 - (1 << 32), 1337]
    assert floats[5:] == [np.float32(0.2), np.float32(0.6)]


def _mixed_scene():
    b = SceneBuilder(seed=1337)
    b.add_sphere((0.0, 0.0, -1.0), 0.5, Material.lambertian())
    b.add_triangle((-1.0, -1.0, -2.0), (1.0, -1.0, -2.0), (0.0, 1.0, -2.0),
                   Material.lambertian())
    return b.build(device="cpu")


def test_frames_route_to_the_kernel_that_covers_them():
    rt = tpresets.rtiow_smoke_scene(device="cpu")
    assert fused_kind(rt, CFG) == "sphere"
    tri = tpresets.single_triangle_scene(device="cpu")
    assert fused_kind(tri, CFG) == "tri"
    # spheres among triangles: the path kernel
    mixed = _mixed_scene()
    assert fused_kind(mixed, CFG) == "tri"
    cam = make_camera(*LOOK, vfov=50, width=32, height=16,
                      device="cpu")
    np.testing.assert_array_equal(render_frame_fused(mixed, cam, CFG),
                                  render_frame(mixed, cam, CFG))
    # over the kernel's sphere limit
    b = SceneBuilder(seed=1337)
    for i in range(sk.MAX_SPH + 1):
        b.add_sphere((0.1 * i, 0.0, -1.0), 0.05, Material.lambertian())
    many = b.build(device="cpu")
    assert not sk.sphere_fused_supported(many, CFG)
    with pytest.raises(NotImplementedError, match="16 spheres"):
        sk.sphere_render(many, cam, CFG)
    # a CPU sphere scene through the entry point is the plain renderer
    np.testing.assert_array_equal(render_frame_fused(rt, cam, CFG),
                                  render_frame(rt, cam, CFG))


def test_sphere_frames_render_in_salted_chunks():
    s = tpresets.volumetric_scene(device="cpu")
    cfg = RenderConfig(width=16, height=12, spp=5, max_depth=4)
    cam = make_camera(*LOOK, vfov=50, width=16, height=12,
                      device="cpu")
    budget = 16 * 12 * 2
    assert fused_chunk_spp(cfg, budget) == 2
    acc, n = render_accum_fused(s, cam, cfg, budget)
    parts = [sk.sphere_render_plain(s, cam, cfg, k, salt)
             for k, salt in ((2, 0), (2, 0x9E3779B9),
                             (1, (2 * 0x9E3779B9) & 0xFFFFFFFF))]
    assert torch.equal(acc, parts[0][0] + parts[1][0] + parts[2][0])
    assert int(n) == sum(int(p[1]) for p in parts)


def test_scene_and_camera_from_reference_render_like_the_ports_own():
    """The JAX scene's arrays and the JAX thin-lens camera, carried across
    as numpy, give the image of the port's own builder."""
    cfg = dataclasses.replace(CFG, aperture=0.25, time0=0.0, time1=1.0)
    kw = dict(vfov=60, width=32, height=16, aperture=0.25)
    look = ((0.0, 0.4, 1.2), (0.0, 0.0, -1.0))
    from test_fused_spheres import _dof_motion_scene
    for js, ts in ((_dof_motion_scene(sun=True),
                    tpresets.dof_motion_scene(sun=True, device="cpu")),
                   (jpresets.volumetric_scene(),
                    tpresets.volumetric_scene(device="cpu"))):
        carried = render_frame_fused(
            scene_from_reference(js, device="cpu"),
            camera_from_reference(jmake_camera(*look, **kw), device="cpu"),
            cfg)
        own = render_frame_fused(ts, make_camera(*look, **kw, device="cpu"),
                                 cfg)
        assert (own > 0).mean() > 0.05
        np.testing.assert_array_equal(carried, own)
