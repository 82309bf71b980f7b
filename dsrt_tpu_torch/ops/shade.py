"""Plain path tracing over tensors of rays (port of dsrt_tpu/ops/shade.py).

`bounce_step` is one path segment for every lane:

0. Russian roulette from depth >= rr_start_depth (1 draw).
1. Closest hit in [hit_eps, hit_tmax]: triangles, spheres, then media
   (one draw per medium).  A miss adds thr * sky (black without an
   environment map) and terminates.
   A medium hit scatters: thr *= medium albedo, new direction
   normalize(random_in_unit_sphere) (3 draws per attempt).
2. diffuse_light: L += thr * emissive, terminate.
3. albedo = material albedo x image texel, or the procedural texture.
4. metal: reflect + fuzz * random_in_unit_sphere (3 draws per attempt);
   dielectric: Schlick reflect-or-refract (1 draw).
5. lambertian: sun MIS with a shadow query from p + bias*n along
   Ldir = normalize(-sun_dir), weight pdf_brdf / (0.5 + 0.5 pdf_brdf).
6. Without area lights: cosine-hemisphere continuation (2 draws),
   thr *= albedo.  With sphere lights: a choose draw, then either the
   light branch (light pick + 2 uniforms, pdf 0.5 pdf_light + 0.5
   pdf_brdf) or the BRDF branch (2 draws, pdf 0.5 pdf_brdf) — the
   reference's asymmetric mixture — and thr *= albedo * cos/pi / pdf.

Every draw is masked to the lanes that draw in the scalar control flow,
so each pixel's LCG stream is the CUDA kernels', draw for draw.  With
the camera shutter open, every query of a path sees the sphere centres
at that path's shutter time.
"""

from __future__ import annotations

import numpy as np
import torch

from dsrt_tpu.models.materials import (DIELECTRIC, DIFFUSE_LIGHT, LAMBERTIAN,
                                       METAL)
from dsrt_tpu_torch.ops import rng as rngmod
from dsrt_tpu_torch.ops import textures as texmod
from dsrt_tpu_torch.ops.camera import camera_rays
from dsrt_tpu_torch.ops.linalg import (V3, clamp01, cross, dot, f64_op, maxc,
                                       normalize, reflect, refract, schlick,
                                       sqrt, where as vwhere)
from dsrt_tpu_torch.ops.trace import scene_hit

# scene limits of the sphere kernel (ops/sphere_kernel.py), which the
# plain renderer shares
MAX_SPH = 16
MAX_MED = 4
MAX_LIGHTS = 8


def sun_direction(scene) -> V3:
    """Ldir = normalize(-sun_dir): the reference kernel negates the
    documented ISS->Sun direction.  Computed on the host, returned as
    0-dim tensors on the scene's device (the kernel gets the same bits)."""
    sd = scene.sun_dir.detach().to("cpu", torch.float32)
    ldir = normalize(V3(-sd[0], -sd[1], -sd[2]))
    return V3(*(c.to(scene.device) for c in ldir))


def build_onb(n: V3):
    """Orthonormal basis with w along n."""
    w = normalize(n)
    big = torch.abs(w.x) > 0.9
    zero = torch.zeros_like(w.x)
    one = torch.ones_like(w.x)
    a = V3(torch.where(big, zero, one), torch.where(big, one, zero), zero)
    v = normalize(cross(w, a))
    u = cross(v, w)
    return u, v, w


def sample_cosine_hemisphere(n: V3, state, mask):
    """World-space cosine-weighted direction and its pdf; 2 draws."""
    local, state = rngmod.random_cosine_direction(state, mask)
    u, v, w = build_onb(n)
    world = normalize(u * local.x + v * local.y + w * local.z)
    cos_t = torch.clamp_min(dot(world, n), 0.0)
    pi = torch.tensor(rngmod.PI_F, dtype=torch.float32, device=cos_t.device)
    pdf = torch.where(cos_t > 0.0, cos_t / pi, torch.zeros_like(cos_t))
    return world, pdf, state


def check_scope(scene, cfg) -> None:
    """Raise for scenes outside the ported scope."""
    if scene.n_quads:
        raise NotImplementedError(
            "quads are not ported yet (ROADMAP queue 1 item 1)")
    if scene.has_smooth:
        raise NotImplementedError(
            "smooth (vn) shading is not ported yet (ROADMAP queue 1 item 1)")
    if scene.has_image_tex and scene.n_spheres:
        raise NotImplementedError(
            "image textures in a scene with spheres are not ported yet "
            "(ROADMAP queue 1 item 1)")
    if (scene.n_spheres > MAX_SPH or scene.n_media > MAX_MED
            or scene.n_lights > MAX_LIGHTS):
        raise NotImplementedError(
            f"at most {MAX_SPH} spheres, {MAX_MED} media and {MAX_LIGHTS} "
            f"lights (scene: {scene.n_spheres}, {scene.n_media}, "
            f"{scene.n_lights})")


def sphere_light_from_uniforms(center: V3, radius, origin: V3, uz, uphi):
    """Uniform sample on a sphere light from two uniforms: direction and
    its solid-angle pdf dist^2 / (cos_light * 4 pi r^2).  cos and sin in
    float64 rounded once; the direction is normalised by a reciprocal
    multiply, as in the reference."""
    z = 2.0 * uz - 1.0
    phi = rngmod.TWO_PI_F * uphi
    r = sqrt(torch.clamp_min(1.0 - z * z, 0.0))
    local = V3(r * f64_op(torch.cos, phi), r * f64_op(torch.sin, phi), z)
    p_light = center + local * radius
    to_light = p_light - origin
    dist2 = dot(to_light, to_light)
    dist = sqrt(dist2)
    ok = dist > 0.0
    one = torch.ones_like(dist)
    zero = torch.zeros_like(dist)
    wi = vwhere(ok, to_light * (1.0 / torch.where(ok, dist, one)),
                V3(zero, zero, one))
    n_light = normalize(p_light - center)
    cos_l = torch.clamp_min(dot(n_light, -wi), 0.0)
    ok = ok & (cos_l > 0.0)
    area = 4.0 * rngmod.PI_F * radius * radius
    pdf = torch.where(ok, dist2 / torch.where(ok, cos_l * area, one), zero)
    return wi, pdf


def bounce_step(scene, cfg, L: V3, thr: V3, ro: V3, rd: V3, state, alive,
                rr_mask, sdir: V3, time=None):
    """One path segment for every lane.  Returns
    (L, thr, ro, rd, state, alive, rays traced by this segment)."""
    dev = ro.x.device
    t_min = float(cfg.hit_eps)
    t_max = float(cfg.hit_tmax)
    one = torch.ones_like(ro.x)
    pi = torch.tensor(rngmod.PI_F, dtype=torch.float32, device=dev)

    # 0. Russian roulette
    u_rr, state = rngmod.draw(state, rr_mask)
    p_rr = torch.clamp_max(maxc(thr), float(cfg.rr_max_p))
    killed = rr_mask & (u_rr > p_rr)
    alive = alive & ~killed
    inv_p = 1.0 / torch.where(p_rr > 0, p_rr, one)
    thr = vwhere(rr_mask & ~killed, thr * inv_p, thr)

    # 1. closest hit; a miss sees the sky
    nrays = alive.sum()
    hit, state = scene_hit(scene, ro, rd, t_min, t_max, alive, state,
                           time=time)
    if scene.env_tex >= 0:
        miss = alive & ~hit.hit
        L = vwhere(miss, L + thr * texmod.sample_env(scene, rd), L)
    alive = alive & hit.hit
    n = hit.normal
    p = V3(ro.x + hit.t * rd.x, ro.y + hit.t * rd.y, ro.z + hit.t * rd.z)

    # medium scatter
    surf = alive
    if scene.n_media:
        med = alive & (hit.medium >= 0)
        malb = scene.med_albedo[torch.clamp(hit.medium, 0,
                                            scene.n_media - 1)]
        dir_m, state = rngmod.random_unit_vector(state, med)
        thr = vwhere(med, thr * V3(malb[..., 0], malb[..., 1], malb[..., 2]),
                     thr)
        ro = vwhere(med, p, ro)
        rd = vwhere(med, dir_m, rd)
        surf = alive & (hit.medium < 0)

    mp = scene.mat_pack[hit.mat]
    mtype = mp[..., 0].to(torch.int64)

    # 2. emission
    emis = surf & (mtype == DIFFUSE_LIGHT)
    L = vwhere(emis, L + thr * V3(mp[..., 4], mp[..., 5], mp[..., 6]), L)
    alive = alive & ~emis
    surf = surf & ~emis

    # 3. albedo
    albedo = V3(mp[..., 1], mp[..., 2], mp[..., 3])
    if scene.has_image_tex:
        tex_rgb = texmod.sample_image(scene, hit.tex, hit.tu, hit.tv)
        albedo = vwhere(surf & (hit.tex >= 0), albedo * tex_rgb, albedo)
    if scene.has_ptex:
        albedo = texmod.sample_procedural(scene, hit.mat, albedo, p,
                                          mask=surf)

    # 4. specular: metal and dielectric
    metal = surf & (mtype == METAL)
    diel = surf & (mtype == DIELECTRIC)
    unit_in = normalize(rd)
    refl = reflect(unit_in, n)
    fuzz = torch.clamp(mp[..., 7], 0.0, 1.0)
    fz, state = rngmod.random_in_unit_sphere(state, metal)
    metal_dir = refl + fz * fuzz
    alive = alive & ~(metal & ~(dot(metal_dir, n) > 0.0))

    eta = mp[..., 8]
    eta = torch.where((eta <= 0.0) | ~torch.isfinite(eta),
                      torch.full_like(eta, 1.5), eta)
    ratio = torch.where(hit.front, 1.0 / eta, eta)
    cos_t = torch.clamp_max(dot(-unit_in, n), 1.0)
    sin_t = sqrt(torch.clamp_min(1.0 - cos_t * cos_t, 0.0))
    cannot = ratio * sin_t > 1.0
    refl_prob = schlick(cos_t, ratio)
    u_d, state = rngmod.draw(state, diel)
    use_refl = cannot | (refl_prob > u_d)
    diel_dir = vwhere(use_refl, reflect(unit_in, n),
                      refract(unit_in, n, ratio))

    spec = (metal | diel) & alive
    thr = vwhere(metal & alive, thr * albedo, thr)
    ro = vwhere(spec, p, ro)
    rd = vwhere(spec, vwhere(metal, metal_dir, diel_dir), rd)

    # 5. diffuse: sun MIS
    diff = surf & (mtype == LAMBERTIAN) & alive
    if scene.sun_enabled:
        cos_sun = torch.clamp_min(dot(n, sdir), 0.0)
        pot = diff & (cos_sun > 0.0)
        nrays = nrays + pot.sum()
        bias = float(cfg.shadow_bias)
        sh_o = V3(p.x + bias * n.x, p.y + bias * n.y, p.z + bias * n.z)
        sh_d = V3(*(c.expand(p.x.shape) for c in sdir))
        sh, state = scene_hit(scene, sh_o, sh_d, t_min, t_max, pot, state,
                              any_hit=True, time=time)
        pdf_brdf_s = cos_sun / pi
        w_sun = pdf_brdf_s / (0.5 + 0.5 * pdf_brdf_s)
        sun_rad = V3(*(c.expand(p.x.shape) for c in scene.sun_radiance))
        L = vwhere(pot & ~sh.hit, L + thr * albedo * sun_rad * w_sun, L)

    # 6. next direction: cosine sampling, or the light/BRDF mixture
    if scene.n_lights == 0:
        dir_b, pdf_b, state = sample_cosine_hemisphere(n, state, diff)
        ok = pdf_b > 0.0
        alive = alive & ~(diff & ~ok)
        move = diff & ok
        thr = vwhere(move, thr * albedo, thr)
        ro = vwhere(move, p, ro)
        rd = vwhere(move, dir_b, rd)
        return L, thr, ro, rd, state, alive, nrays

    choose, state = rngmod.draw(state, diff)
    light_m = diff & (choose < 0.5)
    brdf_m = diff & ~(choose < 0.5)
    uk, state = rngmod.draw(state, light_m)
    k = torch.clamp_max((uk * scene.n_lights).to(torch.int64),
                        scene.n_lights - 1)
    sph = scene.light_idx[k].to(torch.int64)
    c = scene.sph_center[sph]
    u1, u2, state = rngmod.draw2(state, light_m)
    dir_l, pdf_lc = sphere_light_from_uniforms(
        V3(c[..., 0], c[..., 1], c[..., 2]), scene.sph_radius[sph], p, u1,
        u2)
    cos_li = torch.clamp_min(dot(dir_l, n), 0.0)
    l_ok = (pdf_lc > 0.0) & (cos_li > 0.0)
    n_l = torch.tensor(float(scene.n_lights), dtype=torch.float32,
                       device=dev)
    pdf_val_l = 0.5 * (pdf_lc / n_l) + 0.5 * (cos_li / pi)

    dir_b, pdf_b, state = sample_cosine_hemisphere(n, state, brdf_m)
    dir_s = vwhere(light_m, dir_l, dir_b)
    pdf_val = torch.where(light_m, pdf_val_l, 0.5 * pdf_b)
    ok = torch.where(light_m, l_ok, pdf_b > 0.0)
    alive = alive & ~(diff & ~ok)
    move = diff & ok
    cos_o = torch.clamp_min(dot(dir_s, n), 0.0)
    weight = (cos_o / pi) / torch.where(pdf_val > 0, pdf_val, one)
    thr = vwhere(move, thr * albedo * weight, thr)
    ro = vwhere(move, p, ro)
    rd = vwhere(move, dir_s, rd)
    return L, thr, ro, rd, state, alive, nrays


def trace_paths(scene, cfg, ro: V3, rd: V3, state, active0, time=None):
    """Trace one sample per lane to completion.  Returns (clamp01(L),
    state, exact ray count: every closest-hit query plus every potential
    sun receiver).  `time` is the per-lane shutter time, or None."""
    check_scope(scene, cfg)
    sdir = sun_direction(scene)
    zero = torch.zeros_like(ro.x)
    one = torch.ones_like(ro.x)
    L, thr = V3(zero, zero, zero), V3(one, one, one)
    alive = active0
    nrays = torch.zeros((), dtype=torch.int64, device=ro.x.device)
    for depth in range(cfg.resolved_max_depth()):
        if not bool(alive.any()):
            break
        rr_mask = alive & (depth >= cfg.rr_start_depth)
        L, thr, ro, rd, state, alive, nr = bounce_step(
            scene, cfg, L, thr, ro, rd, state, alive, rr_mask, sdir, time)
        nrays = nrays + nr
    return clamp01(L), state, nrays


def pixel_grid(width: int, height: int, device):
    """Row-major (y, x) pixel coordinates of a width x height frame."""
    py, px = torch.meshgrid(torch.arange(height, device=device),
                            torch.arange(width, device=device),
                            indexing="ij")
    return px.reshape(-1), py.reshape(-1)


def render_samples(scene, cam, cfg, spp: int, salt: int = 0):
    """The plain renderer: for each pixel, the sum over `spp` samples of
    clamp01(L), as (height, width, 3) float32 with row 0 = the camera's
    bottom row, and the exact ray count (int64 tensor).  Per sample: the
    diagonal jitter pair, the lens draws with an aperture, then one
    shutter-time draw when cfg.time1 > cfg.time0, held for the whole
    path (dsrt_tpu/render.py `_render_lanes`)."""
    dev = scene.device
    cam = cam.to(dev)
    px, py = pixel_grid(cfg.width, cfg.height, dev)
    state = rngmod.seed_pixels(px, py, cam.width, scene.seed, salt)
    valid = torch.ones(px.shape, dtype=torch.bool, device=dev)
    zero = torch.zeros(px.shape, dtype=torch.float32, device=dev)
    acc = V3(zero, zero, zero)
    nrays = torch.zeros((), dtype=torch.int64, device=dev)
    spp_t = torch.tensor(spp, dtype=torch.float32, device=dev)
    shutter = cfg.time1 > cfg.time0
    t0 = float(np.float32(cfg.time0))
    dt = float(np.float32(cfg.time1 - cfg.time0))
    for s in range(spp):
        jxu, state = rngmod.draw(state, valid)
        jyu, state = rngmod.draw(state, valid)
        sf = torch.tensor(s, dtype=torch.float32, device=dev)
        jx = (sf + jxu) / spp_t
        jy = (sf + jyu) / spp_t
        ro, rd, state = camera_rays(cam, px, py, jx, jy, state, valid,
                                    cfg.aperture > 0)
        time = None
        if shutter:
            ut, state = rngmod.draw(state, valid)
            time = t0 + ut * dt
        L, state, nr = trace_paths(scene, cfg, ro, rd, state, valid, time)
        acc = acc + L
        nrays = nrays + nr
    img = torch.stack(list(acc), dim=-1).reshape(cfg.height, cfg.width, 3)
    return img, nrays
