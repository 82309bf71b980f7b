"""Plain path tracing over tensors of rays (port of dsrt_tpu/ops/shade.py).

`bounce_step` is one path segment for every lane, restricted to the
scope of the CUDA megakernel (triangle scenes, flat normals, image
textures, directional sun; no area lights, media, env sky or
procedural textures):

0. Russian roulette from depth >= rr_start_depth (1 draw).
1. Closest hit in [hit_eps, hit_tmax]; a miss terminates (black sky).
2. diffuse_light: L += thr * emissive, terminate.
3. albedo = material albedo x image texel.
4. metal: reflect + fuzz * random_in_unit_sphere (3 draws per attempt);
   dielectric: Schlick reflect-or-refract (1 draw).
5. lambertian: sun MIS with an any-hit shadow ray from p + bias*n along
   Ldir = normalize(-sun_dir), weight pdf_brdf / (0.5 + 0.5 pdf_brdf);
   then cosine-hemisphere continuation (2 draws), thr *= albedo.

Every draw is masked to the lanes that draw in the scalar control flow,
so each pixel's LCG stream is the CUDA kernel's, draw for draw.
"""

from __future__ import annotations

import torch

from dsrt_tpu.models.materials import (DIELECTRIC, DIFFUSE_LIGHT, LAMBERTIAN,
                                       METAL)
from dsrt_tpu_torch.ops import rng as rngmod
from dsrt_tpu_torch.ops import textures as texmod
from dsrt_tpu_torch.ops.linalg import (V3, clamp01, cross, dot, maxc,
                                       normalize, reflect, refract, schlick,
                                       sqrt, where as vwhere)
from dsrt_tpu_torch.ops.trace import hit_from_kernel, lane_traverse


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
    """Raise for scenes or configs outside the ported scope."""
    if scene.n_spheres or scene.n_quads or scene.n_lights:
        raise NotImplementedError(
            "spheres, quads and area lights are not ported yet "
            "(ROADMAP queue 2 item 7)")
    if scene.n_media:
        raise NotImplementedError(
            "constant media are not ported yet (ROADMAP queue 2 item 7)")
    if scene.env_tex >= 0:
        raise NotImplementedError(
            "the environment-map sky is not ported yet "
            "(ROADMAP queue 2 item 5)")
    if scene.has_ptex:
        raise NotImplementedError(
            "procedural textures are not ported yet "
            "(ROADMAP queue 2 item 8)")
    if scene.has_smooth:
        raise NotImplementedError(
            "smooth (vn) shading is not ported yet (ROADMAP queue 2 item 7)")
    if cfg.aperture > 0 or cfg.time1 > cfg.time0:
        raise NotImplementedError(
            "depth of field and motion blur are not ported yet "
            "(ROADMAP queue 2 item 7)")


def scene_hit(scene, ro: V3, rd: V3, t_min, t_max, active,
              any_hit: bool = False):
    t, u, v, tri = lane_traverse(scene, ro, rd, t_min, t_max, active,
                                 any_hit=any_hit)
    return hit_from_kernel(scene, ro, rd, t, u, v, tri, t_max)


def bounce_step(scene, cfg, L: V3, thr: V3, ro: V3, rd: V3, state, alive,
                rr_mask, sdir: V3):
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

    # 1. closest hit
    nrays = alive.sum()
    hit = scene_hit(scene, ro, rd, t_min, t_max, alive)
    alive = alive & hit.hit
    n = hit.normal
    p = V3(ro.x + hit.t * rd.x, ro.y + hit.t * rd.y, ro.z + hit.t * rd.z)
    mp = scene.mat_pack[hit.mat]
    mtype = mp[..., 0].to(torch.int64)
    surf = alive

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

    # 5. diffuse: sun MIS, then cosine continuation
    diff = surf & (mtype == LAMBERTIAN) & alive
    if scene.sun_enabled:
        cos_sun = torch.clamp_min(dot(n, sdir), 0.0)
        pot = diff & (cos_sun > 0.0)
        nrays = nrays + pot.sum()
        bias = float(cfg.shadow_bias)
        sh_o = V3(p.x + bias * n.x, p.y + bias * n.y, p.z + bias * n.z)
        sh_d = V3(*(c.expand(p.x.shape) for c in sdir))
        blocked = scene_hit(scene, sh_o, sh_d, t_min, t_max, pot,
                            any_hit=True).hit
        pdf_brdf_s = cos_sun / pi
        w_sun = pdf_brdf_s / (0.5 + 0.5 * pdf_brdf_s)
        sun_rad = V3(*(c.expand(p.x.shape) for c in scene.sun_radiance))
        L = vwhere(pot & ~blocked, L + thr * albedo * sun_rad * w_sun, L)

    dir_b, pdf_b, state = sample_cosine_hemisphere(n, state, diff)
    ok = pdf_b > 0.0
    alive = alive & ~(diff & ~ok)
    move = diff & ok
    thr = vwhere(move, thr * albedo, thr)
    ro = vwhere(move, p, ro)
    rd = vwhere(move, dir_b, rd)
    return L, thr, ro, rd, state, alive, nrays


def trace_paths(scene, cfg, ro: V3, rd: V3, state, active0):
    """Trace one sample per lane to completion.  Returns (clamp01(L),
    state, exact ray count: every closest-hit query plus every potential
    sun receiver)."""
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
            scene, cfg, L, thr, ro, rd, state, alive, rr_mask, sdir)
        nrays = nrays + nr
    return clamp01(L), state, nrays
