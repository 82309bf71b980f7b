"""Plain path tracing over tensors of rays (port of dsrt_tpu/ops/shade.py).

`bounce_step` is one path segment for every lane:

0. Russian roulette from depth >= rr_start_depth (1 draw).
1. Closest hit in [hit_eps, hit_tmax]: triangles (smooth-shaded on vn
   scenes), spheres, quads, then media (one draw per medium).  A miss adds thr * sky (black without an
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
   thr *= albedo.  With area lights (spheres, then quads, in the light
   list): a choose draw, then either the light branch (light pick + 2
   uniforms, whatever the light's kind; pdf 0.5 pdf_light + 0.5
   pdf_brdf) or the BRDF branch (2 draws, pdf 0.5 pdf_brdf) — the
   reference's asymmetric mixture — and thr *= albedo * cos/pi / pdf.

The scene queries walk the BVH by `walk`: "plain" runs `lane_traverse`
on any device (the plain versions of the megakernels, which must never
launch a kernel); "kernel" goes through the split pipeline's traversal
kernels (ops/traverse.py, their plain versions on CPU tensors), as JAX's
`_vmapped_scene_hit` does on the TPU, and with exec_opts.OPTS.fused_sun
on a scene of flat triangles only one `traverse_with_sun` launch answers
both queries of a wave.

Every draw is masked to the lanes that draw in the scalar control flow,
so each pixel's LCG stream is the CUDA kernels', draw for draw.  With
the camera shutter open, every query of a path sees the sphere centres
at that path's shutter time.
"""

from __future__ import annotations

import numpy as np
import torch

from dsrt_tpu_torch.device import to_device
from dsrt_tpu_torch.models.materials import (DIELECTRIC, DIFFUSE_LIGHT,
                                             LAMBERTIAN, METAL)
from dsrt_tpu_torch.exec_opts import OPTS
from dsrt_tpu_torch.ops import rng as rngmod
from dsrt_tpu_torch.ops import textures as texmod
from dsrt_tpu_torch.ops.camera import camera_rays
from dsrt_tpu_torch.ops.linalg import (V3, clamp01, const, cross, dot,
                                       f64_op, maxc, normalize, reflect,
                                       refract, schlick, sqrt,
                                       where as vwhere)
from dsrt_tpu_torch.ops.trace import (scene_hit, scene_hit_flat,
                                      scene_hit_flat_sun)

WALKS = ("plain", "kernel")

# scene limits of the sphere kernel (ops/sphere_kernel.py), which the
# plain renderer shares; the path kernel's are tighter
# (ops/path_kernel.py)
MAX_SPH = 16
MAX_MED = 4
MAX_LIGHTS = 8


def sun_ldir_host(scene) -> V3:
    """Ldir = normalize(-sun_dir): the reference kernel negates the
    documented ISS->Sun direction.  0-dim float32 tensors on the CPU,
    from the scene's host copy of sun_dir (`Scene.sun_dir_host`)."""
    sd = torch.from_numpy(scene.sun_dir_host)
    return normalize(V3(-sd[0], -sd[1], -sd[2]))


def sun_direction(scene) -> V3:
    """`sun_ldir_host` as 0-dim tensors on the scene's device (the kernel
    gets the same bits), in one copy (`to_device`)."""
    return V3(*to_device(torch.stack(list(sun_ldir_host(scene))),
                         scene.device).unbind())


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
    pi = const(rngmod.PI_F, cos_t.device)
    pdf = torch.where(cos_t > 0.0, cos_t / pi, torch.zeros_like(cos_t))
    return world, pdf, state


def check_scope(scene, cfg) -> None:
    """Raise for scenes past the renderer's primitive limits."""
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


def quad_light_from_uniforms(q: V3, eu: V3, ev: V3, qn: V3, area,
                             origin: V3, u1, u2):
    """Uniform sample on a quad light, q + u1 eu + u2 ev, from two
    uniforms: direction and its solid-angle pdf dist^2 / (|cos| area);
    0 when the point is within 1e-3 or grazing (|cos| <= 1e-8)."""
    p_l = V3(q.x + u1 * eu.x + u2 * ev.x, q.y + u1 * eu.y + u2 * ev.y,
             q.z + u1 * eu.z + u2 * ev.z)
    to_light = p_l - origin
    dist2 = dot(to_light, to_light)
    dist = sqrt(dist2)
    ok = dist > 1e-3
    one = torch.ones_like(dist)
    zero = torch.zeros_like(dist)
    wi = vwhere(ok, to_light * (1.0 / torch.where(ok, dist, one)),
                V3(zero, zero, one))
    cos_l = torch.abs(dot(wi, qn))
    ok = ok & (cos_l > 1e-8) & (area > 0.0)
    pdf = torch.where(ok, dist2 / torch.where(ok, cos_l * area, one), zero)
    return wi, pdf


def _rows(table: torch.Tensor, idx: torch.Tensor) -> V3:
    r = table[idx]
    return V3(r[..., 0], r[..., 1], r[..., 2])


def light_sample(scene, k, p: V3, u1, u2):
    """Direction and solid-angle pdf of light-list entry `k` from `p`:
    a sphere light (at its shutter-time-0 centre) or a quad light."""
    li = scene.light_idx[k].to(torch.int64)
    sph = torch.clamp(li, 0, scene.sph_center.shape[0] - 1)
    dir_l, pdf = sphere_light_from_uniforms(
        _rows(scene.sph_center, sph), scene.sph_radius[sph], p, u1, u2)
    if scene.n_quads == 0:
        return dir_l, pdf
    qi = torch.clamp(li, 0, scene.quad_q.shape[0] - 1)
    dir_q, pdf_q = quad_light_from_uniforms(
        _rows(scene.quad_q, qi), _rows(scene.quad_u, qi),
        _rows(scene.quad_v, qi), _rows(scene.quad_n, qi),
        scene.quad_area[qi], p, u1, u2)
    is_q = scene.light_kind[k] == 1
    return vwhere(is_q, dir_q, dir_l), torch.where(is_q, pdf_q, pdf)


def bounce_step(scene, cfg, L: V3, thr: V3, ro: V3, rd: V3, state, alive,
                rr_mask, sdir: V3, sun_vec, time=None, walk: str = "plain"):
    """One path segment for every lane, the scene queried by `walk` (see
    the module docstring); `sdir` is the sun direction and `sun_vec` the
    caller's `traverse.sun_vector(sdir, cfg.shadow_bias)`, made once for
    the fused sun query's launches.  Returns
    (L, thr, ro, rd, state, alive, rays traced by this segment)."""
    if walk not in WALKS:
        raise ValueError(f"walk must be one of {WALKS}, got {walk!r}")
    dev = ro.x.device
    t_min = float(cfg.hit_eps)
    t_max = float(cfg.hit_tmax)
    one = torch.ones_like(ro.x)
    pi = const(rngmod.PI_F, dev)

    # 0. Russian roulette
    u_rr, state = rngmod.draw(state, rr_mask)
    p_rr = torch.clamp_max(maxc(thr), float(cfg.rr_max_p))
    killed = rr_mask & (u_rr > p_rr)
    alive = alive & ~killed
    inv_p = 1.0 / torch.where(p_rr > 0, p_rr, one)
    thr = vwhere(rr_mask & ~killed, thr * inv_p, thr)

    # 1. closest hit; a miss sees the sky
    nrays = alive.sum()
    fused = (walk == "kernel" and OPTS.fused_sun and scene.sun_enabled
             and scene.n_tris > 0 and scene.n_spheres == 0
             and scene.n_quads == 0 and scene.n_media == 0
             and not scene.has_smooth)
    query = scene_hit_flat if walk == "kernel" else scene_hit
    if fused:
        hit, sun_blocked = scene_hit_flat_sun(scene, ro, rd, t_min, t_max,
                                              alive, sdir, cfg.shadow_bias,
                                              sun_vec)
    else:
        hit, state = query(scene, ro, rd, t_min, t_max, alive, state,
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
        if fused:
            blocked = sun_blocked
        else:
            sh_o = V3(p.x + bias * n.x, p.y + bias * n.y, p.z + bias * n.z)
            sh_d = V3(*(c.expand(p.x.shape) for c in sdir))
            sh, state = query(scene, sh_o, sh_d, t_min, t_max, pot, state,
                              any_hit=True, time=time)
            blocked = sh.hit
        pdf_brdf_s = cos_sun / pi
        w_sun = pdf_brdf_s / (0.5 + 0.5 * pdf_brdf_s)
        sun_rad = V3(*(c.expand(p.x.shape) for c in scene.sun_radiance))
        L = vwhere(pot & ~blocked, L + thr * albedo * sun_rad * w_sun, L)

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
    u1, u2, state = rngmod.draw2(state, light_m)
    dir_l, pdf_lc = light_sample(scene, k, p, u1, u2)
    cos_li = torch.clamp_min(dot(dir_l, n), 0.0)
    l_ok = (pdf_lc > 0.0) & (cos_li > 0.0)
    n_l = const(scene.n_lights, dev)
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


def trace_paths(scene, cfg, ro: V3, rd: V3, state, active0, time=None,
                walk: str = "plain", sdir: V3 | None = None):
    """Trace one sample per lane to completion.  Returns (clamp01(L),
    state, exact ray count: every closest-hit query plus every potential
    sun receiver).  `time` is the per-lane shutter time, or None."""
    from dsrt_tpu_torch.ops.traverse import sun_vector
    check_scope(scene, cfg)
    if sdir is None:
        sdir = sun_direction(scene)
    sun_vec = sun_vector(sdir, cfg.shadow_bias)
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
            scene, cfg, L, thr, ro, rd, state, alive, rr_mask, sdir, sun_vec,
            time, walk)
        nrays = nrays + nr
    return clamp01(L), state, nrays


def pixel_grid(width: int, height: int, device):
    """Row-major (y, x) pixel coordinates of a width x height frame."""
    py, px = torch.meshgrid(torch.arange(height, device=device),
                            torch.arange(width, device=device),
                            indexing="ij")
    return px.reshape(-1), py.reshape(-1)


def render_samples(scene, cam, cfg, spp: int, salt: int = 0,
                   walk: str = "plain", px=None, py=None):
    """The plain renderer: for each pixel, the sum over `spp` samples of
    clamp01(L), as (height, width, 3) float32 with row 0 = the camera's
    bottom row, and the exact ray count (int64 tensor).  Per sample: the
    diagonal jitter pair, the lens draws with an aperture, then one
    shutter-time draw when cfg.time1 > cfg.time0, held for the whole
    path (dsrt_tpu/render.py `_render_lanes`).  `walk` as in
    bounce_step.  With a pixel list (`px`, `py`: 1-D int64 tensors) it
    renders only those pixels and returns their sums as (n, 3); each
    pixel's stream is seeded from its own coordinates, so a pixel's sum
    is the same in any list and in the whole frame."""
    dev = scene.device
    cam = cam.to(dev)
    listed = px is not None
    if not listed:
        px, py = pixel_grid(cfg.width, cfg.height, dev)
    state = rngmod.seed_pixels(px, py, cam.width, scene.seed, salt)
    valid = torch.ones(px.shape, dtype=torch.bool, device=dev)
    zero = torch.zeros(px.shape, dtype=torch.float32, device=dev)
    acc = V3(zero, zero, zero)
    nrays = torch.zeros((), dtype=torch.int64, device=dev)
    spp_t = const(spp, dev)
    sdir = sun_direction(scene)
    shutter = cfg.time1 > cfg.time0
    t0 = float(np.float32(cfg.time0))
    dt = float(np.float32(cfg.time1 - cfg.time0))
    for s in range(spp):
        jxu, state = rngmod.draw(state, valid)
        jyu, state = rngmod.draw(state, valid)
        sf = const(s, dev)
        jx = (sf + jxu) / spp_t
        jy = (sf + jyu) / spp_t
        ro, rd, state = camera_rays(cam, px, py, jx, jy, state, valid,
                                    cfg.aperture > 0)
        time = None
        if shutter:
            ut, state = rngmod.draw(state, valid)
            time = t0 + ut * dt
        L, state, nr = trace_paths(scene, cfg, ro, rd, state, valid, time,
                                   walk, sdir)
        acc = acc + L
        nrays = nrays + nr
    sums = torch.stack(list(acc), dim=-1)
    if listed:
        return sums, nrays
    return sums.reshape(cfg.height, cfg.width, 3), nrays


def stratified_sums(scene, cam, cfg, px, py, state, strata,
                    walk: str = "plain"):
    """The sample body of JAX's sharded render
    (dsrt_tpu/parallel/render.py:82-96) over the pixels (px, py), 1-D
    int64 tensors, from the LCG states `state`: one sample a lane for
    each entry of `strata`, the samples' global stratum (ints).  Per
    sample the jitter pair (stratum + u) / cfg's spp, the lens draws with
    an aperture, and the path, with no shutter-time draw: that body has
    none, so on a motion-blur scene its image is not the parity
    renderer's.  Returns the (n, 3) sums of clamp01(L) and the exact ray
    count (int64 tensor)."""
    dev = scene.device
    cam = cam.to(dev)
    valid = torch.ones(px.shape, dtype=torch.bool, device=dev)
    zero = torch.zeros(px.shape, dtype=torch.float32, device=dev)
    acc = V3(zero, zero, zero)
    nrays = torch.zeros((), dtype=torch.int64, device=dev)
    spp_t = const(cfg.resolved_spp(), dev)
    sdir = sun_direction(scene)
    for s in strata:
        jxu, state = rngmod.draw(state, valid)
        jyu, state = rngmod.draw(state, valid)
        sf = const(s, dev)
        jx = (sf + jxu) / spp_t
        jy = (sf + jyu) / spp_t
        ro, rd, state = camera_rays(cam, px, py, jx, jy, state, valid,
                                    cfg.aperture > 0)
        L, state, nr = trace_paths(scene, cfg, ro, rd, state, valid, None,
                                   walk, sdir)
        acc = acc + L
        nrays = nrays + nr
    return torch.stack(list(acc), dim=-1), nrays
