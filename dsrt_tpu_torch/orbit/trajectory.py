"""Lunar polar rendezvous trajectory generation + pose export.

Contract from orbit_sim/lunar_polar_orbit_sim.py:
- target frozen at periapsis (f = 0); chaser propagated along the same
  orbit from t_start = -time to 0 in steps of dt (:144-174);
- defaults: peri_alt 100 km, apo_alt 1000 km, i = 90 deg, RAAN = 0,
  argp = 90 deg (periapsis over the south pole) (:295-326);
- Moon-centered -> Sun-centered by adding the single epoch-fixed Moon
  position (:425-431);
- TXT export: km -> m, yaw fixed at 90 deg, pitch/roll 0, stop when
  separation < 25 m (:179-233).

Port of dsrt_tpu/orbit/trajectory.py: the same families and export.  The
two Kepler families (polar, plane_offset) propagate the chaser as one
batched float64 PyTorch computation on `device`, the card unless the
caller asks for another; the NRHO family integrates the CR3BP on the
host in NumPy (orbit/cr3bp.py), as the JAX package does.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from dsrt_tpu_torch.device import resolve_device
from dsrt_tpu_torch.orbit import kepler
from dsrt_tpu_torch.orbit.ephemeris import (DEFAULT_EPOCH_UTC,
                                            get_moon_pos_from_sun)
from dsrt_tpu_torch.utils.pose import format_pose_line

SEPARATION_STOP_M = 25.0


@dataclasses.dataclass
class OrbitElements:
    peri_alt_km: float = 100.0
    apo_alt_km: float = 1000.0
    incl_deg: float = 90.0
    raan_deg: float = 0.0
    argp_deg: float = 90.0

    @property
    def rp(self) -> float:
        return kepler.R_MOON + self.peri_alt_km

    @property
    def ra(self) -> float:
        return kepler.R_MOON + self.apo_alt_km

    @property
    def a(self) -> float:
        return 0.5 * (self.rp + self.ra)

    @property
    def e(self) -> float:
        return 1.0 - self.rp / self.a


def _kepler_chaser(elements: OrbitElements, incl_deg: float,
                   t_start: float, t_end: float, dt: float, device
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The target frozen at its periapsis; the chaser on the same
    elements, inclined `incl_deg`, reaching its periapsis at t = 0.  The
    chaser's Kepler solve, true anomaly and elements-to-position step run
    as one batched float64 computation on `device` (the card unless the
    caller asks for another); one copy back to the host."""
    dev = resolve_device(device)
    a, e = elements.a, elements.e
    Om = np.deg2rad(elements.raan_deg)
    om = np.deg2rad(elements.argp_deg)
    n = np.sqrt(kepler.MU_MOON / a ** 3)

    N = int(round((t_end - t_start) / dt)) + 1
    t_arr = t_start + dt * np.arange(N)

    r_peri, _ = kepler.coe_to_rv(a, e, np.deg2rad(elements.incl_deg), Om,
                                 om, 0.0)
    r_target = np.repeat(r_peri[None, :], N, axis=0)

    E = kepler.solve_kepler_E_torch(n * t_arr, e, device=dev)
    f = kepler.true_anomaly_from_E_torch(E, e, device=dev)
    r_chaser = kepler.coe_to_rv_torch(a, e, np.deg2rad(incl_deg), Om, om, f,
                                      device=dev)[0].cpu().numpy()
    return t_arr, r_target, r_chaser


def generate_polar_rendezvous_trajectory(
        elements: OrbitElements, t_start: float = -600.0, t_end: float = 0.0,
        dt: float = 1.0, device=None
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """-> (t[N], r_target[N,3], r_chaser[N,3]) Moon-centered km; the
    chaser propagated on `device` (`_kepler_chaser`)."""
    return _kepler_chaser(elements, elements.incl_deg, t_start, t_end, dt,
                          device)


def export_txt(t_arr: np.ndarray, r_target_km: np.ndarray,
               r_chaser_km: np.ndarray, filename: str,
               yaw_deg: float = 90.0, verbose: bool = True) -> int:
    """Write the pose file; chaser = camera, target = model; returns the
    number of poses written (stops at 25 m separation)."""
    n = 0
    with open(filename, "w") as fh:
        fh.write("# cam_x  cam_y  cam_z     model_x model_y model_z     "
                 "yaw  pitch  roll\n")
        for k, (cam_km, mdl_km) in enumerate(zip(r_chaser_km, r_target_km)):
            dist_m = float(np.linalg.norm(cam_km - mdl_km)) * 1000.0
            if dist_m < SEPARATION_STOP_M:
                if verbose:
                    print(f"[+] Stopping TXT export at index {k}, "
                          f"t = {t_arr[k]:.1f} s: separation {dist_m:.3f} m "
                          f"< {SEPARATION_STOP_M:.1f} m")
                break
            fh.write(format_pose_line(cam_km * 1000.0, mdl_km * 1000.0,
                                      yaw_deg))
            n += 1
    if verbose:
        print(f"[+] Wrote {filename} (positions in meters, stopping at "
              f"{SEPARATION_STOP_M} m)")
    return n


def generate_offset_rendezvous_trajectory(
        elements: OrbitElements, dincl_deg: float = 1.0,
        t_start: float = -600.0, t_end: float = 0.0, dt: float = 1.0,
        device=None) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Non-coplanar approach family (beyond-reference): the target sits
    frozen at ITS periapsis (reference semantics) while the chaser flies
    an orbit inclined by `dincl_deg` more, reaching its own periapsis at
    t = 0 — a plane-change flyby whose closest approach is ~rp * d_incl
    (the 25 m export stop is a cap; this family normally keeps every
    pose).  -> (t[N], r_target[N,3], r_chaser[N,3]) Moon-centered km;
    the chaser propagated on `device` (`_kepler_chaser`)."""
    return _kepler_chaser(elements, elements.incl_deg + dincl_deg, t_start,
                          t_end, dt, device)


def generate_nrho_trajectory(
        time_s: float = 3600.0, dt: float = 10.0, z0: float = -0.18,
        lead_s: float = 600.0, final_sep_m: float = 30.0,
        samples_per_period: int = 4096
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """L2 southern halo (NRHO) family via the CR3BP (orbit/cr3bp.py).

    The target flies a differentially-corrected Earth-Moon L2 halo at
    out-of-plane amplitude `z0` (normalized; -0.18 is NRHO-class:
    ~2,800 km perilune, ~70,000 km apolune, 6.4-day period).  The
    chaser closes along the orbit corridor: it starts `lead_s` seconds
    ahead on the same halo and blends toward the target so the final
    separation is ~`final_sep_m` — a kinematic approach corridor (the
    reference's chaser model is likewise a same-orbit phase sweep).
    -> (t[N], r_target[N,3], r_chaser[N,3]) Moon-centered INERTIAL km.
    """
    from dsrt_tpu_torch.orbit import cr3bp

    halo = cr3bp.l2_southern_halo(z0=z0)
    T = halo.period
    dense = halo.sample(samples_per_period)          # rotating, normalized
    tau_dense = np.linspace(0.0, T, samples_per_period, endpoint=False)

    def orbit_pos(tau):
        """Linear interpolation on the dense closed orbit (positions)."""
        tm = np.mod(tau, T)
        out = np.empty((len(tm), 6))
        for c in range(6):
            out[:, c] = np.interp(tm, tau_dense, dense[:, c],
                                  period=T)
        return out

    N = int(round(time_s / dt)) + 1
    t_s = dt * np.arange(N)
    tau = t_s / cr3bp.TSTAR_S                        # normalized times
    tgt_rot = orbit_pos(tau)
    lead = lead_s / cr3bp.TSTAR_S
    chs_rot = orbit_pos(tau + lead)

    r_tgt = cr3bp.rotating_to_moon_centered_km(tgt_rot, tau)
    r_lead = cr3bp.rotating_to_moon_centered_km(chs_rot, tau)

    # blend the chaser from the lead point onto the target so the last
    # pose sits ~final_sep_m out (u shrinks geometrically: equal
    # fractional closure per step, like a glideslope approach)
    d0 = max(np.linalg.norm(r_lead[0] - r_tgt[0]) * 1000.0, 1.0)  # m
    u_end = min(final_sep_m / d0, 1.0)
    u = u_end ** (t_s / max(time_s, dt))
    r_chs = r_tgt + (r_lead - r_tgt) * u[:, None]
    return t_s, r_tgt, r_chs


def generate_pose_file(filename: str, time_s: float = 600.0, dt: float = 1.0,
                       elements: Optional[OrbitElements] = None,
                       epoch_utc: str = DEFAULT_EPOCH_UTC,
                       kernel_dir: Optional[str] = None,
                       sun_centered: bool = True,
                       device=None,
                       family: str = "polar",
                       dincl_deg: float = 1.0,
                       nrho_z0: float = -0.18,
                       nrho_lead_s: float = 600.0) -> int:
    """End-to-end: trajectory -> (optional) Sun-centered shift -> pose txt.

    `family`: "polar" (reference-parity same-orbit phase sweep),
    "plane_offset" (non-coplanar flyby), both propagated on `device`;
    "nrho" (CR3BP L2 halo, on the host)."""
    elements = elements or OrbitElements()
    if family == "nrho":
        t, r_tgt, r_chs = generate_nrho_trajectory(
            time_s=time_s, dt=dt, z0=nrho_z0, lead_s=nrho_lead_s)
    elif family == "plane_offset":
        t, r_tgt, r_chs = generate_offset_rendezvous_trajectory(
            elements, dincl_deg=dincl_deg, t_start=-time_s, t_end=0.0,
            dt=dt, device=device)
    else:
        t, r_tgt, r_chs = generate_polar_rendezvous_trajectory(
            elements, t_start=-time_s, t_end=0.0, dt=dt,
            device=device)
    if sun_centered:
        r_moon_sun = get_moon_pos_from_sun(epoch_utc, kernel_dir)
        r_tgt = r_tgt + r_moon_sun
        r_chs = r_chs + r_moon_sun
    return export_txt(t, r_tgt, r_chs, filename)
