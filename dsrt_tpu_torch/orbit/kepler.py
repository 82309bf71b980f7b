"""Keplerian two-body propagation (NumPy f64, and a batched PyTorch
variant on the card).

Port of dsrt_tpu/orbit/kepler.py: the NumPy functions are copies
(:26-70); `solve_kepler_E_torch` / `coe_to_rv_torch` take the place of
the vmapped JAX variant (:73-109).

Behavior contract from orbit_sim/lunar_polar_orbit_sim.py:
- constants mu_Moon = 4902.800066 km^3/s^2, R_Moon = 1737.4 km (:30-32);
- Kepler solver: Newton iteration on M = E - e sin E, tol 1e-10, <= 50
  iterations, initial guess E = M (:59-75);
- E -> true anomaly via cos f = (cos E - e)/(1 - e cos E),
  sin f = sqrt(1-e^2) sin E / (1 - e cos E) (:77-87);
- classical elements -> r,v through the perifocal rotation
  Q = R3(Omega) R1(i) R3(omega) (:89-139).

The PyTorch variant solves a whole time array at once on the device,
in float64: JAX's runs in float32 only because its x64 mode is off, and
float32 is ~0.1 m a pose component at lunar distances, where the
rendezvous stops at 25 m.
"""

from __future__ import annotations

import numpy as np
import torch

from dsrt_tpu_torch.device import resolve_device

MU_MOON = 4902.800066   # [km^3/s^2]
R_MOON = 1737.4         # [km]
R_SUN = 696_340.0       # [km]


def solve_kepler_E(M, e, tol=1e-10, max_iter=50):
    """Newton-solve M = E - e sin E (elliptic); M scalar or array [rad]."""
    M = np.asarray(M, dtype=np.float64)
    E = M.copy()
    for _ in range(max_iter):
        f = E - e * np.sin(E) - M
        fp = 1.0 - e * np.cos(E)
        dE = -f / fp
        E = E + dE
        if np.all(np.abs(dE) < tol):
            break
    return E


def true_anomaly_from_E(E, e):
    cosE = np.cos(E)
    sinE = np.sin(E)
    denom = 1.0 - e * cosE
    cosf = (cosE - e) / denom
    sinf = (np.sqrt(1.0 - e ** 2) * sinE) / denom
    return np.arctan2(sinf, cosf)


def perifocal_to_inertial(i, Omega, omega):
    cO, sO = np.cos(Omega), np.sin(Omega)
    co, so = np.cos(omega), np.sin(omega)
    ci, si = np.cos(i), np.sin(i)
    R3_O = np.array([[cO, -sO, 0.0], [sO, cO, 0.0], [0.0, 0.0, 1.0]])
    R1_i = np.array([[1.0, 0.0, 0.0], [0.0, ci, si], [0.0, -si, ci]])
    R3_o = np.array([[co, -so, 0.0], [so, co, 0.0], [0.0, 0.0, 1.0]])
    return R3_O @ R1_i @ R3_o


def coe_to_rv(a, e, i, Omega, omega, f, mu=MU_MOON):
    """Classical elements -> (r, v) in the inertial frame [km, km/s]."""
    r_mag = a * (1.0 - e ** 2) / (1.0 + e * np.cos(f))
    r_pf = np.array([r_mag * np.cos(f), r_mag * np.sin(f), 0.0])
    h = np.sqrt(mu * a * (1.0 - e ** 2))
    v_pf = (mu / h) * np.array([-np.sin(f), e + np.cos(f), 0.0])
    Q = perifocal_to_inertial(i, Omega, omega)
    return Q @ r_pf, Q @ v_pf


# --------------------------------------------------------------------------
# PyTorch variant: one batched float64 computation on the device
# --------------------------------------------------------------------------

def _f64(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float64)
    return torch.as_tensor(np.asarray(x, np.float64), device=device)


def solve_kepler_E_torch(M, e, iters: int = 50, device=None) -> torch.Tensor:
    """Fixed-iteration Newton solve over a whole array of mean anomalies
    M [rad], float64 on `device` (the card unless the caller asks for
    another).  A fixed count replaces the tolerance test, which would
    need a host sync each step; 50 Newton steps are far past
    convergence."""
    M = _f64(M, resolve_device(device))
    E = M.clone()
    for _ in range(iters):
        f = E - e * torch.sin(E) - M
        fp = 1.0 - e * torch.cos(E)
        E = E - f / fp
    return E


def true_anomaly_from_E_torch(E, e, device=None) -> torch.Tensor:
    """`true_anomaly_from_E` over an array of eccentric anomalies E
    [rad], float64 on `device`."""
    E = _f64(E, resolve_device(device))
    cosE, sinE = torch.cos(E), torch.sin(E)
    denom = 1.0 - e * cosE
    return torch.atan2(np.sqrt(1.0 - e ** 2) * sinE / denom,
                       (cosE - e) / denom)


def coe_to_rv_torch(a, e, i, Omega, omega, f, mu=MU_MOON, device=None):
    """Classical elements -> (r, v) [km, km/s], each (N, 3) float64 on
    `device`, for an array of true anomalies f [rad]."""
    f = _f64(f, resolve_device(device))
    r_mag = a * (1.0 - e ** 2) / (1.0 + e * torch.cos(f))
    r_pf = (r_mag * torch.cos(f), r_mag * torch.sin(f))
    h = np.sqrt(mu * a * (1.0 - e ** 2))
    v_pf = ((mu / h) * (-torch.sin(f)), (mu / h) * (e + torch.cos(f)))
    # Q applied elementwise (z_pf = 0), as the JAX variant applies it
    Q = perifocal_to_inertial(i, Omega, omega).tolist()

    def rot(px, py):
        return torch.stack([Q[0][0] * px + Q[0][1] * py,
                            Q[1][0] * px + Q[1][1] * py,
                            Q[2][0] * px + Q[2][1] * py], dim=-1)

    return rot(*r_pf), rot(*v_pf)
