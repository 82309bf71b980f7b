"""Earth-Moon circular restricted three-body problem (CR3BP) orbits.

A copy of dsrt_tpu/orbit/cr3bp.py: the port imports nothing of the JAX package.

Beyond-reference trajectory family (ROADMAP "more trajectory families"):
the reference's simulator is two-body Kepler only
(orbit_sim/lunar_polar_orbit_sim.py:59-139).  Near-rectilinear halo
orbits (NRHOs) around Earth-Moon L2 — the Lunar Gateway's orbit — need
the CR3BP.  Everything here is classical textbook material (Szebehely;
Howell 1984 differential correction), implemented in float64 NumPy:

- rotating-frame equations of motion (normalized units: Earth-Moon
  distance = 1, angular rate = 1, total mass = 1);
- fixed-step RK4 propagation, optionally with the 6x6 state transition
  matrix (STM) integrated alongside;
- a single-shooting differential corrector for symmetric periodic
  (halo) orbits: start on the y = 0 plane with x-z-plane symmetry
  (y0 = vx0 = vz0 = 0), integrate to the next y = 0 crossing, and
  correct (x0, vy0) — z0 fixed, selecting the orbit family member —
  until the crossing is again perpendicular (vx = vz = 0).  By the
  mirror theorem two perpendicular plane crossings make the orbit
  periodic with period twice the crossing time;
- conversion from barycentric rotating coordinates to Moon-centered
  inertial km for the pose pipeline.
"""

from __future__ import annotations

import dataclasses

import numpy as np

# Earth-Moon mass parameter mu = m_Moon / (m_Earth + m_Moon) and the
# characteristic length (Earth-Moon mean distance).  Standard values.
EM_MU = 0.0121505856
LSTAR_KM = 384400.0
# characteristic time: 1 normalized time unit = 1/n_EM seconds
# (sidereal month / 2*pi)
TSTAR_S = 375190.26


def eom(state: np.ndarray, mu: float = EM_MU) -> np.ndarray:
    """CR3BP rotating-frame equations of motion, d(state)/dt for
    state = [x, y, z, vx, vy, vz] (barycentric, normalized)."""
    x, y, z, vx, vy, vz = state
    r1 = np.sqrt((x + mu) ** 2 + y * y + z * z)          # to Earth
    r2 = np.sqrt((x - 1.0 + mu) ** 2 + y * y + z * z)    # to Moon
    r13 = r1 ** 3
    r23 = r2 ** 3
    ax = (x + 2.0 * vy
          - (1.0 - mu) * (x + mu) / r13 - mu * (x - 1.0 + mu) / r23)
    ay = (y - 2.0 * vx - (1.0 - mu) * y / r13 - mu * y / r23)
    az = (-(1.0 - mu) * z / r13 - mu * z / r23)
    return np.array([vx, vy, vz, ax, ay, az])


def _uxx(state: np.ndarray, mu: float) -> np.ndarray:
    """Hessian of the pseudo-potential U* (3x3), for the STM dynamics."""
    x, y, z = state[:3]
    r1v = np.array([x + mu, y, z])
    r2v = np.array([x - 1.0 + mu, y, z])
    r1 = np.linalg.norm(r1v)
    r2 = np.linalg.norm(r2v)
    I3 = np.eye(3)
    g = (-(1.0 - mu) / r1 ** 3 * I3 - mu / r2 ** 3 * I3
         + 3.0 * (1.0 - mu) / r1 ** 5 * np.outer(r1v, r1v)
         + 3.0 * mu / r2 ** 5 * np.outer(r2v, r2v))
    g[0, 0] += 1.0
    g[1, 1] += 1.0
    return g


def eom_stm(aug: np.ndarray, mu: float = EM_MU) -> np.ndarray:
    """EOM for [state(6), STM(36 row-major)]."""
    state = aug[:6]
    phi = aug[6:].reshape(6, 6)
    ds = eom(state, mu)
    A = np.zeros((6, 6))
    A[:3, 3:] = np.eye(3)
    A[3:, :3] = _uxx(state, mu)
    A[3, 4] = 2.0
    A[4, 3] = -2.0
    dphi = A @ phi
    return np.concatenate([ds, dphi.reshape(-1)])


def rk4(f, y0: np.ndarray, t0: float, t1: float, n_steps: int,
        mu: float = EM_MU) -> np.ndarray:
    """Fixed-step RK4 from t0 to t1; returns the final state."""
    h = (t1 - t0) / n_steps
    y = np.array(y0, dtype=np.float64)
    for _ in range(n_steps):
        k1 = f(y, mu)
        k2 = f(y + 0.5 * h * k1, mu)
        k3 = f(y + 0.5 * h * k2, mu)
        k4 = f(y + h * k3, mu)
        y = y + (h / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)
    return y


def propagate(state0: np.ndarray, t_end: float, n_steps: int,
              mu: float = EM_MU) -> np.ndarray:
    """-> states[(n_steps+1), 6] at uniform times 0..t_end."""
    h = t_end / n_steps
    out = np.empty((n_steps + 1, 6))
    out[0] = state0
    y = np.array(state0, dtype=np.float64)
    for i in range(n_steps):
        k1 = eom(y, mu)
        k2 = eom(y + 0.5 * h * k1, mu)
        k3 = eom(y + 0.5 * h * k2, mu)
        k4 = eom(y + h * k3, mu)
        y = y + (h / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)
        out[i + 1] = y
    return out


def jacobi_constant(state: np.ndarray, mu: float = EM_MU) -> float:
    """C = 2U* - v^2 — the CR3BP's conserved integral (propagation
    accuracy check)."""
    x, y, z, vx, vy, vz = state
    r1 = np.sqrt((x + mu) ** 2 + y * y + z * z)
    r2 = np.sqrt((x - 1.0 + mu) ** 2 + y * y + z * z)
    ustar = 0.5 * (x * x + y * y) + (1.0 - mu) / r1 + mu / r2
    return 2.0 * ustar - (vx * vx + vy * vy + vz * vz)


def _cross_y0(state0: np.ndarray, mu: float, h: float = 1e-3,
              max_steps: int = 20000):
    """Integrate until the next y = 0 crossing (ignoring the start),
    then bisect the final step.  Returns (t_cross, state_cross)."""
    y = np.array(state0, dtype=np.float64)
    t = 0.0
    prev = y.copy()
    armed = False
    for _ in range(max_steps):
        k1 = eom(y, mu)
        k2 = eom(y + 0.5 * h * k1, mu)
        k3 = eom(y + 0.5 * h * k2, mu)
        k4 = eom(y + h * k3, mu)
        ynew = y + (h / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)
        tnew = t + h
        if not armed and abs(ynew[1]) > 1e-6:
            armed = True                    # left the starting plane
        if armed and y[1] * ynew[1] < 0.0:
            # bisect [t, tnew] for the crossing
            lo_t, lo = t, y.copy()
            hi_t = tnew
            for _ in range(60):
                mid_t = 0.5 * (lo_t + hi_t)
                mid = rk4(eom, lo, 0.0, mid_t - lo_t, 4, mu)
                if lo[1] * mid[1] < 0.0:
                    hi_t = mid_t
                else:
                    lo_t, lo = mid_t, mid
            return hi_t, rk4(eom, y, 0.0, hi_t - t, 8, mu)
        prev, y, t = y, ynew, tnew
    raise RuntimeError("no y=0 crossing found")


def correct_halo(x0: float, z0: float, vy0: float, mu: float = EM_MU,
                 tol: float = 1e-10, max_iter: int = 30):
    """Differential correction of a symmetric halo orbit (Howell 1984).

    Fix z0 (family parameter); adjust (x0, vy0) so the half-period
    y = 0 crossing is perpendicular (vx = vz = 0).  Returns
    (state0[6], period).
    """
    x0 = float(x0)
    vy0 = float(vy0)
    for _ in range(max_iter):
        s0 = np.array([x0, 0.0, z0, 0.0, vy0, 0.0])
        t_half, _ = _cross_y0(s0, mu)
        aug0 = np.concatenate([s0, np.eye(6).reshape(-1)])
        # enough fixed steps that the STM is accurate at the crossing
        aug = rk4(eom_stm, aug0, 0.0, t_half, 2000, mu)
        sT = aug[:6]
        phi = aug[6:].reshape(6, 6)
        vx_T, vz_T = sT[3], sT[5]
        if abs(vx_T) < tol and abs(vz_T) < tol:
            return np.array([x0, 0.0, z0, 0.0, vy0, 0.0]), 2.0 * t_half
        # crossing-time sensitivity: dt = -y_dot_row . d(controls) / vy_T
        acc = eom(sT, mu)[3:]
        vy_T = sT[4]
        # d(vx,vz)_cross / d(x0, vy0) with the time correction
        M = np.array([
            [phi[3, 0] - acc[0] / vy_T * phi[1, 0],
             phi[3, 4] - acc[0] / vy_T * phi[1, 4]],
            [phi[5, 0] - acc[2] / vy_T * phi[1, 0],
             phi[5, 4] - acc[2] / vy_T * phi[1, 4]],
        ])
        dx, dvy = np.linalg.solve(M, -np.array([vx_T, vz_T]))
        # damp large steps (far initial guesses)
        scale = min(1.0, 0.02 / max(abs(dx), abs(dvy)))
        x0 += dx * scale
        vy0 += dvy * scale
    raise RuntimeError(
        f"halo correction did not converge: residual vx={vx_T:.2e} "
        f"vz={vz_T:.2e}")


@dataclasses.dataclass
class HaloOrbit:
    state0: np.ndarray   # barycentric rotating, normalized
    period: float        # normalized
    mu: float = EM_MU

    def sample(self, n: int) -> np.ndarray:
        """n states uniformly spaced over one period (closed orbit)."""
        return propagate(self.state0, self.period, n, self.mu)[:-1]


# A coarse southern L2 NRHO-class seed; correct_halo converges from
# here (the corrected orbit's properties are asserted by tests, so the
# seed only needs to be in the basin).
L2_SOUTH_SEED = dict(x0=1.02, z0=-0.18, vy0=-0.10)


def l2_southern_halo(z0: float = L2_SOUTH_SEED["z0"],
                     mu: float = EM_MU) -> HaloOrbit:
    """Differentially-corrected southern L2 halo member at out-of-plane
    amplitude `z0` (normalized; -0.18 is NRHO-like)."""
    s0, T = correct_halo(L2_SOUTH_SEED["x0"], z0, L2_SOUTH_SEED["vy0"], mu)
    return HaloOrbit(state0=s0, period=T, mu=mu)


def rotating_to_moon_centered_km(states: np.ndarray, t_arr: np.ndarray,
                                 mu: float = EM_MU,
                                 inertial: bool = True) -> np.ndarray:
    """Barycentric rotating normalized positions -> Moon-centered km.

    With `inertial`, un-rotate by the frame angle theta = t (normalized
    time IS the rotation angle) about +z, yielding a Moon-centered
    non-rotating frame — the frame the pose pipeline treats as "world"
    (the renderer only consumes relative geometry + a Sun offset, so
    any consistent inertial frame works).
    """
    pos = states[:, :3].copy()
    pos[:, 0] -= (1.0 - mu)               # Moon-centered, still rotating
    pos_km = pos * LSTAR_KM
    if not inertial:
        return pos_km
    th = np.asarray(t_arr)
    c, s = np.cos(th), np.sin(th)
    out = np.empty_like(pos_km)
    out[:, 0] = c * pos_km[:, 0] - s * pos_km[:, 1]
    out[:, 1] = s * pos_km[:, 0] + c * pos_km[:, 1]
    out[:, 2] = pos_km[:, 2]
    return out
