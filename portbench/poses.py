"""Rendezvous poses: the generator that wrote data/poses99.txt, the pose
file's format, and the float64 world-to-model transform of a frame.

Frozen NumPy copies, for the benchmark's own use, of the orbit CLI's
polar Kepler family (dsrt_tpu_torch/orbit/kepler.py `solve_kepler_E_torch`,
`true_anomaly_from_E_torch`, `coe_to_rv_torch`, `perifocal_to_inertial`;
orbit/trajectory.py `_kepler_chaser`, `export_txt`; orbit/ephemeris.py
`_analytic_moon_from_sun`, all at commit 4d12af8), of
dsrt_tpu_torch/utils/pose.py (`parse_pose_lines`, `format_pose_line`) and
of dsrt_tpu_torch/utils/transform.py (`rotate_yaw_deg`, `pose_to_frame`,
commit f0b5744).

Regenerate the data file (it is committed; nothing regenerates it in a
run):

    python3 -m portbench.poses portbench/data/poses99.txt
"""

from __future__ import annotations

import datetime as _dt
import math
import sys

import numpy as np

MU_MOON = 4902.800066
R_MOON = 1737.4
AU_KM = 149_597_870.7
EPOCH_UTC = "2027-01-25T00:00:00"
SEPARATION_STOP_M = 25.0
HEADER = ("# cam_x  cam_y  cam_z     model_x model_y model_z     "
          "yaw  pitch  roll\n")


def _moon_from_sun(epoch_utc: str = EPOCH_UTC) -> np.ndarray:
    t = _dt.datetime.fromisoformat(epoch_utc)
    days = (t - _dt.datetime(2000, 1, 1, 12, 0, 0)).total_seconds() / 86400.0
    T = days / 36525.0
    d2r = math.pi / 180.0
    L = (100.46435 + 35999.372854 * T) * d2r
    g = (357.52911 + 35999.05029 * T) * d2r
    e = 0.016708634 - 0.000042037 * T
    C = ((1.914602 - 0.004817 * T) * np.sin(g)
         + (0.019993 - 0.000101 * T) * np.sin(2 * g)
         + 0.000289 * np.sin(3 * g)) * d2r
    lam = L + C
    r_au = 1.000001018 * (1 - e * e) / (1 + e * np.cos(g + C))
    earth = r_au * AU_KM * np.array([np.cos(lam), np.sin(lam), 0.0])
    Lp = (218.3164477 + 481267.88123421 * T) * d2r
    D = (297.8501921 + 445267.1114034 * T) * d2r
    Mp = (134.9633964 + 477198.8675055 * T) * d2r
    F = (93.2720950 + 483202.0175233 * T) * d2r
    lon = Lp + d2r * (6.288774 * np.sin(Mp) + 1.274027 * np.sin(2 * D - Mp)
                      + 0.658314 * np.sin(2 * D))
    lat = d2r * (5.128122 * np.sin(F))
    rm = 385000.56 - 20905.355 * np.cos(Mp)
    moon = rm * np.array([np.cos(lat) * np.cos(lon),
                          np.cos(lat) * np.sin(lon), np.sin(lat)])
    eps = 23.439291 * d2r
    R = np.array([[1, 0, 0], [0, np.cos(eps), -np.sin(eps)],
                  [0, np.sin(eps), np.cos(eps)]])
    return R @ (moon + earth)


def _perifocal_to_inertial(i, Omega, omega):
    cO, sO = np.cos(Omega), np.sin(Omega)
    co, so = np.cos(omega), np.sin(omega)
    ci, si = np.cos(i), np.sin(i)
    R3_O = np.array([[cO, -sO, 0.0], [sO, cO, 0.0], [0.0, 0.0, 1.0]])
    R1_i = np.array([[1.0, 0.0, 0.0], [0.0, ci, si], [0.0, -si, ci]])
    R3_o = np.array([[co, -so, 0.0], [so, co, 0.0], [0.0, 0.0, 1.0]])
    return R3_O @ R1_i @ R3_o


def polar_rendezvous(time_s: float = 1.0, dt: float = 0.01):
    """(camera, model) positions in metres, Sun-centred, of the polar
    family's chaser and target (peri 100 km, apo 1000 km, i 90, RAAN 0,
    argp 90), stopping before the first pose closer than 25 m."""
    rp, ra = R_MOON + 100.0, R_MOON + 1000.0
    a = 0.5 * (rp + ra)
    e = 1.0 - rp / a
    Q = _perifocal_to_inertial(np.deg2rad(90.0), 0.0, np.deg2rad(90.0))
    n = np.sqrt(MU_MOON / a ** 3)
    N = int(round(time_s / dt)) + 1
    t = -time_s + dt * np.arange(N)

    M = n * t
    E = M.copy()
    for _ in range(50):
        E = E - (E - e * np.sin(E) - M) / (1.0 - e * np.cos(E))
    cosE, sinE = np.cos(E), np.sin(E)
    denom = 1.0 - e * cosE
    f = np.arctan2(np.sqrt(1.0 - e ** 2) * sinE / denom, (cosE - e) / denom)
    r_mag = a * (1.0 - e ** 2) / (1.0 + e * np.cos(f))
    px, py = r_mag * np.cos(f), r_mag * np.sin(f)
    chaser = np.stack([Q[k][0] * px + Q[k][1] * py for k in range(3)], -1)
    target = Q @ np.array([a * (1.0 - e ** 2) / (1.0 + e), 0.0, 0.0])

    moon = _moon_from_sun()
    cams, models = [], []
    for c in chaser:
        cam_km, mdl_km = c + moon, target + moon
        if float(np.linalg.norm(cam_km - mdl_km)) * 1000.0 < SEPARATION_STOP_M:
            break
        cams.append(cam_km * 1000.0)
        models.append(mdl_km * 1000.0)
    return np.asarray(cams), np.asarray(models)


def format_pose_line(cam, model, yaw: float = 90.0) -> str:
    return (f"{cam[0]: .6f}  {cam[1]: .6f}  {cam[2]: .6f}    "
            f"{model[0]: .6f}  {model[1]: .6f}  {model[2]: .6f}    "
            f"{yaw: .1f}  {0.0: .1f}  {0.0: .1f}\n")


def pose_text(cams, models) -> str:
    return HEADER + "".join(format_pose_line(c, m) for c, m in
                            zip(cams, models))


def read_pose_lines(path: str) -> list:
    """The pose lines of a pose file (comments and short lines dropped),
    each as written."""
    out = []
    with open(path) as fh:
        for line in fh:
            s = line.strip()
            if s and not s.startswith("#") and len(s.split()) >= 9:
                out.append(line if line.endswith("\n") else line + "\n")
    return out


def frame_of(line: str):
    """(camera in the model frame f32[3], model->Sun direction f32[3],
    separation in metres) of one pose line, in float64 until the last
    rounding, as the program's driver computes them."""
    vals = [float(p) for p in line.split()[:9]]
    cam_w = np.array(vals[0:3], np.float64)
    mdl_w = np.array(vals[3:6], np.float64)
    yaw = vals[6]
    cam_rel = cam_w - mdl_w
    light_rel = np.zeros(3) - mdl_w

    def unyaw(v):
        rad = math.radians(-yaw)
        c, s = math.cos(rad), math.sin(rad)
        return np.array([c * v[0] + s * v[2], v[1], -s * v[0] + c * v[2]],
                        np.float64)

    cam = unyaw(cam_rel)
    light = unyaw(light_rel)
    ln = np.linalg.norm(light)
    sun = light / ln if ln > 0 else np.zeros(3)
    return (cam.astype(np.float32), sun.astype(np.float32),
            float(np.linalg.norm(cam_rel)))


if __name__ == "__main__":
    with open(sys.argv[1], "w") as fh:
        fh.write(pose_text(*polar_rendezvous()))
