"""The port's pose generator (dsrt_tpu_torch/orbit/) against the JAX
package's (dsrt_tpu/orbit/) on the CPU.

Tolerances: the copied NumPy functions identical; the batched float64
PyTorch Kepler solve within 1e-12 rad and 1e-6 km of NumPy's; the CLI's
pose files within 1e-3 m of the JAX package's for the Kepler families
(propagated in PyTorch) and identical for the NRHO family (NumPy on the
host in both).
"""

import numpy as np
import pytest
import torch

from dsrt_tpu.orbit import cli as jax_cli
from dsrt_tpu.orbit import cr3bp as jax_cr3bp
from dsrt_tpu.orbit import ephemeris as jax_ephemeris
from dsrt_tpu.orbit import kepler as jax_kepler
from dsrt_tpu.orbit import trajectory as jax_trajectory
from dsrt_tpu_torch.orbit import cli, cr3bp, ephemeris, kepler, trajectory

E_ORBIT = 0.196756     # the default orbit's eccentricity (100 x 1000 km)
ANGLES = (np.deg2rad(90.0), 0.3, np.deg2rad(90.0))


def _anomalies():
    return np.random.default_rng(0).uniform(-4 * np.pi, 4 * np.pi, 257)


COPIES = {
    "solve_kepler_E": lambda m: m.solve_kepler_E(_anomalies(), E_ORBIT),
    "true_anomaly_from_E": lambda m: m.true_anomaly_from_E(_anomalies(),
                                                           E_ORBIT),
    "perifocal_to_inertial": lambda m: m.perifocal_to_inertial(*ANGLES),
    "coe_to_rv": lambda m: np.concatenate(m.coe_to_rv(
        2287.4, E_ORBIT, *ANGLES, 1.234)),
    "constants": lambda m: np.array([m.MU_MOON, m.R_MOON, m.R_SUN]),
}


@pytest.mark.parametrize("name", sorted(COPIES))
def test_kepler_copies_equal_jax(name):
    a, b = COPIES[name](kepler), COPIES[name](jax_kepler)
    assert a.dtype == b.dtype and np.array_equal(a, b)


def test_ephemeris_and_cr3bp_copies_equal_jax():
    for epoch in (ephemeris.DEFAULT_EPOCH_UTC, "2031-06-01T12:30:00"):
        assert np.array_equal(ephemeris.get_moon_pos_from_sun(epoch),
                              jax_ephemeris.get_moon_pos_from_sun(epoch))
    s0 = np.array([1.02, 0.0, -0.18, 0.0, -0.1, 0.0])
    assert np.array_equal(cr3bp.eom(s0), jax_cr3bp.eom(s0))
    aug = np.concatenate([s0, np.eye(6).reshape(-1)])
    assert np.array_equal(cr3bp.eom_stm(aug), jax_cr3bp.eom_stm(aug))
    assert np.array_equal(cr3bp.propagate(s0, 0.5, 64),
                          jax_cr3bp.propagate(s0, 0.5, 64))
    assert cr3bp.jacobi_constant(s0) == jax_cr3bp.jacobi_constant(s0)
    t = np.linspace(0.0, 1.0, 7)
    states = cr3bp.propagate(s0, 0.5, 6)
    assert np.array_equal(cr3bp.rotating_to_moon_centered_km(states, t),
                          jax_cr3bp.rotating_to_moon_centered_km(states, t))


def test_torch_kepler_matches_numpy():
    M = _anomalies()
    E = kepler.solve_kepler_E_torch(M, E_ORBIT, device="cpu")
    assert E.dtype == torch.float64 and E.device.type == "cpu"
    assert np.abs(E.numpy() - kepler.solve_kepler_E(M, E_ORBIT)).max() \
        <= 1e-12
    f_ref = kepler.true_anomaly_from_E(E.numpy(), E_ORBIT)
    f = kepler.true_anomaly_from_E_torch(E, E_ORBIT, device="cpu")
    assert f.dtype == torch.float64
    assert np.abs(f.numpy() - f_ref).max() <= 1e-12
    r, v = kepler.coe_to_rv_torch(2287.4, E_ORBIT, *ANGLES, f, device="cpu")
    assert r.shape == v.shape == (len(f), 3) and r.dtype == torch.float64
    ref = [kepler.coe_to_rv(2287.4, E_ORBIT, *ANGLES, fk) for fk in f_ref]
    assert np.abs(r.numpy() - np.stack([x[0] for x in ref])).max() <= 1e-6
    assert np.abs(v.numpy() - np.stack([x[1] for x in ref])).max() <= 1e-9


def _cli_pose_files(tmp_path, args):
    ours, theirs = tmp_path / "port.txt", tmp_path / "jax.txt"
    assert cli.main(args + ["--device", "cpu", "--txt", str(ours)]) == 0
    assert jax_cli.main(args + ["--txt", str(theirs)]) == 0
    return ours, theirs


@pytest.mark.parametrize("family", ["polar", "plane_offset", "nrho"])
def test_cli_pose_file_matches_jax(tmp_path, family):
    ours, theirs = _cli_pose_files(
        tmp_path, ["--time", "30", "--dt", "2", "--family", family])
    a, b = np.loadtxt(str(ours)), np.loadtxt(str(theirs))
    assert a.shape == b.shape and len(a) >= 15
    if family == "nrho":
        assert ours.read_bytes() == theirs.read_bytes()
    else:
        assert np.abs(a - b).max() <= 1e-3


def test_cli_default_span_matches_jax(tmp_path):
    """The CLI's default 600 s at 1 s, the span a user renders."""
    ours, theirs = _cli_pose_files(tmp_path, [])
    a, b = np.loadtxt(str(ours)), np.loadtxt(str(theirs))
    assert a.shape == b.shape and len(a) >= 590
    assert np.abs(a - b).max() <= 1e-3


@pytest.mark.parametrize("family", ["polar", "plane_offset"])
def test_trajectory_chaser_matches_jax(family):
    t_range = dict(t_start=-60.0, dt=1.5)
    if family == "polar":
        ours = trajectory.generate_polar_rendezvous_trajectory(
            trajectory.OrbitElements(), device="cpu", **t_range)
        theirs = jax_trajectory.generate_polar_rendezvous_trajectory(
            jax_trajectory.OrbitElements(), **t_range)
    else:
        ours = trajectory.generate_offset_rendezvous_trajectory(
            trajectory.OrbitElements(), device="cpu", **t_range)
        theirs = jax_trajectory.generate_offset_rendezvous_trajectory(
            jax_trajectory.OrbitElements(), **t_range)
    (t, tgt, chs), (t2, tgt2, chs2) = ours, theirs
    assert np.array_equal(t, t2) and np.array_equal(tgt, tgt2)
    assert np.abs(chs - chs2).max() <= 1e-6


def test_cli_without_a_card_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for family in ("polar", "nrho"):
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(["--time", "2", "--dt", "1", "--family", family,
                      "--txt", str(tmp_path / "p.txt")])
    with pytest.raises(RuntimeError, match="CUDA"):
        kepler.solve_kepler_E_torch(_anomalies(), E_ORBIT)
