"""Orbit simulator CLI, flag-compatible with the reference
(orbit_sim/lunar_polar_orbit_sim.py:284-353); port of
dsrt_tpu/orbit/cli.py:

    python -m dsrt_tpu_torch.orbit.cli --time 1 --dt 0.01 --txt poses.txt
        [--peri_alt 100 --apo_alt 1000 --incl 90 --raan 0 --argp 90]
        [--epoch_utc 2027-01-25T00:00:00] [--meta path/to/meta.tm]
        [--moon_centered] [--sun_view | --moon_view] [--device cuda]

The Kepler families (polar, plane_offset) propagate the chaser as one
batched float64 PyTorch computation on `--device`: the card by default,
`--device cpu` for the host.  The reference's `--jax` switch has no
counterpart: there is one path.  The device is resolved first, so asking
for the card where there is none fails whatever the family; the NRHO
family itself integrates the CR3BP on the host.

`--meta` mirrors the reference's quirk of using the meta file only to
locate the SPICE kernel *folder* (lunar_polar_orbit_sim.py:363-366); the
kernels themselves are optional here (analytic ephemeris fallback).
"""

from __future__ import annotations

import argparse
import os
import sys

from dsrt_tpu_torch.device import resolve_device
from dsrt_tpu_torch.orbit.trajectory import (
    OrbitElements, generate_pose_file, generate_polar_rendezvous_trajectory)
from dsrt_tpu_torch.orbit.ephemeris import DEFAULT_EPOCH_UTC


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="dsrt_tpu_torch.orbit",
                                description="Lunar polar rendezvous pose generator")
    p.add_argument("--time", type=float, default=600.0,
                   help="trajectory duration in seconds (propagated from -time to 0)")
    p.add_argument("--dt", type=float, default=1.0, help="time step [s]")
    p.add_argument("--peri_alt", type=float, default=100.0)
    p.add_argument("--apo_alt", type=float, default=1000.0)
    p.add_argument("--incl", type=float, default=90.0)
    p.add_argument("--raan", type=float, default=0.0)
    p.add_argument("--argp", type=float, default=90.0)
    p.add_argument("--txt", default="rendezvous.txt", help="output pose file")
    p.add_argument("--meta", default="",
                   help="SPICE meta file; only its folder is used to find kernels")
    p.add_argument("--epoch_utc", default=DEFAULT_EPOCH_UTC)
    p.add_argument("--moon_centered", action="store_true",
                   help="skip the Sun-centered shift (debug)")
    p.add_argument("--sun_view", action="store_true",
                   help="matplotlib 3D Sun-view plot (+ --animate for the "
                        "reference's FuncAnimation, saved as GIF)")
    p.add_argument("--moon_view", action="store_true",
                   help="matplotlib Moon-centered orbit plot")
    p.add_argument("--animate", action="store_true",
                   help="save the sun view as an animated GIF "
                        "(lunar_polar_orbit_sim.py:445-579 FuncAnimation)")
    p.add_argument("--device", default="cuda",
                   help="torch device of the Kepler families' batched "
                        "float64 solve: cuda (the default) or cpu")
    # beyond-reference trajectory families (ROADMAP)
    p.add_argument("--family", choices=["polar", "plane_offset", "nrho"],
                   default="polar",
                   help="polar: reference-parity same-orbit phase sweep. "
                        "plane_offset: non-coplanar flyby (chaser orbit "
                        "inclined by --dincl more). nrho: CR3BP Earth-"
                        "Moon L2 southern halo (Gateway-class NRHO; "
                        "differentially corrected, orbit/cr3bp.py)")
    p.add_argument("--dincl", type=float, default=1.0,
                   help="plane_offset: chaser inclination offset [deg]")
    p.add_argument("--nrho_z0", type=float, default=-0.18,
                   help="nrho: out-of-plane amplitude (normalized EM "
                        "units; -0.18 ~ 2,800 km perilune NRHO)")
    p.add_argument("--nrho_lead", type=float, default=600.0,
                   help="nrho: chaser's initial along-orbit lead [s]")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    elements = OrbitElements(peri_alt_km=args.peri_alt,
                             apo_alt_km=args.apo_alt, incl_deg=args.incl,
                             raan_deg=args.raan, argp_deg=args.argp)
    kernel_dir = os.path.dirname(args.meta) if args.meta else None
    n = generate_pose_file(args.txt, time_s=args.time, dt=args.dt,
                           elements=elements, epoch_utc=args.epoch_utc,
                           kernel_dir=kernel_dir,
                           sun_centered=not args.moon_centered,
                           device=device,
                           family=args.family,
                           dincl_deg=args.dincl, nrho_z0=args.nrho_z0,
                           nrho_lead_s=args.nrho_lead)
    print(f"[+] {n} poses")

    if args.sun_view or args.moon_view:
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
            t, r_tgt, r_chs = generate_polar_rendezvous_trajectory(
                elements, t_start=-args.time, t_end=0.0, dt=args.dt,
                device=device)
            fig = plt.figure(figsize=(8, 8))
            ax = fig.add_subplot(projection="3d")
            ax.plot(*r_chs.T, label="chaser")
            ax.scatter(*r_tgt[0], c="r", label="target (periapsis)")
            if args.moon_view:
                u = __import__("numpy").linspace(0, 2 * 3.14159, 30)
                v = __import__("numpy").linspace(0, 3.14159, 15)
                import numpy as np
                R = 1737.4
                ax.plot_wireframe(R * np.outer(np.cos(u), np.sin(v)),
                                  R * np.outer(np.sin(u), np.sin(v)),
                                  R * np.outer(np.ones_like(u), np.cos(v)),
                                  alpha=0.2)
            ax.legend()
            if args.sun_view and args.animate:
                # the reference's FuncAnimation sun view
                # (lunar_polar_orbit_sim.py:445-579), saved headlessly
                from matplotlib.animation import FuncAnimation, PillowWriter
                import numpy as np
                step = max(1, len(r_chs) // 120)  # <= ~120 frames
                pts = r_chs[::step]
                dot = ax.plot([pts[0, 0]], [pts[0, 1]], [pts[0, 2]], "o",
                              c="tab:orange", label="chaser (t)")[0]

                def update(k):
                    dot.set_data([pts[k, 0]], [pts[k, 1]])
                    dot.set_3d_properties([pts[k, 2]])
                    ax.set_title(f"t = {t[::step][k]:.1f} s")
                    return (dot,)

                anim = FuncAnimation(fig, update, frames=len(pts),
                                     interval=50, blit=False)
                out = os.path.splitext(args.txt)[0] + "_sun_view.gif"
                anim.save(out, writer=PillowWriter(fps=20))
                print(f"[+] animation saved to {out}")
            else:
                out = os.path.splitext(args.txt)[0] + (
                    "_sun_view.png" if args.sun_view else "_moon_view.png")
                fig.savefig(out, dpi=110)
                print(f"[+] view saved to {out}")
        except Exception as e:
            print(f"view unavailable: {e}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
