"""One run of one cell: set-up, warm-up, the measured window, the check.

Set-up (what `setup_s` measures, from process start): import the
program, make the stand-in mesh and read the texture (the benchmark's own
inputs), compile the scene with the program's SceneBuilder as the driver
does (SBVH, sun on, the configuration's sun radiance, the run's seed),
where the configuration has an `upscale` stage its seeded weights
(portbench/weights.py through the benchmark's `stages/<upscale.arch>.py`,
a checkpoint in the run's directory), and one
warm-up call of the driver at the cell's frame size and spp, stage and
all.

The window: whole calls of `dsrt_tpu_torch.driver.run(args, scene=...)`,
the CLI's own frame loop (`--mode auto`, pipelined), each with one pose
file of the cell's traffic and a fresh output directory, until
`--seconds` have passed; no call is cut short.  Each frame is stamped
from outside the program by its final output's modification time, read
after the call: the raw PNG, or with a stage the stage's PNG in
`<output_dir><upscale.output_suffix>`.

After the window: the peak device memory, then the program's state is
let go and the check (portbench/check.py) judges a sample of the PNGs.
"""

from __future__ import annotations

import contextlib
import gc
import os
import shutil
import sys
import tempfile
import time

from portbench import check, pngio, standin
from portbench import trace as tracemod
from portbench import traffic as trafficmod
from portbench import weights as weightsmod

FORBIDDEN = ("jax", "jaxlib", "flax", "dsrt_tpu", "bench", "benchmarks")


def process_start_s() -> float:
    """Seconds since this process started (Linux /proc), so that set-up
    counts the interpreter's start and every import."""
    with open("/proc/self/stat") as fh:
        start_ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as fh:
        uptime = float(fh.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is the JAX stack's or the JAX
    package's (names compared whole)."""
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def program_mesh(mesh: standin.Mesh):
    """The benchmark's mesh as the program's MeshData, one program
    Material per benchmark material."""
    from dsrt_tpu_torch.models.materials import Material
    from dsrt_tpu_torch.models.obj import MeshData
    mats = {}
    for m in mesh.materials:
        if id(m) not in mats:
            mats[id(m)] = (Material.metal(m.albedo, m.fuzz)
                           if m.kind == standin.METAL
                           else Material.lambertian(m.albedo))
    return MeshData(mesh.v0, mesh.v1, mesh.v2, mesh.uv0, mesh.uv1, mesh.uv2,
                    [mats[id(m)] for m in mesh.materials],
                    list(mesh.tex_paths))


def driver_args(cfg: dict, pose_file: str, out_dir: str, tsv: str,
                seed: int, device: str, weights: str | None = None) -> list:
    """The driver's arguments for one call; a configuration's `upscale`
    stage appends its `driver_flags`, with `{weights}` (the seeded
    checkpoint) and `{seed}` filled in."""
    up = cfg.get("upscale")
    extra = ([f.format_map({"weights": weights, "seed": seed})
              for f in up["driver_flags"]] if up else [])
    return ["--input_txt", pose_file, "--output_dir", out_dir,
            "--width", str(cfg["width"]), "--height", str(cfg["height"]),
            "--spp", str(cfg["spp"]), "--max_depth", str(cfg["max_depth"]),
            "--vfov", str(cfg["vfov"]), "--gamma", str(cfg["gamma"]),
            "--sun_radiance", *(str(r) for r in cfg["sun_radiance"]),
            "--seed", str(seed), "--bvh", cfg["bvh"], "--mode", cfg["mode"],
            "--dispatch_rays", str(cfg["dispatch_rays"]),
            "--timings_tsv", tsv, "--device", device, *extra]


def final_dir(cfg: dict, out_dir: str) -> str:
    """Where the frames the user gets are written: the raw PNGs' directory,
    or with a stage the stage's."""
    up = cfg.get("upscale")
    return out_dir + up["output_suffix"] if up else out_dir


class Frame:
    """One frame of a call: its raw PNG, its final output (the raw PNG
    where there is no stage) and the wait for that final output."""
    __slots__ = ("call", "pose", "line", "png", "final", "wait_s")

    def __init__(self, call, pose, line, png, wait_s, final=None):
        self.call, self.pose, self.line = call, pose, line
        self.png, self.wait_s = png, wait_s
        self.final = png if final is None else final


class Run:
    """What a window left for the metric readers: `frames` (Frame, in
    order; wait_s None where no final output came), `window_s`, `tsv`
    [(stage, seconds)] of every call, `trace` (portbench.trace.Trace or None),
    `setup_s`, `scene_compile_s`, `calls`, and `setup_phases`, the
    seconds of each part of set-up (for the record, not a metric)."""

    def __init__(self):
        self.frames, self.tsv = [], []
        self.window_s = self.setup_s = self.scene_compile_s = 0.0
        self.trace = None
        self.calls = 0
        self.setup_phases = {}

    @property
    def written(self) -> int:
        return sum(f.wait_s is not None for f in self.frames)


def _call(driver, scene, cfg, lines, picks, seed, device, work, k, log,
          weights=None):
    """One driver call over the poses `picks`; returns its Frames and TSV
    rows."""
    d = os.path.join(work, f"call{k}")
    out = os.path.join(d, "out")
    os.makedirs(out)
    pose_file = os.path.join(d, "poses.txt")
    with open(pose_file, "w") as fh:
        fh.write("".join(lines[i] for i in picks))
    tsv = os.path.join(d, "timings.tsv")
    args = driver.build_parser().parse_args(
        driver_args(cfg, pose_file, out, tsv, seed, device, weights))
    t0 = time.time_ns()
    with contextlib.redirect_stdout(log):
        rc = driver.run(args, scene=scene)
    if rc != 0:
        raise RuntimeError(f"driver.run returned {rc}")
    frames, prev = [], t0
    fin = final_dir(cfg, out)
    for j, i in enumerate(picks):
        name = f"frame_{j:04d}.png"
        final = os.path.join(fin, name)
        wait = None
        if os.path.exists(final):
            m = os.stat(final).st_mtime_ns
            wait, prev = (m - prev) * 1e-9, m
        frames.append(Frame(k, i, lines[i], os.path.join(out, name), wait,
                            final))
    rows = []
    with open(tsv) as fh:
        next(fh)
        for ln in fh:
            stage, ns, _ = ln.rstrip("\n").split("\t")
            rows.append((stage, int(ns) * 1e-9))
    return frames, rows


def run_cell(bench, cell_name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t0: float | None = None,
             control: str | None = None):
    """Run one cell; returns (result line as a dict, Run, the check's
    verdict).  `t0`: time.perf_counter() at process start (set-up counts
    from there; the call's start when None).  `control`: one of
    check.CONTROLS put in the program's place by the check."""
    t0 = time.perf_counter() if t0 is None else t0
    import torch
    from dsrt_tpu_torch import driver
    from dsrt_tpu_torch.models.scene import SceneBuilder
    run = Run()
    marks = [("imports", time.perf_counter())]
    if device == "cuda":
        torch.zeros(1, device=device)      # the CUDA context, outside the
        torch.cuda.synchronize()           # scene compile's time
        marks.append(("cuda_init", time.perf_counter()))

    cell = bench.cell(cell_name)
    cfg = bench.config(cell["config"])
    mix = bench.traffic(cell["traffic"])
    lines = trafficmod.pose_lines(bench, mix)
    tex_path = str(bench.data(cfg["texture"]))
    mesh = standin.standin_mesh(int(cfg["standin_detail"]), tex_path)
    texture = pngio.read_rgb8(tex_path)

    t_c = time.perf_counter()
    marks.append(("mesh_and_texture", t_c))
    b = SceneBuilder(sun_enabled=True, sun_dir=(0.0, 1.0, 0.0),
                     sun_radiance=tuple(cfg["sun_radiance"]), seed=seed,
                     bvh_method=cfg["bvh"])
    b.add_mesh(program_mesh(mesh))
    scene = b.build(device=device)
    run.scene_compile_s = time.perf_counter() - t_c
    marks.append(("scene_compile", time.perf_counter()))

    work = tempfile.mkdtemp(prefix="portbench-")
    try:
        wpath = None
        if "upscale" in cfg:
            wpath = weightsmod.write(cfg["upscale"], seed, device,
                                     os.path.join(work, "upscale.pth"),
                                     bench.root)
            if device == "cuda":
                torch.cuda.synchronize()
            marks.append(("upscale_weights", time.perf_counter()))
        with open(os.path.join(work, "driver.log"), "w") as log:
            first = trafficmod.call_poses(mix, seed, 0)[:1]
            _call(driver, scene, cfg, lines, first, seed, device, work,
                  "warmup", log, wpath)
            if device == "cuda":
                torch.cuda.synchronize()
            marks.append(("warmup_call", time.perf_counter()))
            prev = t0
            for name, t in marks:
                run.setup_phases[name], prev = t - prev, t
            prof = None
            if trace:
                from torch.profiler import ProfilerActivity, profile
                acts = [ProfilerActivity.CPU]
                if device == "cuda":
                    acts.append(ProfilerActivity.CUDA)
                prof = profile(activities=acts)
                prof.__enter__()
            run.setup_s = time.perf_counter() - t0
            rf = (torch.profiler.record_function if trace
                  else lambda name: contextlib.nullcontext())
            w0 = time.perf_counter()
            with rf(tracemod.WINDOW):
                while True:
                    picks = trafficmod.call_poses(mix, seed, run.calls)
                    with rf(tracemod.CALL):
                        frames, rows = _call(driver, scene, cfg, lines, picks,
                                             seed, device, work, run.calls,
                                             log, wpath)
                    run.frames += frames
                    run.tsv += rows
                    run.calls += 1
                    if time.perf_counter() - w0 >= seconds:
                        break
            if device == "cuda":
                torch.cuda.synchronize()
            run.window_s = time.perf_counter() - w0
            if prof is not None:
                prof.__exit__(None, None, None)
                path = os.path.join(work, "trace.json")
                prof.export_chrome_trace(path)
                del prof
                run.trace = tracemod.load(path)
                os.unlink(path)
        peak = (torch.cuda.max_memory_allocated() if device == "cuda"
                else 0)
        kind = (torch.cuda.get_device_name(0) if device == "cuda"
                else "cpu")
        del scene, b
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
        verdict = check.judge(
            cfg, [(f.line, f.png, f.final) for f in run.frames], mesh,
            texture, seed, device, control=control, weights=wpath,
            root=bench.root)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    kind_key = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in bench.metrics(cell_name, kind_key):
        value = bench.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device == "cuda" else device, "kind": kind,
           "count": int(cell["chips"]), "memory_peak_bytes": int(peak)}
    if run.trace is not None:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
    result = {"correct": bool(verdict["correct"]),
              "attempted": len(run.frames),
              "failed": len(run.frames) - run.written,
              "metrics": metrics, "device": dev}
    if run.trace is not None:
        result["breakdown"] = tracemod.breakdown(run.trace)
    result["check"] = {n: {"value": v, "limit": verdict["limits"][n]}
                       for n, v in verdict["numbers"].items()}
    return result, run, verdict
