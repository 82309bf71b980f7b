"""The metric readers on a canned profiler trace and driver TSV."""

import json

import pytest

from portbench import trace as tracemod
from portbench.harness import Frame, Run
from portbench.registry import Bench

K = "void dsrt::path_render_kernel<0>(dsrt::PathArgs)"
RDB = "void rdb_conv_kernel<32, 64, 2, 4, 1>(RdbConvArgs)"
RDV_A_X4_FLOPS = 16_447_954_747_392      # work_esrgan, a frame of rdv_a_x4


def canned_events():
    ev = [{"ph": "X", "cat": "user_annotation", "name": tracemod.WINDOW,
           "ts": 1000.0, "dur": 10000.0},
          {"ph": "X", "cat": "user_annotation", "name": tracemod.CALL,
           "ts": 1000.0, "dur": 7000.0},
          {"ph": "X", "cat": "cpu_op", "name": "aten::copy_",
           "ts": 4400.0, "dur": 300.0}]
    # two path kernel launches, one overlapping memcpy, one tonemap kernel
    ev += [{"ph": "X", "cat": "kernel", "name": K, "ts": 1500.0, "dur": 2000.0},
           {"ph": "X", "cat": "kernel", "name": K, "ts": 5000.0, "dur": 3000.0},
           {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH",
            "ts": 7500.0, "dur": 1000.0},
           {"ph": "X", "cat": "kernel", "name": "pow_kernel", "ts": 3600.0,
            "dur": 400.0},
           # outside the window: not counted
           {"ph": "X", "cat": "kernel", "name": K, "ts": 20000.0, "dur": 50.0}]
    return ev


def canned_run():
    run = Run()
    # the upscale stage's device work by program span (Trace.span_ops) and
    # its dense-block kernel, beside the canned trace's own
    tr = tracemod.reduce(canned_events())
    run.trace = tr._replace(
        span_ops={"upscale": (0.004, 8), "upscale_forward": (1.596, 1400),
                  "launch": (0.005, 2)},
        ops=dict(tr.ops, **{RDB: (1.2, 1380)}))
    run.window_s = 4.0
    run.setup_s = 12.5
    run.scene_compile_s = 1.75
    run.frames = [Frame(0, i, "", "", w) for i, w in
                  enumerate([0.5, 0.25, 0.25, None, 1.5])]
    run.tsv = [("render", 0.2), ("encode", 0.01), ("render", 0.3),
               ("encode", 0.03), ("render", 0.1), ("encode", 0.02),
               ("render", 0.2), ("encode", 0.02)]
    run.tsv += [("inputs", 0.001), ("issue", 0.003), ("launch", 0.002),
                ("wait", 0.004)] * 4 + [("run", 3.5)]
    run.tsv += [("upscale", 0.06), ("upscale_forward", 0.05),
                ("upscale_encode", 0.35)] * 4
    run.tsv += [("upscale_finish", 0.01)] * 3 + [("upscale_drain", 0.3)]
    return run


def test_trace_reduction():
    tr = tracemod.reduce(canned_events())
    assert tr.window_s == pytest.approx(0.010)
    # busy: [1500,3500] [3600,4000] [5000,8500] -> 5.9 ms
    assert tr.busy_s == pytest.approx(0.0059)
    assert tr.ops[K] == (pytest.approx(0.005), 2)
    gaps = dict((round(s, 6), lab) for lab, s in tr.gaps)
    assert gaps[0.0025] == "harness between driver calls"     # 8500-11000
    assert gaps[0.001] == "aten::copy_"                        # 4000-5000
    assert gaps[0.0005] == "driver host code outside torch ops"  # 1000-1500
    bd = tracemod.breakdown(tr)
    assert bd["device_ops"][0] == [K, pytest.approx(0.005)]
    assert len(bd["idle_gaps"]) == 4


EXPECT = {
    "s_per_frame": 1.0,                      # 4 s over 4 PNGs
    "frame_p95_s": 1.35,                     # waits .25 .25 .5 1.5, linear
    "setup_s": 12.5,
    "scene.compile_s": 1.75,
    "driver.encode_ms": 80.0 / 4,
    "driver.render_stage_ms": 800.0 / 4,
    "path_kernel.device_ms": 5.0 / 4,
    "path_kernel.launches": 2 / 4,
    "device.idle_share": 100.0 * (1 - 0.0059 / 0.010),
    "driver.inputs_ms": 4.0 / 4,
    "driver.wait_ms": 16.0 / 4,
    "render.host_ms": 12.0 / 4,
    "path_kernel.wrapper_ms": 8.0 / 4,
    "upscale.device_ms": 1600.0 / 4,         # span_ops upscale + forward
    "upscale.host_ms": 240.0 / 4,
    "upscale.encode_ms": 1400.0 / 4,
    "upscale.forwards": 4 / 4,
    "upscale.mfu.rdv_a_x4": RDV_A_X4_FLOPS * 4 / (1.6 * 67e12),
    "upscale.dense_launches": 1380 / 4,
    "upscale.overlapped": 3 / 4,             # 3 finished behind a forward
}


@pytest.mark.parametrize("name", sorted(EXPECT))
def test_reader(name):
    assert Bench().reader(name)(canned_run()) == pytest.approx(EXPECT[name])


def test_every_benchmark_metric_has_a_case_here():
    b = Bench()
    spec = json.loads(b.root.joinpath("BENCHMARK.json").read_text())
    names = {m["name"] for k in ("end_to_end", "per_layer") for m in spec[k]}
    assert {b.reader_file(n).stem for n in names} == set(EXPECT)


@pytest.mark.parametrize("name", ["path_kernel.device_ms",
                                  "path_kernel.launches", "device.idle_share",
                                  "upscale.device_ms", "upscale.mfu.rdv_a_x4",
                                  "upscale.dense_launches"])
def test_trace_readers_give_nothing_without_a_trace(name):
    run = canned_run()
    run.trace = None
    assert Bench().reader(name)(run) is None


def span_events():
    """A driver call whose program spans `issue` > `launch` and `upscale`
    launch kernels that run after the host has left the span."""
    host, other = {"pid": 1, "tid": 7}, {"pid": 1, "tid": 8}

    def x(cat, name, ts, dur, corr=None, where=host):
        e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
             **where}
        if corr is not None:
            e["args"] = {"correlation": corr}
        return e
    dev = {"pid": 0, "tid": 9}
    return [
        x("user_annotation", tracemod.WINDOW, 1000.0, 20000.0),
        x("user_annotation", tracemod.CALL, 1000.0, 19000.0),
        x("user_annotation", "run", 1100.0, 18000.0),
        x("user_annotation", "issue", 2000.0, 1000.0),
        x("user_annotation", "launch", 2100.0, 400.0),
        x("cuda_runtime", "cudaLaunchKernel", 2200.0, 10.0, 7),
        x("cuda_runtime", "cudaMemcpyAsync", 2700.0, 10.0, 8),
        x("user_annotation", "upscale", 9000.0, 500.0),
        x("cuda_driver", "cuLaunchKernel", 9100.0, 5.0, 9),
        x("cuda_driver", "cuLaunchKernel", 9200.0, 5.0, 10),
        x("cuda_runtime", "cudaLaunchKernel", 15000.0, 5.0, 11),
        # another thread inside `launch`'s time: not the span's
        x("cuda_runtime", "cudaLaunchKernel", 2300.0, 5.0, 12, other),
        # the harness's own spans are not the program's
        x("cuda_runtime", "cudaLaunchKernel", 19500.0, 5.0, 13),
        x("kernel", K, 3000.0, 4000.0, 7, dev),
        x("gpu_memcpy", "Memcpy DtoH", 7000.0, 500.0, 8, dev),
        x("kernel", "conv", 9600.0, 2000.0, 9, dev),
        x("kernel", "lrelu", 11600.0, 1000.0, 10, dev),
        x("kernel", "tonemap", 15100.0, 300.0, 11, dev),
        x("kernel", "other", 15500.0, 200.0, 12, dev),
        x("kernel", "tail", 19600.0, 100.0, 13, dev),
    ]


def test_span_ops_count_kernels_to_the_span_that_launched_them():
    tr = tracemod.reduce(span_events())
    assert set(tr.span_ops) == {"launch", "issue", "upscale", "run"}
    assert tr.span_ops["launch"] == (pytest.approx(0.004), 1)
    assert tr.span_ops["issue"] == (pytest.approx(0.0005), 1)
    assert tr.span_ops["upscale"] == (pytest.approx(0.003), 2)
    assert tr.span_ops["run"] == (pytest.approx(0.0003), 1)
    assert sum(n for _, n in tr.span_ops.values()) == 5
    assert tracemod.reduce(canned_events()).span_ops == {}
