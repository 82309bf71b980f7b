"""Cells, configurations, traffic mixes and metrics are found by name
from files, including ones added in a copy of the benchmark."""

import json

import pytest

from portbench import harness, traffic
from portbench.registry import Bench
from portbench.tests import tinybench


def test_every_cell_resolves_from_files():
    b = Bench()
    names = {c["name"] for c in b.spec["configs"]}
    for w in b.spec["workloads"]:
        assert w["config"] in names
        cfg = b.config(w["config"])
        assert cfg["name"] == w["config"]
        mix = b.traffic(w["traffic"])
        assert len(traffic.pose_lines(b, mix)) >= mix["stop"]
        assert b.data(cfg["texture"]).exists()
        for kind in ("end_to_end", "per_layer"):
            for m in b.metrics(w["name"], kind):
                assert callable(b.reader(m["name"]))


def test_metric_workloads_key_limits_cells():
    b = Bench()
    e2e = {m["name"] for m in b.metrics("rdv_b.close6", "end_to_end")}
    assert e2e == {"s_per_frame.rdv_b", "setup_s"}
    e2e = {m["name"] for m in b.metrics("rdv_a.close6", "end_to_end")}
    assert e2e == {"s_per_frame.rdv_a", "frame_p95_s", "setup_s"}


@pytest.mark.parametrize("cell", ["rdv_b.close6", "rdv_a.close6"])
def test_per_layer_metrics_follow_what_they_move(cell):
    b = Bench()
    e2e = {m["name"] for m in b.metrics(cell, "end_to_end")}
    layer = b.metrics(cell, "per_layer")
    assert {m["moves"] for m in layer} <= e2e
    short = cell.split(".")[0]
    assert {m["name"] for m in layer} == {
        f"{q}.{short}" for q in ("driver.encode_ms", "driver.render_stage_ms",
                                 "path_kernel.device_ms",
                                 "path_kernel.launches", "device.idle_share",
                                 "driver.inputs_ms", "driver.wait_ms",
                                 "render.host_ms", "path_kernel.wrapper_ms")
    } | {"scene.compile_s"}


def test_split_metric_is_read_by_the_quantitys_reader(tmp_path):
    b = Bench()
    assert b.reader_file("s_per_frame.rdv_b").name == "s_per_frame.py"
    assert b.reader_file("path_kernel.launches.rdv_a").name == \
        "path_kernel.launches.py"
    assert b.reader_file("setup_s").name == "setup_s.py"
    root = tinybench.make(tmp_path)
    own = root / "portbench" / "metrics" / "s_per_frame.rdv_a.py"
    own.write_text("def read(run):\n    return 7.0\n")
    assert Bench(root).reader_file("s_per_frame.rdv_a") == own
    assert Bench(root).reader("s_per_frame.rdv_a")(None) == 7.0


def test_added_files_run_as_a_cell(tmp_path):
    root = tinybench.make(tmp_path, width=32, height=18, spp=2, chunk_spp=1)
    (root / "portbench" / "metrics" / "frames.count.py").write_text(
        "def read(run):\n    return float(run.written)\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["per_layer"].append({"name": "frames.count", "unit": "frames",
                              "better": "higher", "source": "host_clock",
                              "layer": "driver", "moves": "s_per_frame.rdv_b",
                              "workloads": [tinybench.TINY]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    b = Bench(root)
    assert tinybench.TINY not in {w["name"] for w in Bench().spec["workloads"]}
    res, run, _ = harness.run_cell(b, tinybench.TINY, 5, 0.5, True,
                                   device="cpu")
    assert res["correct"] is True
    assert res["attempted"] == 3 and res["failed"] == 0
    assert res["metrics"]["frames.count"]["value"] == 3.0
    assert set(res["metrics"]) >= {"driver.encode_ms.rdv_b",
                                   "scene.compile_s"}
    assert list(res)[-1] == "check"
    assert res["device"]["window_s"] > 0


@pytest.mark.parametrize("name", ["nope.cell"])
def test_unknown_cell_raises(name):
    with pytest.raises(KeyError):
        Bench().cell(name)
