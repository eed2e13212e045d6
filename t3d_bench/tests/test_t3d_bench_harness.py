"""Discovery, the contract's names and units, the result line's keys,
the trace arithmetic, and a run of each mode at a tiny size."""

import json
import re

import pytest

from conftest import tiny_run
from t3d_bench import bench, cells, trace


def test_every_name_in_the_spec_finds_its_file():
    spec = bench.load_spec()
    assert bench.check_spec(spec) == []
    for w in spec["workloads"]:
        assert bench.traffic(w["traffic"])["mode"] in ("train", "serve")
        assert "limits" in bench.cell_file(w["name"])
        assert bench.config(spec, w["config"])["name"] == w["config"]
    for m in spec["per_layer"]:
        assert callable(bench.reader(m["name"]))


def test_discovery_reports_a_missing_file():
    spec = bench.load_spec()
    spec["per_layer"] = spec["per_layer"] + [dict(
        spec["per_layer"][0], name="no_such_metric")]
    spec["workloads"] = spec["workloads"] + [dict(
        spec["workloads"][0], name="no_such_cell", traffic="no_such_mix")]
    errs = bench.check_spec(spec)
    assert any("metrics/no_such_metric.py" in e for e in errs)
    assert any("traffic/no_such_mix.json" in e for e in errs)
    assert any("workloads/no_such_cell.json" in e for e in errs)


@pytest.mark.parametrize("name,ok", [
    ("v2_train_b128", True), ("mfu_pct.train", True), ("_x-1", True),
    ("has space", False), ("a,b", False), ("a/b", False), ("", False),
    ("x" * 65, False), ("µs", False)])
def test_names(name, ok):
    assert bool(bench.NAME.match(name)) is ok


@pytest.mark.parametrize("unit,ok", [
    ("frustums/s", True), ("%", True), ("GiB", True), ("ms", True),
    ("tokens per second", False), ("x" * 17, False), ("µs", False)])
def test_units(unit, ok):
    assert bool(bench.UNIT.match(unit)) is ok


def test_spec_keys_and_limits_of_the_contract():
    spec = bench.load_spec()
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert 1 <= spec["run_seconds"] <= 51
    chips4 = [w for w in spec["workloads"] if w["chips"] == 4]
    assert len(chips4) <= max(1, len(spec["workloads"]) // 4)
    for w in spec["workloads"]:
        assert len(w["why"]) <= 200 and "\n" not in w["why"]
    for m in spec["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in spec["end_to_end"])
    for m in spec["per_layer"]:
        if "roofline" in m["name"]:
            assert m["name"].endswith("_roofline") and m["unit"] == "%"
    assert len(json.dumps(spec)) < 64 * 1024


def test_result_line_keys_and_order():
    line = bench.result_line(
        True, 10, 0, {"setup_s": {"value": 1.5, "unit": "s"}},
        {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
         "memory_peak_bytes": 3}, {"loss_gap": {"value": 0.1, "limit": 1}},
        {"device_ops": [], "idle_gaps": []})
    out = json.loads(line)
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "breakdown", "checks"]
    assert "\n" not in line


def _events():
    E = trace.Event
    return [
        E(trace.STEP_SPAN, False, 0.0, 40.0),
        E(trace.STEP_SPAN, False, 40.0, 80.0),
        E("aten::mm", False, 5.0, 9.0),
        E("aten::add", False, 50.0, 70.0),
        E("k1", True, 10.0, 20.0),
        E("k2", True, 15.0, 30.0),       # overlaps k1: counted once
        E("Memcpy HtoD (Pageable -> Device)", True, 45.0, 50.0),
        E("k1", True, 60.0, 100.0),      # ends after the last span
        E("early", True, -10.0, -5.0),   # before the stretch
    ]


def test_union_idle_and_kernels_per_step():
    st = trace.stretch_from_events(_events())
    assert st.steps == 2 and st.start_us == 0.0 and st.end_us == 100.0
    assert trace.busy_seconds(st) == pytest.approx((20 + 5 + 40) * 1e-6)
    assert trace.idle_gaps(st) == [(0.0, 10.0), (30.0, 45.0), (50.0, 60.0)]
    assert len(st.kernels()) == 3
    # 65 us busy over 2 steps, against 50 us a step without the profiler.
    rd = cells.Readings(True, {}, 8, 1, "cpu", [st], [0], [], [50e-6])
    assert bench.reader("kernels_per_step.train")(rd) == 1.5
    assert bench.reader("device_idle_pct.train")(rd) == pytest.approx(35.0)
    assert bench.reader("kernels_per_step.infer")(rd) == 1.5
    brk = trace.breakdown(st)
    assert brk["device_ops"][0] == ["k1", pytest.approx(50e-6)]
    # The longest gap, 30-45 us, runs no host op: the host is in Python
    # after the last one; the others are named by the op running then.
    assert brk["idle_gaps"][0] == ["after aten::mm", pytest.approx(15e-6)]
    assert {g[0] for g in brk["idle_gaps"][1:]} == {"aten::mm", "aten::add"}


def test_a_dotted_name_falls_back_to_its_shared_reader(tmp_path,
                                                       monkeypatch):
    assert bench.reader_file("mfu_pct.train") == \
        bench.reader_file("mfu_pct.infer") == bench.HERE / "metrics" / \
        "mfu_pct.py"
    # A reader of the metric's own name comes first.
    (tmp_path / "metrics").mkdir()
    for f, v in (("m.py", 1), ("m.train.py", 2)):
        (tmp_path / "metrics" / f).write_text(f"def read(rd):\n    "
                                              f"return {v}\n")
    monkeypatch.setattr(bench, "HERE", tmp_path)
    assert bench.reader("m.train")(None) == 2
    assert bench.reader("m.infer")(None) == 1
    assert bench.reader_file("other.train").name == "other.train.py"


def test_union_seconds_clips():
    assert trace.union_seconds([(0, 10), (5, 20), (30, 40)], 8, 35) == \
        pytest.approx((12 + 5) * 1e-6)


def test_no_stretch_without_spans():
    assert trace.stretch_from_events([trace.Event("k", True, 0, 1)]) is None


def test_train_run_on_the_cpu_reports_the_contract_keys():
    out = cells.run_cell(tiny_run("v1_train_b512", dtype="float32",
                                  trace=True, npoints=128), "cpu")
    assert set(out) >= {"correct", "attempted", "failed", "metrics",
                        "device", "checks"}
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert set(out["checks"]) == set(bench.cell_file(
        "v1_train_b512")["limits"])
    # The per-layer readers that need the card's peaks stay silent here.
    assert "mfu_pct.train" not in out["metrics"]
    assert out["device"]["platform"] == "cpu"


def test_serve_run_on_the_cpu():
    out = cells.run_cell(tiny_run("v2_infer_b1024", dtype="float32"), "cpu")
    assert out["correct"]
    assert set(out["metrics"]) == {"infer_frustums_per_s", "infer_p95_ms",
                                   "setup_s"}
    assert out["metrics"]["infer_p95_ms"]["value"] > 0


def test_seeds_take_any_whole_number():
    a = cells.seeds(2 ** 31 + 5)
    assert a == cells.seeds(2 ** 31 + 5) and a != cells.seeds(2 ** 31 + 6)
    assert cells.seeds(-3) != cells.seeds(3)
    assert all(0 <= v < 2 ** 32 for v in a.values())


def test_run_refuses_without_a_card(tmp_path):
    import subprocess
    import sys

    p = subprocess.run(
        [sys.executable, str(bench.HERE / "run.py"), "--workload",
         "v1_train_b512", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
             "HOME": str(tmp_path)})
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def test_the_card_runs_a_cell(cuda_device):
    out = cells.run_cell(tiny_run("v1_train_b512"), cuda_device)
    assert re.match("NVIDIA", out["device"]["kind"])
