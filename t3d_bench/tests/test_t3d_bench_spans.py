"""The readers of the program's spans: each gives a positive reading in a
traced tiny run of its cell's mode on the CPU, the phases of a step add
up to no more than the step, `program_idle_pct` splits the idle gaps by
the root spans' host intervals, and against a program without spans
every reader stays silent without raising."""

import dataclasses

import pytest

from conftest import tiny_run
from t3d_bench import bench, cells, trace
from transferable3d_torch.utils import profiling

CELLS = {"train": "v1_train_b512", "serve": "v2_infer_b1024"}
STEP_PHASES = ("forward_ms.train", "loss_ms.train", "backward_ms.train",
               "optimizer_ms.train", "step_metrics_ms.train")


def _span_metrics(cell):
    return [m["name"] for m in bench.metrics_of(bench.load_spec(), cell,
                                                "per_layer")
            if m["source"] == "program_span"]


@pytest.fixture(scope="module")
def traced():
    """{mode: (the traced tiny run's result, the spans it left)}."""
    out = {}
    for mode, cell in CELLS.items():
        run = tiny_run(cell, dtype="float32", trace=True, npoints=128)
        # Long enough for the profiler's schedule and a step after it (a
        # tiny serving call takes some 0.2 s here).
        run = dataclasses.replace(run, seconds=3.0)
        profiling.reset_spans()
        out[mode] = (cells.run_cell(run, "cpu"), profiling.span_ms())
    profiling.reset_spans()
    return out


@pytest.mark.parametrize("mode", sorted(CELLS))
def test_every_span_reader_reads_a_positive_value(traced, mode):
    metrics = traced[mode][0]["metrics"]
    names = _span_metrics(CELLS[mode])
    assert len(names) == {"train": 7, "serve": 5}[mode]
    for name in names:
        assert metrics[name]["value"] > 0, name
    idle = [n for n in names if n.startswith("program_idle_pct.")]
    assert len(idle) == 1 and metrics[idle[0]]["value"] <= 100


def test_the_steps_phases_add_up_within_the_step(traced):
    out, spans = traced["train"]
    count, ms = spans["t3d.train_step"]
    assert count == 2  # tiny_run keeps two steps
    phases = sum(out["metrics"][m]["value"] for m in STEP_PHASES)
    assert 0 < phases <= ms / count


def _stretch():
    E = trace.Event
    return trace.stretch_from_events([
        E(trace.STEP_SPAN, False, 0.0, 100.0),
        E("t3d.draw", False, 0.0, 10.0),
        E("t3d.train_step", False, 10.0, 60.0),
        E("t3d.forward", False, 12.0, 30.0),   # inside its root
        E("aten::to", False, 70.0, 80.0),      # the caller's
        E("k", True, 5.0, 20.0),
        E("k", True, 40.0, 65.0),
    ])


def test_program_idle_pct_splits_the_gaps_by_the_root_spans():
    st = _stretch()
    # Idle 0-5 (draw), 20-40 (train step), 65-100 (caller's 35 us).
    assert trace.idle_gaps(st) == [(0.0, 5.0), (20.0, 40.0), (65.0, 100.0)]
    rd = cells.Readings(True, {}, 8, 1, "cpu", [st], [0], [], [50e-6])
    assert bench.reader("program_idle_pct.train")(rd) == pytest.approx(
        100.0 * 25 / 60)
    # In serving neither span is a root.
    rd.train = False
    assert bench.reader("program_idle_pct.infer")(rd) is None


def test_readers_are_silent_on_a_program_without_spans(monkeypatch):
    st = _stretch()
    st.host = [e for e in st.host if not e.name.startswith("t3d.")]
    monkeypatch.delattr(profiling, "span_ms")
    for cell, train in ((CELLS["train"], True), (CELLS["serve"], False)):
        rd = cells.Readings(train, {}, 8, 1, "cpu", [st], [0], [], [1e-4])
        for name in _span_metrics(cell):
            assert bench.reader(name)(rd) is None, name
        empty = cells.Readings(train, {}, 8, 1, "cpu", [], [0], [], [])
        for name in _span_metrics(cell):
            assert bench.reader(name)(empty) is None, name
