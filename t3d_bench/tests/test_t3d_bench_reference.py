"""The frozen reference against the port's steps at tiny sizes on the
CPU, what the reference and a run load, and the control and the planted
faults coming out as not correct."""

import json
import subprocess
import sys

import pytest

from conftest import ROOT, tiny_run
from t3d_bench import cells, judge

FORBIDDEN = {"jax", "jaxlib", "flax", "transferable3d_tpu"}


def _checks(out):
    return out["numbers"]


def test_reference_follows_the_v1_step_in_float32():
    # The port's f32 step on the CPU is the reference's arithmetic in
    # another order: the first loss agrees to f32 rounding, each leaf's
    # first gradient to 1e-3 of its norm (the T-Net's cancelling sums).
    c = _checks(cells.run_cell(tiny_run("v1_train_b512", dtype="float32",
                                        batch=8), "cpu"))
    assert c["loss_gap"] < 1e-5
    assert c["grad_gap"] < 1e-3
    assert c["seg_gap"] < 1e-4


def test_reference_follows_the_v2_step_in_float32():
    # On the CPU the port's f32 ball query takes the expanded-form
    # distance, the card's kernels and the reference the direct form: a
    # point at a radius may change balls, which moves a few points' seg
    # logits by a tenth; the loss is held close.
    c = _checks(cells.run_cell(tiny_run(
        "v1_train_b512", config="fpn_v2_sunrgbd", traffic="train_b128",
        dtype="float32"), "cpu"))
    assert c["loss_gap"] < 1e-4
    assert c["seg_gap"] < 0.5


def test_reference_follows_the_v2_predict_step_in_float32():
    c = _checks(cells.run_cell(tiny_run("v2_infer_b1024", dtype="float32"),
                               "cpu"))
    assert c["box_gap"] < 1e-3
    assert c["heading_gap"] < 1e-4
    assert c["heading_choice_gap"] == 0.0


def _top_level_modules(code):
    out = subprocess.run(
        [sys.executable, "-c", f"import sys; sys.path.insert(0, {str(ROOT)!r})"
         f"\n{code}\nprint(__import__('json').dumps(sorted("
         "{m.split('.')[0] for m in sys.modules})))"],
        capture_output=True, text=True, timeout=600, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_reference_loads_nothing_of_the_program():
    mods = _top_level_modules(
        "import t3d_bench.reference.fpointnet, t3d_bench.traffic.frustums,"
        " t3d_bench.work.counts, t3d_bench.judge")
    assert not mods & (FORBIDDEN | {"transferable3d_torch"})


def test_a_run_loads_no_jax():
    mods = _top_level_modules(
        "sys.path.insert(0, str(__import__('pathlib').Path("
        f"{str(ROOT)!r}) / 't3d_bench' / 'tests'))\n"
        "from conftest import tiny_run\nfrom t3d_bench import cells\n"
        "cells.run_cell(tiny_run('v2_infer_b1024', dtype='float32'), 'cpu')")
    assert "transferable3d_torch" in mods
    assert not mods & FORBIDDEN


@pytest.mark.parametrize("cell", ["v1_train_b512", "v2_infer_b1024"])
def test_the_control_is_not_correct(cell):
    run = tiny_run(cell, judged="control")
    numbers = cells.run_cell(run, "cpu")["checks"]
    assert not judge.within(numbers, run.knobs["limits"]), numbers


@pytest.mark.parametrize("cell,fault", [
    ("v1_train_b512", "unchanged"), ("v1_train_b512", "half_batch"),
    ("v2_infer_b1024", "answer_altered"), ("v2_infer_b1024", "wrong_bin")])
def test_a_planted_fault_is_not_correct(cell, fault):
    sound = cells.run_cell(tiny_run(cell, dtype="float32", batch=8), "cpu")
    assert sound["correct"], sound["checks"]
    broken = cells.run_cell(tiny_run(cell, dtype="float32", batch=8,
                                     faults=(fault,)), "cpu")
    assert not broken["correct"], broken["checks"]


def test_the_exchange_left_out_is_not_correct():
    import dataclasses

    # Two ranks on the CPU over gloo, each drawing the global batch of the
    # data-parallel mix and training on its rows.
    run = dataclasses.replace(tiny_run("v1_train_b512", traffic="train_b1024",
                                       dtype="float32", batch=8), chips=2)
    assert cells.run_cell(run, "cpu")["correct"]
    broken = dataclasses.replace(run, faults=("no_exchange",))
    assert not cells.run_cell(broken, "cpu")["correct"]
