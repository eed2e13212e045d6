"""The port's transfer study script (`scripts/torch_transfer_study.py`)
against the JAX package's (`scripts/transfer_study.py`), both loaded
from their files: the same variants, command line and summary table,
a tiny run on the CPU, resume from the JSON, and the evaluation half
(restore, `run_inference`, `eval_det` on the weak val split) from one
bridged checkpoint in both packages."""

import argparse
import ast
import importlib.util
import json
import os

import jax
import numpy as np
import pytest
import torch

from torch_parity import one_torch_thread, to_numpy_tree  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECORD_KEYS = {"variant", "seed", "model", "mAP", "per_class",
               "train_seconds"}


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def scripts():
    return _load("transfer_study"), _load("torch_transfer_study")


class _Parsed(Exception):
    pass


def _jax_args(jstudy, monkeypatch, argv):
    """The namespace JAX's `main` parses from `argv`, stopped there."""
    parse = argparse.ArgumentParser.parse_args

    def stop(self, args=None, namespace=None):
        raise _Parsed(parse(self, args, namespace))

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", stop)
    monkeypatch.setattr("sys.argv", ["transfer_study.py", *argv])
    with pytest.raises(_Parsed) as got:
        jstudy.main()
    monkeypatch.undo()
    return vars(got.value.args[0])


def test_variants_table_equals_jax(scripts):
    """`run_one`'s table of (fit, refine, reproj, size_prior, size_cls,
    trust_gate), read from the JAX script's source."""
    jstudy, _ = scripts
    tree = ast.parse(open(jstudy.__file__).read())
    table = next(ast.literal_eval(node.value) for node in ast.walk(tree)
                 if isinstance(node, ast.Assign)
                 and getattr(node.targets[0], "id", "") == "weights")
    assert table == _load("torch_transfer_study").WEIGHTS


@pytest.mark.parametrize("argv", [[], ["--model", "frustum_pointnets_v2",
                                       "--epochs", "150", "--diag",
                                       "--variants", "transfer,control"]])
def test_command_line_equals_jax(scripts, monkeypatch, argv):
    """JAX's flags and defaults, but `--device` and two outputs: the
    port's JSON is not JAX's `transfer_study.json` (whose runs resume
    would skip as done), and its run directories lie under the
    temporary directory, not a fixed /tmp path."""
    import tempfile

    jstudy, tstudy = scripts
    mine = vars(tstudy.parser().parse_args(argv))
    theirs = _jax_args(jstudy, monkeypatch, argv)
    assert mine.pop("device") is None
    assert (theirs.pop("out_json"), theirs.pop("out_dir")) == (
        "transfer_study.json", "/tmp/transfer_study")
    assert (mine.pop("out_json"), mine.pop("out_dir")) == (
        "torch_transfer_study.json",
        os.path.join(tempfile.gettempdir(), "torch_transfer_study"))
    assert mine == theirs


def test_both_mains_print_one_summary_from_a_finished_json(
        scripts, tmp_path, monkeypatch, capsys):
    """Fed the same finished JSON, neither script trains, and both print
    the same table, the U-test's p included."""
    jstudy, tstudy = scripts
    rng = np.random.RandomState(0)
    variants = ["transfer", "control", "no_fit"]
    results = [{"variant": v, "seed": s, "model": "frustum_pointnets_v2",
                "mAP": float(rng.uniform(0.3, 0.9)),
                "per_class": {"toilet": 0.5}, "train_seconds": 1.0}
               for s in range(4) for v in variants]
    out = tmp_path / "study.json"
    out.write_text(json.dumps(results))
    argv = ["--seeds", "4", "--variants", ",".join(variants), "--out_json",
            str(out)]

    def no_training(*a, **kw):
        raise AssertionError("a finished run was trained again")

    monkeypatch.setattr(jstudy, "run_one", no_training)
    monkeypatch.setattr(tstudy, "run_one", no_training)
    monkeypatch.setattr("sys.argv", ["transfer_study.py", *argv])
    prng = jax.config.jax_default_prng_impl
    try:
        jstudy.main()
    finally:
        jax.config.update("jax_default_prng_impl", prng)
    theirs = capsys.readouterr().out
    tstudy.main(argv)
    mine = capsys.readouterr().out
    assert "U-test p=" in mine and "control" in mine
    assert mine == theirs
    assert json.loads(out.read_text()) == results


def test_run_one_on_the_cpu_and_resume(scripts, tmp_path, monkeypatch):
    """A tiny run (v1, one BoxPC epoch, one phase-B epoch, 8 frustums a
    batch) returns JAX's record; `main` then skips it."""
    _, tstudy = scripts
    out = tmp_path / "study.json"
    argv = ["--model", "frustum_pointnets_v1", "--epochs", "1",
            "--boxpc_epochs", "1", "--train_size", "48", "--val_size", "24",
            "--num_point", "256", "--batch_size", "8", "--seeds", "1",
            "--variants", "transfer", "--out_dir", str(tmp_path / "runs"),
            "--out_json", str(out), "--device", "cpu"]
    tstudy.main(argv)
    (record,) = json.loads(out.read_text())
    assert set(record) == RECORD_KEYS
    assert (record["variant"], record["seed"], record["model"]) == (
        "transfer", 0, "frustum_pointnets_v1")
    assert 0.0 <= record["mAP"] <= 1.0
    assert all(0.0 <= v <= 1.0 for v in record["per_class"].values())
    assert os.path.exists(tmp_path / "runs" / "transfer_s0" / "ckpt")

    def no_training(*a, **kw):
        raise AssertionError("a finished run was trained again")

    monkeypatch.setattr(tstudy, "run_one", no_training)
    tstudy.main(argv)
    assert json.loads(out.read_text()) == [record]


def test_run_one_refuses_to_leave_the_card_by_itself(scripts, monkeypatch):
    """Without `--device` the run is the card's: on a machine without
    one it raises rather than training on the CPU."""
    _, tstudy = scripts
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = tstudy.parser().parse_args(["--out_dir", "/nonexistent"])
    with pytest.raises(RuntimeError, match="cpu"):
        tstudy.run_one("transfer", 0, args)


def test_evaluation_half_equals_jax_from_one_bridged_checkpoint(
        scripts, tmp_path, monkeypatch):
    """Both `run_one`s with training replaced by a checkpoint of one
    detector (JAX's initial state, bridged into the port's): the same
    restore, `run_inference` and `eval_det` on the weak val split give
    the same APs to 1e-6, from detections that agree within a bf16 step
    (an untrained detector's APs are 0 on both sides, so the detections
    that reach `eval_det` are compared too)."""
    jstudy, tstudy = scripts
    from transferable3d_tpu.models import registry as jreg
    from transferable3d_tpu.train import schedules as jsched
    from transferable3d_tpu.train import train_loop as jloop
    from transferable3d_tpu.train import train_semisup as jsemisup
    from transferable3d_tpu.utils import checkpoint as jckpt
    from transferable3d_torch.models import registry as treg
    from transferable3d_torch.train import schedules as tsched
    from transferable3d_torch.train import train_loop as tloop
    from transferable3d_torch.train import train_semisup as tsemisup
    from transferable3d_torch.utils import bridge
    from transferable3d_torch.utils import checkpoint as tckpt

    argv = ["--model", "frustum_pointnets_v1", "--train_size", "32",
            "--val_size", "48", "--num_point", "256", "--batch_size", "8",
            "--variants", "transfer"]
    jargs = argparse.Namespace(**_jax_args(
        jstudy, monkeypatch, argv + ["--out_dir", str(tmp_path / "jax")]))
    targs = tstudy.parser().parse_args(
        argv + ["--out_dir", str(tmp_path / "port"), "--device", "cpu"])
    seed = 3
    tcfg = tstudy.study_config("transfer", seed, targs)
    bins_cfg = tcfg.bin_config()
    _, _, weak_val = tsemisup.build_semisup_datasets(tcfg)
    assert len(weak_val) >= 2 * tcfg.batch_size

    # One detector: JAX's initial state, checkpointed in both packages.
    _, _, jweak_val = jsemisup.build_semisup_datasets(
        jsemisup.SemisupConfig(**{f: getattr(tcfg, f) for f in (
            "model", "num_point", "num_channels", "batch_size",
            "synthetic_train", "synthetic_val", "synthetic_hard", "seed")}))
    sample = jweak_val.get_batch(list(range(tcfg.batch_size)))
    jdet = jreg.get_model(tcfg.model, bins_cfg, dtype=jax.numpy.bfloat16)
    jtx = jloop.make_optimizer(jsched.exponential_staircase_lr(
        batch_size=tcfg.batch_size))
    j0 = jloop.create_train_state(jdet, bins_cfg, jtx, sample, seed=seed)
    log = os.path.join(str(tmp_path / "jax"), f"transfer_s{seed}", "ckpt")
    mgr = jckpt.CheckpointManager(log)
    mgr.save(1, j0)
    mgr.close()
    tdet = treg.get_model(tcfg.model, bins_cfg, dtype=torch.bfloat16,
                          in_channels=4, device="cpu")
    bridge.load_flax_variables(tdet, to_numpy_tree(j0.params),
                               to_numpy_tree(j0.batch_stats))
    tckpt.CheckpointManager(f"{tcfg.log_dir}/ckpt").save(
        1, tloop.create_train_state(tdet, tloop.make_optimizer(
            tsched.exponential_staircase_lr(batch_size=tcfg.batch_size))))

    from transferable3d_tpu.eval import ap as jap
    from transferable3d_torch.eval import ap as tap

    seen = {}
    for key, mod in (("jax", jap), ("port", tap)):
        def recording(dets, gts, _f=mod.eval_det, _key=key, **kw):
            seen[_key] = (dets, gts)
            return _f(dets, gts, **kw)
        monkeypatch.setattr(mod, "eval_det", recording)
    monkeypatch.setattr(jsemisup, "train", lambda cfg: None)
    monkeypatch.setattr(tsemisup, "train", lambda cfg, device=None: None)
    theirs = jstudy.run_one("transfer", seed, jargs)
    mine = tstudy.run_one("transfer", seed, targs)
    # the detections that reach eval_det: one a frustum, in one order
    (jd, jg), (td, tg) = seen["jax"], seen["port"]
    assert len(jd) == len(td) == len(weak_val)
    assert [(d.frame_id, d.classname) for d in jd] == [
        (d.frame_id, d.classname) for d in td]
    assert all(np.array_equal(a.corners, b.corners) for a, b in zip(jg, tg))
    corners = np.stack([d.corners for d in jd])
    gap = np.abs(np.stack([d.corners for d in td]) - corners)
    score = np.array([[a.score, b.score] for a, b in zip(jd, td)])
    print("corners max |diff|", gap.max(), "of", np.abs(corners).max(),
          "scores max |diff|", np.abs(score[:, 0] - score[:, 1]).max())
    # two bf16 forwards: within a bf16 step of the largest coordinate
    # (measured 5.7e-3 of 13.3 m, scores 7.3e-5)
    assert gap.max() <= 2 ** -8 * np.abs(corners).max()
    np.testing.assert_allclose(score[:, 1], score[:, 0], atol=1e-3)
    assert set(mine) == set(theirs) == RECORD_KEYS
    assert sorted(mine["per_class"]) == sorted(theirs["per_class"])
    print("evaluation half, JAX", theirs["mAP"], theirs["per_class"],
          "port", mine["mAP"], mine["per_class"])
    assert mine["mAP"] == pytest.approx(theirs["mAP"], abs=1e-6)
    for k, v in theirs["per_class"].items():
        assert mine["per_class"][k] == pytest.approx(v, abs=1e-6), k
