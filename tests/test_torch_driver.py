"""The port's supervised driver on the CPU: train/config.py, Logger,
prefetch, CheckpointManager, train_sup (build_datasets, train, main)
and train/test's evaluate and main, against the JAX package where the
two must agree (configs, files, datasets and host batches: exactly).

The steps themselves are held against JAX by the step tests; here a
restored checkpoint must give the next step bit for bit.
"""

import argparse
import copy
import csv
import dataclasses
import os
import sys
import time

import numpy as np
import pytest
import torch

from transferable3d_tpu.train import config as jconfig
from transferable3d_tpu.utils.logging import Logger as JLogger
from transferable3d_torch.core import bins as tbins
from transferable3d_torch.data import synthetic as tsyn
from transferable3d_torch.data.provider import FrustumDataset
from transferable3d_torch.models import registry
from transferable3d_torch.train import config as tconfig
from transferable3d_torch.train import schedules, train_loop, train_sup
from transferable3d_torch.train import test as ttest
from transferable3d_torch.utils import checkpoint as tckpt
from transferable3d_torch.utils.logging import Logger as TLogger
from transferable3d_torch.utils.prefetch import prefetch

from torch_parity import one_torch_thread  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")
CPU = torch.device("cpu")


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------

def test_train_config_fields_and_presets_equal_jax():
    def fields(mod):
        return [(f.name, f.type, f.default)
                for f in dataclasses.fields(mod.TrainConfig)]

    assert fields(tconfig) == fields(jconfig)
    assert list(tconfig.PRESETS) == list(jconfig.PRESETS)
    for name, preset in tconfig.PRESETS.items():
        assert (dataclasses.asdict(preset)
                == dataclasses.asdict(jconfig.PRESETS[name])), name
        assert preset.model in registry.available(), (name, preset.model)
        got, want = preset.bin_config(), jconfig.PRESETS[name].bin_config()
        assert isinstance(got, tbins.BinConfig)
        assert got.classes == want.classes
        np.testing.assert_array_equal(got.mean_size_array(),
                                      want.mean_size_array())


def _parse(mod, argv):
    p = argparse.ArgumentParser()
    mod.add_cli_args(p)
    return mod.config_from_args(p.parse_args(argv))


_ARGV = ["--batch_size", "8", "--classes", "chair,table", "--device_data",
         "True", "--random_flip", "False", "--learning_rate", "0.002",
         "--model", "frustum_pointnets_v2", "--log_dir", "x/y",
         "--synthetic_train", "2048", "--max_epoch", "120"]


@pytest.mark.parametrize("preset", [None] + sorted(jconfig.PRESETS))
def test_cli_parses_as_jax(preset):
    head = [] if preset is None else ["--preset", preset]
    for argv in (head, head + _ARGV):
        got, want = _parse(tconfig, argv), _parse(jconfig, argv)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), argv
    assert got.classes == ("chair", "table") and got.device_data is True


# ---------------------------------------------------------------------------
# Logger, prefetch
# ---------------------------------------------------------------------------

def test_logger_writes_the_jax_files(tmp_path):
    for lib, d in ((JLogger, tmp_path / "jax"), (TLogger, tmp_path / "port")):
        log = lib(str(d), tensorboard=False)
        log.log_string("epoch 0: step=3 loss=1.2345")
        log.log_metrics(3, {"total_loss": np.float32(1.5), "lr": 1e-3})
        log.log_metrics(6, {"total_loss": 0.5, "lr": 1e-3}, "val")
        log.close()
    for name in ("metrics_train.csv", "metrics_val.csv"):
        assert ((tmp_path / "port" / name).read_bytes()
                == (tmp_path / "jax" / name).read_bytes())
    strip = [line.split("] ", 1)[1] for line in
             (tmp_path / "port" / "log_train.txt").read_text().splitlines()]
    assert strip == ["epoch 0: step=3 loss=1.2345"]
    rows = list(csv.DictReader(open(tmp_path / "port" / "metrics_train.csv")))
    assert rows == [{"step": "3", "lr": "0.001", "total_loss": "1.5"}]


def test_prefetch_yields_all_batches_in_order():
    batches = [{"x": np.full((2,), i)} for i in range(10)]
    out = list(prefetch(iter(batches), device_put=lambda b: b))
    assert [int(b["x"][0]) for b in out] == list(range(10))


def test_prefetch_overlaps_producer_with_consumer():
    def slow_gen():
        for i in range(5):
            time.sleep(0.05)
            yield i

    it = prefetch(slow_gen(), buffer_size=4, device_put=lambda b: b)
    time.sleep(0.3)  # the producer fills the buffer while we "compute"
    t0 = time.time()
    out = list(it)
    assert out == [0, 1, 2, 3, 4]
    assert time.time() - t0 < 0.2  # buffered items drain fast


def test_prefetch_propagates_producer_errors():
    def bad_gen():
        yield 1
        raise ValueError("boom")

    it = prefetch(bad_gen(), device_put=lambda b: b)
    assert next(it) == 1
    with pytest.raises(ValueError, match="boom"):
        list(it)


def test_prefetch_device_put_applied():
    batch = {"points": np.ones((2, 3), np.float32),
             "seg": np.zeros(2, np.int64)}
    out = list(prefetch([batch, [np.ones(4)]], buffer_size=1, device=CPU))
    assert isinstance(out[0]["points"], torch.Tensor)
    assert out[0]["points"].dtype == torch.float32
    assert out[0]["seg"].dtype == torch.int64
    assert isinstance(out[1][0], torch.Tensor)


# ---------------------------------------------------------------------------
# CheckpointManager
# ---------------------------------------------------------------------------

CFG = tbins.SUNRGBD


def _batches(n, seed=0):
    recs = tsyn.make_dataset(8, CFG, seed=seed, n_object=60, n_clutter=40)
    ds = FrustumDataset(recs, CFG, npoints=64, random_flip=True,
                        random_shift=True, seed=seed)
    return [ds.get_batch([(2 * i + j) % 8 for j in range(4)])
            for i in range(n)]


def _state(seed, accum):
    model = registry.get_model("frustum_pointnets_v1", CFG, device=CPU,
                               num_object_point=32,
                               generator=torch.Generator().manual_seed(seed))
    lr = schedules.exponential_staircase_lr(batch_size=4)
    return train_loop.create_train_state(
        model, train_loop.make_optimizer(lr, grad_accum_steps=accum),
        seed=seed)


def _step_fn():
    return train_loop.make_train_step(
        CFG, schedules.exponential_staircase_lr(batch_size=4),
        schedules.bn_momentum_schedule(batch_size=4))


def _snapshot(state, metrics):
    return ({k: float(v) for k, v in metrics.items()},
            {k: v.clone() for k, v in state.model.state_dict().items()},
            [None if p.grad is None else p.grad.clone()
             for p in state.model.parameters()],
            None if state.optimizer.acc is None
            else [a.clone() for a in state.optimizer.acc])


def _assert_same(a, b):
    assert a[0] == b[0]
    for k in a[1]:
        assert torch.equal(a[1][k], b[1][k]), k
    for x, y in zip(a[2], b[2]):
        assert (x is None) == (y is None) and (x is None or torch.equal(x, y))
    assert (a[3] is None) == (b[3] is None)
    for x, y in zip(a[3] or [], b[3] or []):
        assert torch.equal(x, y)


@pytest.mark.parametrize("accum,k", [(1, 2), (2, 3)])
def test_checkpoint_restore_gives_the_next_steps_bit_for_bit(tmp_path, accum,
                                                             k):
    """Save at step k (with accumulation, k = 3 lies mid-cycle), restore
    into a model drawn from another seed, and take steps k+1 and k+2:
    the loss, the metrics, every parameter and BN statistic, the
    gradients and the accumulator equal the run that never saved. The
    seg net's dropout draws from the restored generator."""
    batches = _batches(k + 2)
    step = _step_fn()
    state = _state(0, accum)
    for b in batches[:k]:
        state, _ = step(state, b)
    mgr = tckpt.CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(state.step, state)
    assert mgr.latest_step() == k
    if accum > 1:
        assert state.optimizer.mini_step == 1
    want = []
    for b in batches[k:]:
        state, m = step(state, b)
        want.append(_snapshot(state, m))

    fresh = _state(5, accum)
    restored = tckpt.CheckpointManager(str(tmp_path / "ckpt")).restore_latest(
        fresh)
    assert restored is fresh and fresh.step == k
    assert fresh.optimizer.count == k // accum
    assert fresh.optimizer.mini_step == k % accum
    for b, w in zip(batches[k:], want):
        fresh, m = step(fresh, b)
        _assert_same(_snapshot(fresh, m), w)
    assert fresh.step == state.step == k + 2


def test_checkpoint_prunes_and_survives_an_interrupted_save(tmp_path,
                                                            monkeypatch):
    state = _state(0, 1)
    mgr = tckpt.CheckpointManager(str(tmp_path), max_to_keep=2)
    assert mgr.latest_step() is None and mgr.restore_latest(state) is None
    for s in (1, 2, 3):
        state.step = s
        mgr.save(s, state)
    assert mgr.steps() == [2, 3]
    before = copy.deepcopy(state.model.state_dict())

    def cut(*a):
        raise KeyboardInterrupt("preempted before the rename")

    with torch.no_grad():
        for p in state.model.parameters():
            p.add_(1.0)
    state.step = 4
    monkeypatch.setattr(tckpt.os, "replace", cut)
    with pytest.raises(KeyboardInterrupt):
        mgr.save(4, state)
    monkeypatch.undo()
    assert mgr.latest_step() == 3
    fresh = _state(7, 1)
    tckpt.CheckpointManager(str(tmp_path)).restore_latest(fresh)
    assert fresh.step == 3
    for key, v in fresh.model.state_dict().items():
        assert torch.equal(v, before[key]), key


# ---------------------------------------------------------------------------
# train_sup, test
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("data_path", [False, True])
def test_build_datasets_and_first_epoch_equal_jax(tmp_path, data_path):
    from transferable3d_tpu.data import synthetic as jsyn
    from transferable3d_tpu.train import train_sup as jtrain_sup
    from transferable3d_torch.data import pickle_io

    kw = dict(model="frustum_pointnets_v1", num_point=64, num_channels=6,
              synthetic_train=12, synthetic_val=6, seed=3)
    if data_path:
        bins_cfg, keep = jconfig.TrainConfig().bin_config(), set()
        for split, n in (("train", 12), ("val", 9)):
            recs = jsyn.make_dataset(n, bins_cfg, seed=n, extra_channels=3,
                                     n_object=60, n_clutter=40)
            keep |= {bins_cfg.classes[r.class_idx] for r in recs[:4]}
            pickle_io.save_records(recs, str(tmp_path / f"{split}.pkl"))
        kw.update(data_path=str(tmp_path), classes=tuple(sorted(keep)))
    jtr, jva = jtrain_sup.build_datasets(jconfig.TrainConfig(**kw))
    ttr, tva = train_sup.build_datasets(tconfig.TrainConfig(**kw))
    for j, t in ((jtr, ttr), (jva, tva)):
        assert len(j) == len(t) > 0
        for a, b in zip(j.records, t.records):
            for f in ("points", "seg", "center", "size", "heading", "box2d"):
                np.testing.assert_array_equal(getattr(b, f), getattr(a, f))
            assert (a.class_idx, a.frustum_angle, a.frame_id) == (
                b.class_idx, b.frustum_angle, b.frame_id)
    for shuffle, j, t in ((True, jtr, ttr), (False, jva, tva)):
        jb = list(j.epoch_batches(4, shuffle=shuffle))
        tb = list(t.epoch_batches(4, shuffle=shuffle))
        assert len(jb) == len(tb) > 0
        for a, b in zip(jb, tb):
            assert sorted(a) == sorted(b)
            for key in a:
                np.testing.assert_array_equal(b[key], a[key], err_msg=key)


def _tiny(tmp_path, model, **kw):
    return tconfig.TrainConfig(
        model=model, dataset="sunrgbd", num_point=64, num_channels=4,
        batch_size=8, max_epoch=2, max_steps=3, synthetic_train=16,
        synthetic_val=16, log_dir=str(tmp_path / "log"),
        eval_every_epochs=1, ckpt_every_epochs=1, **kw)


@pytest.mark.parametrize("model", ["box_estimation_v1",
                                   "frustum_pointnets_v1"])
def test_train_resume_and_evaluate(tmp_path, model):
    """3 steps, resume to 5 (as tests/test_cli_and_ckpt.py), then
    evaluate: the files written, 16 detections read back, the AP finite
    and equal to eval_det on the file read back."""
    cfg = _tiny(tmp_path, model)
    out = train_sup.train(cfg, device=CPU)
    assert np.isfinite(out["total_loss"])
    mgr = tckpt.CheckpointManager(f"{cfg.log_dir}/ckpt")
    assert mgr.latest_step() == 3
    out2 = train_sup.train(dataclasses.replace(cfg, max_steps=5), device=CPU)
    assert mgr.latest_step() == 5 and np.isfinite(out2["total_loss"])
    log = (tmp_path / "log" / "log_train.txt").read_text()
    assert "resumed from step 3" in log and "frustums/s" in log
    assert (tmp_path / "log" / "metrics_train.csv").exists()
    assert (tmp_path / "log" / "metrics_val.csv").exists()

    result_dir = str(tmp_path / "result")
    aps = ttest.evaluate(cfg, result_dir, device=CPU)
    assert "mAP" in aps and np.isfinite(aps["mAP"])
    dets = ttest.read_sunrgbd_results(f"{result_dir}/detections.txt")
    assert len(dets) == 16
    assert all(np.isfinite(d.center).all() for d in dets)
    _, val_ds = train_sup.build_datasets(cfg)
    from transferable3d_torch.eval import ap as tap
    assert tap.eval_det(ttest.detections_to_eval_boxes(dets),
                        ttest.groundtruth_boxes(val_ds, cfg.bin_config())
                        ) == pytest.approx(aps, abs=1e-3)
    assert "restored step 5" in open(f"{result_dir}/log_test.txt").read()


def test_train_on_device_data_and_grad_accum(tmp_path):
    cfg = _tiny(tmp_path, "frustum_pointnets_v1", device_data=True,
                max_points_device=256, grad_accum_steps=2)
    out = train_sup.train(cfg, device=CPU)
    assert np.isfinite(out["total_loss"])
    assert tckpt.CheckpointManager(f"{cfg.log_dir}/ckpt").latest_step() == 3
    assert "device-resident dataset: 16 records" in (
        tmp_path / "log" / "log_train.txt").read_text()


def test_entry_points_refuse_what_is_not_ported(tmp_path, monkeypatch):
    """Both drivers refuse data parallelism that cannot run (ranks that
    do not divide the batch, `multihost` without a launcher's
    environment); `evaluate`
    without a detector checkpoint, or with `--boxpc_refine` on a
    directory without a BoxPC checkpoint, raises FileNotFoundError; and
    an entry point called without `device` on a machine without a GPU
    raises instead of running on the CPU."""
    from transferable3d_torch.train import train_semisup

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    cfg = _tiny(tmp_path, "box_estimation_v1")
    semi = train_semisup.SemisupConfig(**dataclasses.asdict(cfg))
    for bad, why in ((dict(num_devices=3), "not divisible by 3 ranks"),
                     (dict(multihost=True), "launcher")):
        with pytest.raises(ValueError, match=why):
            train_sup.train(dataclasses.replace(cfg, **bad), device=CPU)
        with pytest.raises(ValueError, match=why):
            train_semisup.train(dataclasses.replace(semi, **bad), device=CPU)
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        ttest.evaluate(cfg, str(tmp_path / "r"), device=CPU)
    model = train_sup.build_model(cfg, 4, CPU)
    tckpt.CheckpointManager(f"{cfg.log_dir}/ckpt").save(
        0, train_loop.create_train_state(model, train_loop.make_optimizer(
            schedules.exponential_staircase_lr())))
    with pytest.raises(FileNotFoundError, match="no BoxPC checkpoint"):
        ttest.evaluate(cfg, str(tmp_path / "r"),
                       boxpc_dir=str(tmp_path / "none"), device=CPU)
    monkeypatch.setattr(ttest, "resolve_device", lambda d=None: CPU)
    monkeypatch.setattr(sys, "argv", [
        "test", "--model", "box_estimation_v1", "--num_point", "64",
        "--batch_size", "8", "--synthetic_val", "16", "--log_dir",
        cfg.log_dir, "--result_dir", str(tmp_path / "r"), "--boxpc_refine",
        str(tmp_path / "none")])
    with pytest.raises(FileNotFoundError, match="no BoxPC checkpoint"):
        ttest.main()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='device="cpu"'):
            train_sup.train(cfg)
        with pytest.raises(RuntimeError, match='device="cpu"'):
            train_semisup.train(semi)


def test_main_through_argv(tmp_path, monkeypatch):
    """`python -m ...train_sup` and `...test` with the JAX command line;
    the device resolves to the CPU here."""
    monkeypatch.setattr(train_sup, "resolve_device", lambda d=None: CPU)
    monkeypatch.setattr(ttest, "resolve_device", lambda d=None: CPU)
    log_dir, result_dir = tmp_path / "log", tmp_path / "result"
    common = ["--preset", "config1_boxonly_chair", "--num_point", "64",
              "--batch_size", "8", "--synthetic_train", "16",
              "--synthetic_val", "8", "--log_dir", str(log_dir)]
    monkeypatch.setattr(sys, "argv", ["train_sup"] + common + [
        "--max_steps", "2", "--eval_every_epochs", "1"])
    train_sup.main()
    assert tckpt.CheckpointManager(str(log_dir / "ckpt")).latest_step() == 2
    assert "'model': 'box_estimation_v1'" in (
        log_dir / "log_train.txt").read_text()
    monkeypatch.setattr(sys, "argv", ["test"] + common + [
        "--result_dir", str(result_dir), "--iou_thresh", "0.5"])
    ttest.main()
    dets = ttest.read_sunrgbd_results(str(result_dir / "detections.txt"))
    assert len(dets) == 8 and {d.classname for d in dets} == {"chair"}
    assert "AP@0.50 chair" in (result_dir / "log_test.txt").read_text()


def test_sigterm_checkpoints_and_stops(tmp_path, monkeypatch):
    """A SIGTERM during step 2 (of an unlimited run) ends the run with a
    checkpoint at step 2; the handler is put back afterwards."""
    import signal

    before = signal.getsignal(signal.SIGTERM)
    make = train_loop.make_train_step

    def make_signalling(*a, **kw):
        step = make(*a, **kw)

        def wrapped(state, batch):
            state, metrics = step(state, batch)
            if state.step == 2:
                handler = signal.getsignal(signal.SIGTERM)
                assert callable(handler) and handler is not before
                os.kill(os.getpid(), signal.SIGTERM)
            return state, metrics
        return wrapped

    monkeypatch.setattr(train_sup.train_loop, "make_train_step",
                        make_signalling)
    cfg = dataclasses.replace(_tiny(tmp_path, "box_estimation_v1"),
                              max_steps=0, max_epoch=50,
                              synthetic_train=64)
    train_sup.train(cfg, device=CPU)
    assert tckpt.CheckpointManager(f"{cfg.log_dir}/ckpt").steps() == [2]
    assert "signal 15: checkpointing and stopping" in (
        tmp_path / "log" / "log_train.txt").read_text()
    assert signal.getsignal(signal.SIGTERM) is before


def test_driver_runs_as_jax_driver_from_a_bridged_start(tmp_path):
    """The port's `train` against JAX's `train_sup.train` (the host
    provider, f32, box_estimation_v1: no dropout) from one initial state:
    JAX's step-0 state, bridged into a port checkpoint at step 0, which
    the port's `train` resumes. One batch an epoch, 4 epochs, an eval pass
    and a checkpoint each: `metrics_{train,val}.csv` have the same columns
    and steps, the LR and BN-momentum columns equal. Step 1's train row
    (the initial weights) agrees to rtol 1e-5 (measured 2.2e-6); after
    Adam's first update, lr * sign(g), which flips with the sign of
    gradient entries that are rounding noise, the later train rows to
    5e-3 (measured 8.5e-4) and the val rows to 3e-2 (measured 1.4e-2, on
    `iou3d_mean`, the untrained boxes' overlap of 0.14), as the f32 step
    tests hold steps taken back to back."""
    from transferable3d_tpu.models import registry as jreg
    from transferable3d_tpu.train import schedules as jsched
    from transferable3d_tpu.train import train_loop as jloop
    from transferable3d_tpu.train import train_sup as jtrain_sup
    from transferable3d_torch.utils import bridge

    from torch_parity import to_numpy_tree

    kw = dict(model="box_estimation_v1", num_point=64, num_channels=4,
              batch_size=8, max_epoch=4, max_steps=4, synthetic_train=8,
              synthetic_val=16, eval_every_epochs=1, ckpt_every_epochs=1,
              num_devices=1, seed=2)
    jcfg = jconfig.TrainConfig(**kw, log_dir=str(tmp_path / "jax"))
    tcfg = tconfig.TrainConfig(**kw, log_dir=str(tmp_path / "port"))

    # JAX's step-0 state, as its `train` builds it.
    bins_cfg = jcfg.bin_config()
    jtr, _ = jtrain_sup.build_datasets(jcfg)
    jmodel = jreg.get_model(jcfg.model, bins_cfg)
    tx = jloop.make_optimizer(jsched.exponential_staircase_lr(
        jcfg.learning_rate, jcfg.lr_decay_rate, jcfg.lr_decay_samples,
        jcfg.batch_size, jcfg.min_lr))
    j0 = jloop.create_train_state(jmodel, bins_cfg, tx,
                                  jtr.get_batch(list(range(8))),
                                  seed=jcfg.seed)
    model = train_sup.build_model(tcfg, 4, CPU)
    bridge.load_flax_variables(model, to_numpy_tree(j0.params),
                               to_numpy_tree(j0.batch_stats))
    tckpt.CheckpointManager(f"{tcfg.log_dir}/ckpt").save(
        0, train_loop.create_train_state(model, train_loop.make_optimizer(
            schedules.exponential_staircase_lr(batch_size=8)),
            seed=tcfg.seed))

    jout = jtrain_sup.train(jcfg)
    tout = train_sup.train(tcfg, device=CPU)
    assert "resumed from step 0" in (tmp_path / "port" /
                                     "log_train.txt").read_text()
    assert tckpt.CheckpointManager(f"{tcfg.log_dir}/ckpt").steps() == [
        0, 1, 2, 3, 4]
    worst = {}
    for name in ("metrics_train.csv", "metrics_val.csv"):
        jrows = list(csv.DictReader(open(tmp_path / "jax" / name)))
        trows = list(csv.DictReader(open(tmp_path / "port" / name)))
        assert [r["step"] for r in jrows] == [r["step"] for r in trows] == [
            "1", "2", "3", "4"]
        assert list(jrows[0]) == list(trows[0])
        for jr, tr in zip(jrows, trows):
            for k in jr:
                a, b = float(jr[k]), float(tr[k])
                exact = k in ("step", "lr", "bn_momentum")
                first = name == "metrics_train.csv" and jr["step"] == "1"
                rtol = 0 if exact else (
                    1e-5 if first else 5e-3 if name == "metrics_train.csv"
                    else 3e-2)
                gap = abs(b - a) / max(abs(a), 1e-6)
                worst[(name, first)] = max(worst.get((name, first), (0, "")),
                                           (gap, k))
                assert abs(b - a) <= rtol * abs(a) + (0 if exact else 1e-6), (
                    name, jr["step"], k, a, b)
    print("driver vs driver, largest relative gaps:", worst)
    assert sorted(tout) == sorted(jout)
