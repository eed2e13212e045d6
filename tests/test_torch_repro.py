"""The port's training is a function of its seed: the supervised driver
and the transfer loop, each run in two processes with different
`PYTHONHASHSEED`s, write bit-identical checkpoints and the same metrics.
This covers the host's side of a run: the host provider and its
prefetch thread, the device-resident draws, `fork_generator`, the order
of every dict and set the driver walks. The card's side (K9 without
floating-point atomics) is chip_smoke phase 27's."""

import csv
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

RUN = """
import sys
import torch
sys.path.insert(0, {root!r})
from transferable3d_torch.train import config, train_sup, train_semisup
torch.set_num_threads(1)
kind, log_dir = sys.argv[1], sys.argv[2]
kw = dict(model="frustum_pointnets_v1", num_point=256, num_channels=4,
          batch_size=4, seed=5, log_dir=log_dir, eval_every_epochs=1,
          ckpt_every_epochs=1, max_points_device=512,
          device_data=kind.endswith("device"))
if kind.startswith("sup"):
    train_sup.train(config.TrainConfig(
        max_epoch=2, max_steps=4, synthetic_train=8, synthetic_val=8, **kw),
        device="cpu")
else:
    train_semisup.train(train_semisup.SemisupConfig(
        max_epoch=2, max_steps=3, synthetic_train=40, synthetic_val=24,
        boxpc_epochs=1, weak_warmup_steps=2, per_class_diag=True, **kw),
        device="cpu")
"""


def _run(kind, log_dir, hashseed):
    env = dict(os.environ, PYTHONHASHSEED=str(hashseed))
    subprocess.run([sys.executable, "-c", RUN.format(root=ROOT), kind,
                    str(log_dir)], env=env, check=True, timeout=300,
                   capture_output=True)


def _checkpoints(log_dir):
    out = {}
    for sub in ("ckpt", "boxpc_ckpt"):
        base = os.path.join(log_dir, sub)
        for step in sorted(os.listdir(base)) if os.path.isdir(base) else ():
            out[(sub, step)] = torch.load(
                os.path.join(base, step, "state.pt"), weights_only=True)
    return out


def _same(a, b, path=""):
    """Every tensor bit-identical, every other leaf equal."""
    if isinstance(a, dict):
        assert sorted(a, key=str) == sorted(b, key=str), path
        for k in a:
            _same(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}/{i}")
    elif torch.is_tensor(a):
        assert torch.equal(a, b), path
    else:
        assert a == b, path


def _metrics(log_dir):
    """Every metrics CSV, without its wall-clock columns."""
    out = {}
    for name in sorted(os.listdir(log_dir)):
        if name.startswith("metrics_") and name.endswith(".csv"):
            with open(os.path.join(log_dir, name)) as f:
                out[name] = [{k: v for k, v in r.items() if "time" not in k}
                             for r in csv.DictReader(f)]
    return out


@pytest.mark.parametrize("kind", ["sup_host", "sup_device", "semisup_host",
                                  "semisup_device"])
def test_two_processes_from_one_seed_write_the_same_checkpoints(tmp_path,
                                                                kind):
    _run(kind, tmp_path / "a", 1)
    _run(kind, tmp_path / "b", 2)
    ca, cb = _checkpoints(tmp_path / "a"), _checkpoints(tmp_path / "b")
    want = {"ckpt"} | ({"boxpc_ckpt"} if kind.startswith("semisup")
                       else set())
    assert {sub for sub, _ in ca} == want
    assert sorted(ca) == sorted(cb)
    _same(ca, cb)
    ma, mb = _metrics(tmp_path / "a"), _metrics(tmp_path / "b")
    assert ma and ma == mb
