"""Import hygiene: the port never imports JAX or the JAX package.

The machine with the card has no JAX, so `transferable3d_torch` and every
one of its submodules must import in a fresh interpreter without pulling
in `jax*`, `flax*`, `optax*`, `orbax*` or `transferable3d_tpu*`, and
without building a kernel.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

_PROBE = r"""
import importlib, json, pkgutil, sys
import transferable3d_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
from transferable3d_torch.ops import _build
bad = sorted(m for m in sys.modules if m.split(".")[0] in
             ("jax", "jaxlib", "flax", "optax", "orbax", "transferable3d_tpu"))
print(json.dumps([names, _build._lib is None, bad]))
"""

# The driver's, the evaluation's, the transfer loop's and the tools'
# modules, which the walk must reach.
_DRIVER = ("eval.ap", "eval.kitti_offline", "utils.checkpoint",
           "utils.logging", "utils.prefetch", "train.config",
           "train.train_sup", "train.test", "data.device_dataset",
           "data.pickle_io", "data.kitti", "data.kitti_prep",
           "data.sunrgbd", "data.sunrgbd_prep", "core.box_np",
           "models.boxpc", "train.semisup", "train.train_semisup",
           "utils.profiling", "utils.viz", "utils.tf1_import",
           "ops.grouping", "models.pointnet2")


def test_chip_smoke_imports_no_jax():
    """chip_smoke.py runs on the machine with the card, next to the port
    and nothing else: it names neither JAX nor the JAX package in an
    import."""
    import ast

    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    assert "transferable3d_torch" in names
    assert not names & {"jax", "jaxlib", "flax", "optax", "orbax",
                        "transferable3d_tpu"}, names


_BANNED = {"jax", "jaxlib", "flax", "optax", "orbax", "transferable3d_tpu"}

_SCRIPT_PROBE = r"""
import importlib.util, json, sys
spec = importlib.util.spec_from_file_location("script", sys.argv[1])
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
mod.parser()
print(json.dumps(sorted(m for m in sys.modules if m.split(".")[0] in
                        ("jax", "jaxlib", "flax", "optax", "orbax",
                         "transferable3d_tpu"))))
"""


def test_port_scripts_import_no_jax():
    """The port's scripts run on the machine with the card: none names
    JAX or the JAX package in an import, and the transfer study script
    loads (with its parser built) without pulling either in."""
    import ast

    scripts = sorted((ROOT / "scripts").glob("torch_*.py"))
    assert ROOT / "scripts" / "torch_transfer_study.py" in scripts
    # The one script that runs both packages side by side, on the CPU
    # only (the card's machine has no JAX).
    both = ROOT / "scripts" / "torch_vs_jax_semisup.py"
    assert both in scripts
    for path in scripts:
        if path == both:
            continue
        names = set()
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names.update(a.name.split(".")[0] for a in node.names)
            elif isinstance(node, ast.ImportFrom) and node.module:
                names.add(node.module.split(".")[0])
        assert not names & _BANNED, (path.name, names)
    res = subprocess.run(
        [sys.executable, "-c", _SCRIPT_PROBE,
         str(ROOT / "scripts" / "torch_transfer_study.py")], cwd=ROOT,
        capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert json.loads(res.stdout) == []


def test_port_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    names, not_built, bad = json.loads(res.stdout)
    assert len(names) >= 15, names
    assert {f"transferable3d_torch.{m}" for m in _DRIVER} <= set(names)
    assert not_built, "importing must not build the kernels"
    assert bad == [], bad


def test_transfer_loop_builds_on_the_card_unless_told():
    """BoxPC, its registry entry and the semi-supervised driver resolve
    their device like every entry point: without `device` they need the
    card, and on a machine without one they raise rather than run on the
    CPU."""
    import dataclasses

    import pytest
    import torch

    from transferable3d_torch.core import bins
    from transferable3d_torch.models import registry
    from transferable3d_torch.models.boxpc import BoxPCFitNet
    from transferable3d_torch.train import train_semisup

    assert BoxPCFitNet(bins.SUNRGBD, device="cpu").head.out.weight.device \
        == torch.device("cpu")
    if torch.cuda.is_available():
        return  # construction without device lands on the card
    with pytest.raises(RuntimeError, match='device="cpu"'):
        BoxPCFitNet(bins.SUNRGBD)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        registry.get_model("boxpc_fit", bins.SUNRGBD)
    cfg = dataclasses.replace(train_semisup.SemisupConfig(), log_dir="")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        train_semisup.train(cfg)


def test_every_jax_entry_point_has_a_port_twin():
    """`pyproject.toml` names a `t3d-torch-*` script for each `t3d-*`
    one (`t3d-torch-train-semisup` for `t3d-train-semisup`), each a
    callable `main` of the port's module of the same path."""
    import importlib
    import tomllib

    scripts = tomllib.loads((ROOT / "pyproject.toml").read_text())[
        "project"]["scripts"]
    jax_names = {k for k in scripts if not k.startswith("t3d-torch-")}
    assert "t3d-train-semisup" in jax_names
    for name in sorted(jax_names):
        twin = scripts[name.replace("t3d-", "t3d-torch-", 1)]
        module, func = twin.split(":")
        assert module == scripts[name].split(":")[0].replace(
            "transferable3d_tpu", "transferable3d_torch"), (name, twin)
        assert callable(getattr(importlib.import_module(module), func))
