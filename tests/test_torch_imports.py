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

# The driver's and the evaluation's modules, which the walk must reach.
_DRIVER = ("eval.ap", "eval.kitti_offline", "utils.checkpoint",
           "utils.logging", "utils.prefetch", "train.config",
           "train.train_sup", "train.test", "data.device_dataset",
           "data.pickle_io", "data.kitti", "data.kitti_prep",
           "data.sunrgbd", "data.sunrgbd_prep", "core.box_np")


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
