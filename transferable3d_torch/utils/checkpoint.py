"""Checkpointing of the full train state + auto-resume.

Port of `transferable3d_tpu/utils/checkpoint.py` (orbax there) over
`torch.save` / `torch.load`, with the same interface and policy: one
directory a step under the manager's directory (`<log_dir>/ckpt/<step>`),
the newest `max_to_keep` kept, `restore_latest(template)` filling a
template state, `latest_step()`, `wait()` and `close()`.

A checkpoint holds what the JAX `TrainState` holds: the step, the
model's parameters and BN running statistics (`state_dict()`), the
`Optimizer` (Adam's moments and step counts, `count`, `mini_step` and
the accumulated gradient `acc`) and, as the counterpart of
`TrainState.rng`, the dropout generator's state. A step is written
under a temporary name and renamed into place, so a save that is cut
short leaves the previous checkpoint whole. Saves are synchronous, so
`wait()` has nothing to wait for.

Under data parallelism (a current `parallel.mesh.Mesh`) the state is
the same on every rank: rank 0 writes, every rank restores, and
a barrier on either side of a save and a restore keeps a rank from
reading a step before it is whole or from running ahead of a write.
"""

from __future__ import annotations

import os
import shutil
from typing import Optional

import torch

from transferable3d_torch.parallel import mesh as mesh_lib
from transferable3d_torch.train.train_loop import TrainState

_FILE = "state.pt"
_TMP = ".tmp-"


def _to_cpu(x):
    return None if x is None else [t.detach().cpu() for t in x]


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 5):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        if mesh_lib.rank() == 0:
            os.makedirs(self.directory, exist_ok=True)
        mesh_lib.barrier()

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, str(step))

    def steps(self) -> list:
        """Steps with a complete checkpoint, ascending."""
        return sorted(int(d) for d in os.listdir(self.directory)
                      if d.isdigit() and os.path.exists(
                          os.path.join(self.directory, d, _FILE)))

    def save(self, step: int, state: TrainState) -> None:
        """Write `state` as step `step` (on rank 0 of a mesh; every rank
        returns once it is whole)."""
        mesh_lib.barrier()
        if mesh_lib.rank() == 0:
            self._write(step, state)
        mesh_lib.barrier()

    def _write(self, step: int, state: TrainState) -> None:
        opt = state.optimizer
        payload = {
            "step": int(state.step),
            "model": {k: v.detach().cpu()
                      for k, v in state.model.state_dict().items()},
            "adam": opt.adam.state_dict(),
            "count": opt.count,
            "mini_step": opt.mini_step,
            "acc": _to_cpu(opt.acc),
            "generator": state.generator.get_state(),
        }
        tmp = os.path.join(self.directory, f"{_TMP}{step}-{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(payload, os.path.join(tmp, _FILE))
        final = self._path(step)
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)
        for old in self.steps()[:-self.max_to_keep]:
            shutil.rmtree(self._path(old), ignore_errors=True)

    def restore_latest(self, template: TrainState
                       ) -> Optional[TrainState]:
        """Restore the newest checkpoint into `template` (in place: its
        model, optimizer and generator keep their devices) and return it;
        None when there is no checkpoint."""
        mesh_lib.barrier()
        step = self.latest_step()
        if step is None:
            return None
        payload = torch.load(os.path.join(self._path(step), _FILE),
                             map_location="cpu", weights_only=True)
        template.model.load_state_dict(payload["model"])
        opt = template.optimizer
        opt.adam.load_state_dict(payload["adam"])
        opt.count = payload["count"]
        opt.mini_step = payload["mini_step"]
        opt.acc = (None if payload["acc"] is None else
                   [a.to(p.device) for a, p in zip(payload["acc"],
                                                   opt.params)])
        template.generator.set_state(payload["generator"])
        template.step = payload["step"]
        mesh_lib.barrier()
        return template

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def wait(self) -> None:
        """Saves complete before `save` returns."""

    def close(self) -> None:
        """Nothing is held open between calls."""
