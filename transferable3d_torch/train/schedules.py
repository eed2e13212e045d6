"""LR and BatchNorm-momentum staircases, counted in samples.

Port of `transferable3d_tpu/train/schedules.py`:

  lr(step)  = max(lr_min, base * decay_rate ** floor(samples / decay_step))
  bnm(step) = min(0.99, 1 - 0.5 * 0.5 ** floor(samples / bn_decay_step))

with samples = step * batch_size. The schedules are evaluated on the
host (the step counter of the port's `TrainState` is a Python int) in
float32 arithmetic, as the jnp versions compute them, and return floats.
"""

from __future__ import annotations

from typing import Callable

import numpy as np


def _stairs(step, batch_size: int, decay_samples: float) -> np.float32:
    samples = np.float32(step) * np.float32(batch_size)
    return np.floor(samples / np.float32(decay_samples))


def exponential_staircase_lr(base_lr: float = 1e-3, decay_rate: float = 0.7,
                             decay_samples: float = 200000.0,
                             batch_size: int = 32, min_lr: float = 1e-5
                             ) -> Callable[[int], float]:
    def schedule(step) -> float:
        stairs = _stairs(step, batch_size, decay_samples)
        lr = np.float32(base_lr) * np.float32(decay_rate) ** stairs
        return float(np.maximum(lr, np.float32(min_lr)))
    return schedule


def bn_momentum_schedule(init_decay: float = 0.5, decay_rate: float = 0.5,
                         decay_samples: float = 200000.0,
                         batch_size: int = 32, clip: float = 0.99
                         ) -> Callable[[int], float]:
    def schedule(step) -> float:
        stairs = _stairs(step, batch_size, decay_samples)
        decay = np.float32(init_decay) * np.float32(decay_rate) ** stairs
        return float(np.minimum(np.float32(1.0) - decay, np.float32(clip)))
    return schedule
