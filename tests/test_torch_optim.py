"""Schedules and the optimizer against the JAX package's (optax).

The staircases at steps 0, 1 and across a boundary; then, from identical
gradient trees, updates of `make_optimizer` with and without
`clip_norm`, and with `grad_accum_steps=2`, equal optax's to rtol 1e-6.
The LR staircase is short here (a step every 2 real updates), so the
tests also pin that the LR follows the count of real updates.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from transferable3d_tpu.train import schedules as jsched
from transferable3d_tpu.train import train_loop as jloop
from transferable3d_torch.train import schedules as tsched
from transferable3d_torch.train import train_loop as tloop

SHAPES = {"a": (4, 3), "b": (5,), "c": (2, 3, 2)}


@pytest.mark.parametrize("steps", [(0, 1, 99, 100, 101, 100000)])
def test_schedules_equal_jax(steps):
    kw = dict(decay_samples=1000, batch_size=10)
    pairs = [
        (jsched.exponential_staircase_lr(base_lr=1e-3, decay_rate=0.7, **kw),
         tsched.exponential_staircase_lr(base_lr=1e-3, decay_rate=0.7, **kw)),
        (jsched.bn_momentum_schedule(**kw), tsched.bn_momentum_schedule(**kw)),
        (jsched.exponential_staircase_lr(batch_size=128),
         tsched.exponential_staircase_lr(batch_size=128)),
        (jsched.bn_momentum_schedule(batch_size=128),
         tsched.bn_momentum_schedule(batch_size=128)),
    ]
    for jf, tf in pairs:
        for s in steps:
            got = tf(s)
            assert isinstance(got, float)
            np.testing.assert_allclose(got, float(jf(s)), rtol=1e-6)
    lr = tsched.exponential_staircase_lr(decay_samples=1000, batch_size=10)
    assert lr(99) == pytest.approx(1e-3) and lr(100) == pytest.approx(7e-4)


@pytest.mark.parametrize("clip_norm,accum", [(None, 1), (0.5, 1),
                                             (1e3, 1), (None, 2), (0.5, 2)])
def test_optimizer_equals_optax(clip_norm, accum):
    rng = np.random.RandomState(0)
    p0 = {k: (rng.uniform(0.5, 1.5, s) * rng.choice([-1, 1], s)
              ).astype(np.float32) for k, s in SHAPES.items()}
    lr_kw = dict(base_lr=1e-2, decay_rate=0.5, decay_samples=20,
                 batch_size=10)
    jtx = jloop.make_optimizer(jsched.exponential_staircase_lr(**lr_kw),
                               clip_norm=clip_norm, grad_accum_steps=accum)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    jstate = jtx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in p0.items()}
    topt = tloop.make_optimizer(tsched.exponential_staircase_lr(**lr_kw),
                                clip_norm=clip_norm,
                                grad_accum_steps=accum)(
        [tp[k] for k in SHAPES])
    updated = []
    for i in range(3 * accum):
        g = {k: rng.normal(0, 1, s).astype(np.float32)
             for k, s in SHAPES.items()}
        g["b"][:2] = 0.0
        upd, jstate = jtx.update({k: jnp.asarray(v) for k, v in g.items()},
                                 jstate, jp)
        jp = optax.apply_updates(jp, upd)
        topt.zero_grad()
        for k in SHAPES:
            tp[k].grad = torch.from_numpy(g[k])
        updated.append(topt.step())
        for k in SHAPES:
            np.testing.assert_allclose(tp[k].detach().numpy(),
                                       np.asarray(jp[k]), rtol=1e-6,
                                       err_msg=f"{k} after call {i}")
    assert updated == [(i + 1) % accum == 0 for i in range(3 * accum)]
    assert topt.count == 3
