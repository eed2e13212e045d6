"""The port's device-resident dataset (data/device_dataset.py) against
the JAX package's on the CPU.

Torch's random streams cannot reproduce JAX's, so the batch is built
from JAX's own draws (`u`, `flip`, `z` from the keys `sample_batch`
splits): record indices, sampled indices and labels exactly, points
within 1e-6. The port's own draws are held to the JAX draws'
distribution, and a v1 model trains on the port's device batches, as
tests/test_device_dataset.py does for JAX.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transferable3d_tpu.core import bins as jbins
from transferable3d_tpu.data import device_dataset as jdd
from transferable3d_tpu.data import synthetic as jsyn
from transferable3d_torch.core import bins as tbins
from transferable3d_torch.data import device_dataset as tdd
from transferable3d_torch.data import synthetic as tsyn

from torch_parity import one_torch_thread  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")
CPU = torch.device("cpu")
JCFG, TCFG = jbins.SUNRGBD, tbins.SUNRGBD


def _records(lib, n=8, seed=0):
    return lib.make_dataset(n, JCFG if lib is jsyn else TCFG, seed=seed,
                            n_object=150, n_clutter=60)


def _mixed(lib):
    """Records of 210 points, cut at the budget of 200, and of 140,
    zero-padded."""
    cfg = JCFG if lib is jsyn else TCFG
    return (_records(lib, n=4) + lib.make_dataset(
        4, cfg, seed=1, n_object=100, n_clutter=40))


@pytest.fixture(scope="module")
def both():
    jdata = jdd.build_device_dataset(_mixed(jsyn), JCFG, max_points=200)
    tdata = tdd.build_device_dataset(_mixed(tsyn), TCFG, max_points=200,
                                     device=CPU)
    return jdata, tdata


def test_build_device_dataset_equals_jax(both):
    jdata, tdata = both
    for name in jdd.DeviceFrustums._fields:
        got, want = getattr(tdata, name).numpy(), np.asarray(
            getattr(jdata, name))
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert tdata.num_records == jdata.num_records == 8
    assert tdata.count.tolist() == [200] * 4 + [140] * 4


def _jax_draws(key, b, npoints):
    """The draws of JAX's `sample_batch` (device_dataset.py:99-133)."""
    r_pts, r_flip, r_shift = jax.random.split(key, 3)
    return (np.array(jax.random.uniform(r_pts, (b, npoints))),
            np.array(jax.random.bernoulli(r_flip, 0.5, (b,))),
            np.array(jax.random.normal(r_shift, (b,))))


@pytest.mark.parametrize("flip,shift,seed", [(False, False, 0),
                                             (True, False, 1),
                                             (True, True, 2),
                                             (True, True, 3)])
def test_batch_from_jax_draws_equals_jax(both, flip, shift, seed):
    jdata, tdata = both
    idxs = np.array([5, 0, 3, 3, 7, 1], np.int32)
    key = jax.random.PRNGKey(seed)
    want = jdd.sample_batch(jdata, key, jnp.asarray(idxs), 128, JCFG,
                            random_flip=flip, random_shift=shift)
    u, f, z = _jax_draws(key, len(idxs), 128)
    got = tdd.batch_from_draws(
        tdata, torch.as_tensor(idxs, dtype=torch.int64),
        torch.as_tensor(u), torch.as_tensor(f), torch.as_tensor(z), TCFG,
        random_flip=flip, random_shift=shift)
    assert sorted(got) == sorted(want)
    for key_ in ("seg", "heading_class", "size_class", "class_idx",
                 "one_hot"):
        np.testing.assert_array_equal(got[key_].numpy(),
                                      np.asarray(want[key_]), err_msg=key_)
    for key_ in ("points", "center", "heading_residual", "size_residual"):
        np.testing.assert_allclose(got[key_].numpy(), np.asarray(want[key_]),
                                   atol=1e-6, rtol=0, err_msg=key_)
    if flip:
        assert 0 < f.sum() < len(idxs)


def test_own_draws_have_the_jax_statistics(both):
    """u in [0, 1), a flip rate of one half, the shift clipped at 20% of
    the center's distance, and every sampled point from its record's
    valid prefix."""
    _, tdata = both
    gen = torch.Generator().manual_seed(0)
    b, npts = 4096, 16
    u, flip, z = tdd.draw(gen, b, npts)
    assert 0.0 <= float(u.min()) and float(u.max()) < 1.0
    assert abs(float(u.mean()) - 0.5) < 0.01
    assert abs(float(flip.float().mean()) - 0.5) < 0.03
    assert abs(float(z.mean())) < 0.05 and abs(float(z.std()) - 1.0) < 0.05
    jf = _jax_draws(jax.random.PRNGKey(0), b, npts)[1]
    assert abs(float(flip.float().mean()) - jf.mean()) < 0.05

    idxs = torch.arange(b) % tdata.num_records
    batch = tdd.batch_from_draws(tdata, idxs, u, flip, z * 10.0, TCFG,
                                 random_flip=False, random_shift=True)
    c0 = tdata.center[idxs]
    dist = torch.sqrt(c0[:, 0] ** 2 + c0[:, 2] ** 2)
    shift = batch["center"][:, 2] - c0[:, 2]
    assert bool((shift.abs() <= 0.2 * dist + 1e-5).all())
    assert float((shift.abs() > 0.19 * dist).float().mean()) > 0.5
    sel = torch.floor(u * tdata.count[idxs, None].float()).long()
    assert bool((sel < tdata.count[idxs, None].long()).all())


def test_epoch_iterator_shuffles_as_jax():
    recs = _records(tsyn, n=16, seed=1)
    data = tdd.build_device_dataset(recs, TCFG, max_points=256, device=CPU)
    it = tdd.DeviceEpochIterator(data, TCFG, batch_size=8, npoints=32,
                                 seed=4)
    rng = np.random.RandomState(4)
    for _ in range(2):
        order = rng.permutation(16)
        batches = list(it.epoch())
        assert len(batches) == 2
        for i, b in enumerate(batches):
            np.testing.assert_array_equal(
                b["class_idx"].numpy(),
                [recs[j].class_idx for j in order[8 * i:8 * i + 8]])


def test_trains_with_device_batches():
    from transferable3d_torch.models import registry
    from transferable3d_torch.train import schedules, train_loop

    recs = _records(tsyn, n=16, seed=1)
    data = tdd.build_device_dataset(recs, TCFG, max_points=256, device=CPU)
    it = tdd.DeviceEpochIterator(data, TCFG, batch_size=8, npoints=64,
                                 seed=0)
    model = registry.get_model("frustum_pointnets_v1", TCFG, device=CPU,
                               num_object_point=32)
    lr = schedules.exponential_staircase_lr(batch_size=8)
    bn = schedules.bn_momentum_schedule(batch_size=8)
    state = train_loop.create_train_state(model,
                                          train_loop.make_optimizer(lr))
    step = train_loop.make_train_step(
        TCFG, lr, bn, train_loop.StepConfig(compute_iou_metrics=False))
    losses = []
    for _ in range(6):
        for b in it.epoch():
            state, m = step(state, b)
            losses.append(float(m["total_loss"]))
    assert np.isfinite(losses).all()
    assert np.mean(losses[-4:]) < np.mean(losses[:4])
