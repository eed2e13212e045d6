"""Whole serving slice in float32: JAX F-PointNet v2 (unfused SA path,
XLA ops on the CPU) vs the port, with bridged weights and perturbed BN
statistics, on 4 synthetic frustums.

`make_predict_step` outputs and `run_inference` detections agree within
rtol = atol = 1e-4: float32 sums in another order, and the JAX masking
rebuilds the object points from bf16 hi/lo parts (exact to 2^-17
relative) where the port gathers them exactly.
"""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from torch_parity import init_flax, bridged, n
from transferable3d_tpu.core import bins as jbins
from transferable3d_tpu.data import synthetic
from transferable3d_tpu.data.provider import FrustumDataset
from transferable3d_tpu.models.frustum_pointnet_v2 import (
    FrustumPointNetV2 as JV2)
from transferable3d_tpu.train import test as jtest
from transferable3d_tpu.train import train_loop as jloop
from transferable3d_torch.core import bins as tbins
from transferable3d_torch.models import registry
from transferable3d_torch.train import test as ttest
from transferable3d_torch.train import train_loop as tloop

NPOINTS, NOBJ = 256, 64
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def setup():
    recs = synthetic.make_dataset(4, jbins.SUNRGBD, seed=0)
    batch = FrustumDataset(recs, jbins.SUNRGBD, npoints=NPOINTS,
                           seed=0).get_batch([0, 1, 2, 3])
    jm = JV2(cfg=jbins.SUNRGBD, num_object_point=NOBJ)
    params, stats = init_flax(jm, 0, jnp.asarray(batch["points"]),
                              jnp.asarray(batch["one_hot"]), train=False)
    # Shift the foreground logit so about half the points are masked (a
    # random net masks none, and masking then takes point 0 only).
    logits = np.asarray(jax.jit(lambda p, s, x, o: jm.apply(
        {"params": p, "batch_stats": s}, x, o, train=False)["seg_logits"])(
            params, stats, batch["points"], batch["one_hot"]))
    params["seg_net"]["seg_out"]["bias"][1] -= np.median(
        logits[..., 1] - logits[..., 0])
    state = collections.namedtuple("State", "params batch_stats")(
        params, stats)
    tm = bridged(registry.get_model("frustum_pointnets_v2", tbins.SUNRGBD,
                                    num_object_point=NOBJ, device="cpu"),
                 params, stats)
    return recs, batch, jm, state, tm


def test_predict_step(setup):
    _, batch, jm, state, tm = setup
    ref = jloop.make_predict_step(jm, jbins.SUNRGBD)(state, batch)
    got = tloop.make_predict_step(tm, tbins.SUNRGBD)(batch)
    assert sorted(ref) == sorted(got)
    for k in ("heading_class", "size_class", "mask_count"):
        np.testing.assert_array_equal(n(got[k]), np.asarray(ref[k]), k)
    for k in ("center", "size", "heading", "seg_conf", "heading_prob",
              "size_prob"):
        np.testing.assert_allclose(n(got[k]), np.asarray(ref[k]), err_msg=k,
                                   **TOL)
    assert 0 < float(np.asarray(ref["mask_count"]).min())


def test_run_inference(setup):
    recs, _, jm, state, tm = setup
    ref = jtest.run_inference(
        jm, state, FrustumDataset(recs, jbins.SUNRGBD, npoints=NPOINTS,
                                  seed=1), jbins.SUNRGBD, batch_size=3)
    got = ttest.run_inference(
        tm, FrustumDataset(recs, jbins.SUNRGBD, npoints=NPOINTS, seed=1),
        tbins.SUNRGBD, batch_size=3)
    assert len(got) == len(ref) == 4
    for g, r in zip(got, ref):
        assert (g.frame_id, g.classname) == (r.frame_id, r.classname)
        np.testing.assert_allclose(g.center, r.center, **TOL)
        np.testing.assert_allclose(g.size, r.size, **TOL)
        np.testing.assert_allclose(g.heading, r.heading, **TOL)
        np.testing.assert_allclose(g.score, r.score, **TOL)
        np.testing.assert_array_equal(g.box2d, r.box2d)


def test_rotate_back_matches_jax():
    c = np.array([0.3, 1.1, 6.0], np.float32)
    gc, gh = ttest.rotate_back(c, 0.4, -0.25)
    rc, rh = jtest.rotate_back(c, 0.4, -0.25)
    np.testing.assert_array_equal(gc, rc)
    assert gh == rh
