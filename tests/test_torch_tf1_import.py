"""The port's TF1 checkpoint importer (`utils/tf1_import.py`) against the
JAX package's, on TF1 checkpoints written here with `tensorflow`: JAX's
round trip and missing-variables cases, the port's import equal to JAX's
array for array, and a v1 model loaded through `load_tf1_checkpoint`
predicting as JAX's does on those parameters (f32, CPU, 4 frustums x
256 points)."""

import os
import sys

import numpy as np
import pytest
import torch

tf = pytest.importorskip("tensorflow")

import jax  # noqa: E402

from transferable3d_tpu.core import bins as jbins  # noqa: E402
from transferable3d_tpu.models.frustum_pointnet_v1 import (  # noqa: E402
    FrustumPointNetV1)
from transferable3d_tpu.utils import tf1_import as jtf1  # noqa: E402
from transferable3d_torch.core import bins as tbins  # noqa: E402
from transferable3d_torch.models import registry  # noqa: E402
from transferable3d_torch.utils import tf1_import  # noqa: E402

sys.path.insert(0, os.path.dirname(__file__))
from test_tf1_import import _write_ckpt  # noqa: E402
from test_tf1_parity import _make_weights  # noqa: E402
from torch_parity import one_torch_thread  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

B, N, C, K = 4, 256, 4, 10


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), v


def _assert_trees_equal(got, want):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype == np.float32, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _save(values, path):
    """A TF1 checkpoint holding `values` {name: array}."""
    with tf.Graph().as_default():
        for name, value in values.items():
            tf.Variable(value, name=name)
        with tf.compat.v1.Session() as sess:
            sess.run(tf.compat.v1.global_variables_initializer())
            tf.compat.v1.train.Saver().save(sess, path)
    return path


def test_import_roundtrip_equals_jax(tmp_path):
    """JAX's round trip: spot values, the concat conv split; then the
    whole trees equal JAX's import of the same checkpoint, and the tree
    loads into the port's v1 model leaf for leaf."""
    ckpt = str(tmp_path / "model.ckpt")
    values = _write_ckpt(ckpt, np.random.RandomState(0))
    params, stats = tf1_import.import_tf1_checkpoint(ckpt)
    np.testing.assert_array_equal(
        params["seg_net"]["mlp1"]["dense_0"]["kernel"],
        values["conv1/weights"].reshape(4, 64))
    np.testing.assert_array_equal(
        params["seg_net"]["mlp1"]["bn_0"]["scale"], values["conv1/bn/gamma"])
    np.testing.assert_array_equal(
        stats["seg_net"]["mlp2"]["bn_2"]["var"],
        values["conv5/bn/moving_variance"])
    w6 = values["conv6/weights"].reshape(1098, 512)
    np.testing.assert_array_equal(
        params["seg_net"]["mlp3_point"]["kernel"], w6[:64])
    np.testing.assert_array_equal(
        params["seg_net"]["mlp3_global"]["kernel"], w6[64:])
    np.testing.assert_array_equal(
        params["box_net"]["head"]["out"]["kernel"], values["fc3/weights"])

    jparams, jstats = jtf1.import_tf1_checkpoint(ckpt)
    _assert_trees_equal(params, jparams)
    _assert_trees_equal(stats, jstats)
    assert (tf1_import.list_tf1_variables(ckpt)
            == jtf1.list_tf1_variables(ckpt))

    model = registry.get_model("frustum_pointnets_v1", tbins.SUNRGBD,
                               dtype=torch.float32, device="cpu",
                               in_channels=C)
    tf1_import.load_tf1_checkpoint(model, ckpt)
    sd = model.state_dict()
    torch.testing.assert_close(
        sd["seg_net.mlp3_global.weight"],
        torch.from_numpy(np.ascontiguousarray(w6[64:].T)), rtol=0, atol=0)
    torch.testing.assert_close(
        sd["seg_net.mlp2.bn_2.var"],
        torch.from_numpy(values["conv5/bn/moving_variance"]), rtol=0, atol=0)


def test_missing_variables_fail_loudly(tmp_path):
    ckpt = _save({"conv1/weights": np.zeros((1, 1, 4, 64), np.float32)},
                 str(tmp_path / "bad.ckpt"))
    with pytest.raises(KeyError, match="missing variables"):
        tf1_import.import_tf1_checkpoint(ckpt)
    model = registry.get_model("frustum_pointnets_v1", tbins.SUNRGBD,
                               dtype=torch.float32, device="cpu",
                               in_channels=C)
    with pytest.raises(KeyError, match="missing variables"):
        tf1_import.load_tf1_checkpoint(model, ckpt)
    # strict=False returns what there is, which no longer fills the model
    params, _ = tf1_import.import_tf1_checkpoint(ckpt, strict=False)
    assert list(_leaves(params))[0][0] == "seg_net/mlp1/dense_0/kernel"
    with pytest.raises(ValueError, match="flax/port trees differ"):
        tf1_import.load_tf1_checkpoint(model, ckpt, strict=False)


def test_loaded_v1_model_predicts_as_jax(tmp_path):
    """A TF1 checkpoint loaded into the port's v1 model and into JAX's
    gives the same predictions in eval mode (f32): the mask exactly, every
    other output within 1e-4 of its largest magnitude."""
    rng = np.random.RandomState(7)
    weights = _make_weights(rng)
    pts = rng.normal(0.0, 1.5, size=(B, N, C)).astype(np.float32)
    pts[..., 2] += 12.0
    pts[..., 3] = rng.uniform(size=(B, N))
    one_hot = np.eye(K, dtype=np.float32)[[0, 3, 7, 9]]
    jmodel = FrustumPointNetV1(cfg=jbins.SUNRGBD)

    def jax_forward(ckpt):
        params, stats = jtf1.import_tf1_checkpoint(ckpt)
        return jax.tree.map(np.asarray, jmodel.apply(
            {"params": params, "batch_stats": stats}, pts, one_hot,
            train=False))

    # Shift the foreground logit so that about half the points are masked.
    seg = jax_forward(_save(weights, str(tmp_path / "probe.ckpt")))
    margin = seg["seg_logits"][..., 1] - seg["seg_logits"][..., 0]
    weights["conv10/biases"] = np.array([0.0, -np.median(margin)],
                                        np.float32)
    ckpt = _save(weights, str(tmp_path / "model.ckpt"))
    want = jax_forward(ckpt)
    assert 0.2 < want["mask"].mean() < 0.8

    model = registry.get_model("frustum_pointnets_v1", tbins.SUNRGBD,
                               dtype=torch.float32, device="cpu",
                               in_channels=C).eval()
    tf1_import.load_tf1_checkpoint(model, ckpt)
    with torch.no_grad():
        got = model(torch.from_numpy(pts), torch.from_numpy(one_hot))
    assert sorted(got) == sorted(want)
    np.testing.assert_array_equal(got["mask"].numpy(), want["mask"])
    for k in want:
        ref = np.asarray(want[k], np.float32)
        np.testing.assert_allclose(
            got[k].float().numpy(), ref, rtol=0, err_msg=k,
            atol=1e-4 * max(np.abs(ref).max(), 1e-3))
