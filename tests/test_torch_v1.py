"""F-PointNet v1 in the port against the flax modules, with bridged
weights, on the CPU: every v1 module and the whole model, in eval mode
(running statistics perturbed) and in train mode (outputs and the
updated BN buffers; dropout rate 0, the step tests inject the mask).

Tolerances: float32 within 1e-4 of the output's largest value (f32 sums
in another order), and 1e-3 for what follows the masking in train mode:
the JAX masking rebuilds the object points from bf16 hi + lo parts
(2^-17 relative, 4e-5 m at 5 m) and a train-mode BatchNorm over 4
frustums divides by the spread of 4 values (measured 2.8e-4);
bfloat16 within 3% of it and, for the whole model,
mask agreement >= 99% (the limits of tests/test_torch_slice_bf16.py: the
two sides round to bf16 at the same sites, but XLA on the CPU may keep
excess precision between a dot and the next bf16 op).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import bridged, init_flax, n, t, to_numpy_tree, tree_leaves
from transferable3d_tpu.core import bins as jbins
from transferable3d_tpu.models import frustum_pointnet_v1 as jv1
from transferable3d_tpu.models import registry as jregistry
from transferable3d_torch.core import bins as tbins
from transferable3d_torch.models import frustum_pointnet_v1 as tv1
from transferable3d_torch.models import registry
from transferable3d_torch.train import train_loop as tloop
from transferable3d_torch.utils import bridge

B, N, NOBJ, NC = 4, 256, 64, 10
MOMENTUM = 0.7


def _inputs(seed, c):
    rng = np.random.RandomState(seed)
    pts = rng.normal(size=(B, N, c)).astype(np.float32)
    pts[..., 2] += 5.0
    one_hot = np.eye(NC, dtype=np.float32)[rng.randint(0, NC, B)]
    return pts, one_hot


def _modules(name, dtype, c):
    """(flax module, port module, input width) by name."""
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    kw = dict(dtype=tdt, device="cpu")
    if name == "seg_net":
        return (jv1.InstanceSegNetV1(dtype=jdt, dropout_rate=0.0),
                tv1.InstanceSegNetV1(NC, c, dropout_rate=0.0, **kw))
    if name == "box_net":
        return (jv1.BoxEstimationNetV1(cfg=jbins.SUNRGBD, dtype=jdt),
                tv1.BoxEstimationNetV1(tbins.SUNRGBD, **kw))
    if name == "model":
        return (jv1.FrustumPointNetV1(cfg=jbins.SUNRGBD, dtype=jdt,
                                      num_object_point=NOBJ,
                                      dropout_rate=0.0),
                tv1.FrustumPointNetV1(tbins.SUNRGBD, num_object_point=NOBJ,
                                      dropout_rate=0.0, in_channels=c,
                                      **kw))
    return (jv1.BoxEstimationOnly(cfg=jbins.SUNRGBD, dtype=jdt),
            tv1.BoxEstimationOnly(tbins.SUNRGBD, **kw))


def _close(got, ref, dtype, what, f32_tol=1e-4):
    ref = np.asarray(ref, np.float32)
    tol = (f32_tol if dtype == "float32" else 0.03) * max(np.abs(ref).max(),
                                                          1e-3)
    np.testing.assert_allclose(n(got), ref, rtol=0, atol=tol, err_msg=what)


def _compare(name, got, ref, dtype, train):
    if name in ("seg_net", "box_net"):
        _close(got, ref, dtype, name)
        return
    assert sorted(got) == sorted(ref)
    agree = (n(got["mask"]) == np.asarray(ref["mask"])).mean()
    assert agree >= (1.0 if dtype == "float32" else 0.99), agree
    keys = sorted(got) if dtype == "float32" else ["seg_logits"]
    for k in keys:
        if k != "mask":
            after_masking = name == "model" and k != "seg_logits"
            _close(got[k], ref[k], dtype, k,
                   1e-3 if train and after_masking else 1e-4)
    for k in got:
        assert np.isfinite(n(got[k])).all(), k


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name,c", [("seg_net", 4), ("box_net", 3),
                                    ("model", 3), ("box_only", 4)])
def test_v1_module_matches_flax(name, c, train, dtype):
    pts, one_hot = _inputs(len(name) + c, c)
    jm, tm = _modules(name, dtype, c)
    params, stats = init_flax(jm, 3, jnp.asarray(pts), jnp.asarray(one_hot),
                              train=False, bn_momentum=0.9)
    def apply(p):  # op by op, as tests/test_torch_slice_bf16.py applies
        return jm.apply({"params": p, "batch_stats": stats},
                        jnp.asarray(pts), jnp.asarray(one_hot), train=train,
                        bn_momentum=MOMENTUM, mutable=["batch_stats"])

    if name == "model":
        # Shift the foreground logit so about half the points are masked.
        logits = np.asarray(apply(params)[0]["seg_logits"], np.float32)
        params["seg_net"]["seg_out"]["bias"][1] -= np.median(
            logits[..., 1] - logits[..., 0])
    ref, upd = apply(params)
    port = bridged(tm, params, stats).train(train)
    with torch.no_grad():
        got = port(t(pts), t(one_hot), MOMENTUM)
    _compare(name, got, ref, dtype, train)
    if name == "model":
        share = float(np.asarray(ref["mask"]).mean())
        assert 0.2 < share < 0.8, share
    # The BN buffers after the call: unchanged in eval mode, moved towards
    # the batch statistics in train mode (f32 on both sides; the batch
    # statistics of a bf16 layer's input differ as that input does).
    want = tree_leaves(to_numpy_tree(upd["batch_stats"]))
    have = tree_leaves(bridge.state_dict_to_flax(port)[1])
    assert sorted(want) == sorted(have)
    tol = 1e-4 if dtype == "float32" else 0.03
    for p in want:
        if train and name == "model" and not p.startswith("seg_net"):
            if dtype == "bfloat16":
                # Up to 1% of the mask differs in bf16, and these are
                # statistics over 4 frustums' pooled features.
                assert np.isfinite(have[p]).all(), p
                continue
            tol = 1e-3
        np.testing.assert_allclose(
            have[p], want[p], rtol=0, err_msg=p,
            atol=tol * max(np.abs(want[p]).max(), 1e-3))
        if train:
            assert not np.array_equal(want[p], tree_leaves(stats)[p]), p


@pytest.mark.parametrize("name", ["frustum_pointnets_v1",
                                  "box_estimation_v1"])
def test_bridge_uses_every_v1_leaf_once_both_ways(name):
    pts, one_hot = _inputs(0, 4)
    jm = jregistry.get_model(name, jbins.SUNRGBD)
    params, stats = init_flax(jm, 1, jnp.asarray(pts), jnp.asarray(one_hot),
                              train=False)
    tm = registry.get_model(name, tbins.SUNRGBD, device="cpu")
    bridge.load_flax_variables(tm, params, stats)   # raises on any mismatch
    back_p, back_s = bridge.state_dict_to_flax(tm)
    for a, b in ((params, back_p), (stats, back_s)):
        a, b = tree_leaves(a), tree_leaves(b)
        assert sorted(a) == sorted(b)
        for p in a:
            np.testing.assert_array_equal(a[p], b[p], err_msg=p)
    if name == "frustum_pointnets_v1":
        assert "bias" not in params["seg_net"]["mlp3_global"]
        assert tm.seg_net.mlp3_global.bias is None
        assert sum(v.size for v in tree_leaves(params).values()) == sum(
            p.numel() for p in tm.parameters())
    # A tree with a leaf too many is refused.
    params["box_net"]["head"]["out"]["extra"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError):
        bridge.load_flax_variables(tm, params, stats)


REGISTRY_NAMES = ["frustum_pointnets_v1", "frustum_pointnets_v2",
                  "box_estimation_v1"]


@pytest.mark.parametrize("name", REGISTRY_NAMES)
def test_get_model_lands_on_the_card_unless_asked_for_the_cpu(name,
                                                              monkeypatch):
    """Without `device` a model is built on the card; on a machine
    without one that raises and names `device="cpu"`, which works."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        registry.get_model(name, tbins.SUNRGBD)
    model = registry.get_model(name, tbins.SUNRGBD, device="cpu")
    assert {p.device.type for p in model.parameters()} == {"cpu"}
    assert {b.device.type for b in model.buffers()} == {"cpu"}


def test_registry_names():
    assert isinstance(registry.get_model("frustum_pointnets_v1",
                                         tbins.SUNRGBD, device="cpu"),
                      tv1.FrustumPointNetV1)
    assert isinstance(registry.get_model("box_estimation_v1", tbins.KITTI,
                                         device="cpu"),
                      tv1.BoxEstimationOnly)
    with pytest.raises(KeyError, match="frustum_pointnets_v1"):
        registry.get_model("no_such_model", tbins.SUNRGBD, device="cpu")


def test_v1_train_mode_needs_a_generator_and_predicts():
    pts, one_hot = _inputs(2, 4)
    model = tv1.FrustumPointNetV1(tbins.SUNRGBD, num_object_point=NOBJ,
                                  device="cpu").train()
    with pytest.raises(ValueError, match="Generator"):
        model(t(pts), t(one_hot))
    out = model(t(pts), t(one_hot), 0.9, torch.Generator().manual_seed(0))
    assert out["seg_logits"].shape == (B, N, 2)
    pred = tloop.make_predict_step(model, tbins.SUNRGBD)(
        {"points": pts, "one_hot": one_hot})
    assert pred["center"].shape == (B, 3)
    assert all(np.isfinite(n(v)).all() for v in pred.values())
