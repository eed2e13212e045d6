"""The three training prerequisites of the port:

* `T3D_FUSED_SA` is read at call time: "0" sends a bf16 grouped MLP down
  the unfused path (grouped_payload -> BN -> ReLU -> Dense -> max), as
  the JAX module does, without touching the fused twin; "1" in train
  mode raises and names `T3D_FUSED_SA=0`, never falling back quietly;
* the seg-head dropout draws its keep mask from an explicit
  `torch.Generator` (never the global one), scales kept values by 2,
  and draws through one replaceable function;
* chip_smoke.py scopes autograd-off to its serving phases.

The bf16 grouped MLP agrees with the JAX unfused module to one bf16
step: >= 99% of values bit-identical, max |diff| <= 1% of max |value|
(f32 sums in another order can move a rounding by one step).
"""

import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import bridged, init_flax, n, t
from transferable3d_tpu.models import pointnet2 as jpn2
from transferable3d_torch.core import bins as tbins
from transferable3d_torch.models import layers as tlayers
from transferable3d_torch.models import pointnet2 as tpn2
from transferable3d_torch.models.frustum_pointnet_v2 import (
    FrustumPointNetV2 as TV2)
from transferable3d_torch.ops import fused_sa as tfs

B, N, S, K, R = 2, 96, 12, 16, 0.6
FEATS = (16, 24, 32)


def _module_inputs(seed):
    rng = np.random.RandomState(seed)
    xyz = rng.uniform(-1, 1, (B, N, 3)).astype(np.float32)
    feats = rng.uniform(-1, 1, (B, N, 5)).astype(np.float32)
    return xyz, jnp.asarray(feats).astype(jnp.bfloat16), xyz[:, :S].copy()


def _refuse(*_a, **_k):
    raise AssertionError("the fused twin must not run with T3D_FUSED_SA=0")


@pytest.mark.parametrize("train", [False, True])
def test_fused_sa_0_takes_the_unfused_branch(train, monkeypatch):
    monkeypatch.setenv("T3D_FUSED_SA", "0")
    monkeypatch.setattr(tfs, "sa_infer", _refuse)
    monkeypatch.setattr(tfs, "fused_grouped_chain", _refuse)
    xyz, feats, new_xyz = _module_inputs(0)
    mod = jpn2.GroupedPointMLP(FEATS, R, K, dtype=jnp.bfloat16)
    params, stats = init_flax(mod, 0, jnp.asarray(new_xyz), jnp.asarray(xyz),
                              feats, train=False, bn_momentum=0.9)
    ref, upd = mod.apply({"params": params, "batch_stats": stats},
                         jnp.asarray(new_xyz), jnp.asarray(xyz), feats,
                         train=train, bn_momentum=0.8,
                         mutable=["batch_stats"])
    port = bridged(tpn2.GroupedPointMLP(5, FEATS, R, K, dtype=torch.bfloat16),
                   params, stats).train(train)
    with torch.no_grad():
        got = port(t(new_xyz), t(xyz), t(feats), 0.8)
    assert got.dtype == torch.bfloat16
    g, r = n(got), n(ref)
    assert (r != 0).mean() >= 0.10
    assert (g == r).mean() >= 0.99
    assert np.abs(g - r).max() <= 0.01 * np.abs(r).max()
    if train:
        np.testing.assert_allclose(
            n(port.bn_1.mean), np.asarray(upd["batch_stats"]["bn_1"]["mean"]),
            rtol=2e-2, atol=1e-3)


def test_fused_training_raises_and_names_the_variable(monkeypatch):
    monkeypatch.setenv("T3D_FUSED_SA", "1")
    xyz, feats, new_xyz = _module_inputs(1)
    port = tpn2.GroupedPointMLP(5, FEATS, R, K, dtype=torch.bfloat16).train()
    with pytest.raises(NotImplementedError, match="T3D_FUSED_SA=0"):
        port(t(new_xyz), t(xyz), t(feats))


def test_dropout_draws_from_the_explicit_generator(monkeypatch):
    x = torch.randn(3, 40, 16).bfloat16() + 3.0  # no zero entries
    torch.manual_seed(0)
    a = tlayers.dropout(x, 0.5, torch.Generator().manual_seed(5))
    torch.manual_seed(1)  # the global generator must not matter
    b = tlayers.dropout(x, 0.5, torch.Generator().manual_seed(5))
    c = tlayers.dropout(x, 0.5, torch.Generator().manual_seed(6))
    assert torch.equal(a, b) and not torch.equal(a, c)
    kept = a != 0
    assert 0.4 < kept.float().mean() < 0.6
    assert torch.equal(a[kept], x[kept] * 2)  # exact in bf16
    keep = torch.zeros(3, 40, 16, dtype=torch.bool)
    keep[:, ::2] = True
    monkeypatch.setattr(tlayers, "dropout_keep_mask",
                        lambda shape, rate, gen: keep)
    d = tlayers.dropout(x, 0.5, torch.Generator())
    assert torch.equal(d, torch.where(keep, x * 2, torch.zeros_like(x)))


def test_train_mode_model_needs_a_generator(monkeypatch):
    monkeypatch.setenv("T3D_FUSED_SA", "0")
    model = TV2(tbins.SUNRGBD, num_object_point=16).train()
    rng = np.random.RandomState(0)
    pts = torch.from_numpy(rng.normal(0, 1, (2, 64, 4)).astype(np.float32))
    one_hot = torch.eye(10)[:2]
    with pytest.raises(ValueError, match="Generator"):
        model(pts, one_hot)
    outs = [model(pts, one_hot, generator=torch.Generator().manual_seed(3))
            ["seg_logits"] for _ in range(2)]
    assert torch.equal(outs[0], outs[1])


def test_chip_smoke_scopes_autograd_off():
    src = (pathlib.Path(__file__).resolve().parent.parent
           / "chip_smoke.py").read_text()
    assert "set_grad_enabled(False)" not in src
    assert "torch.no_grad()" in src
