"""Port parity: core constants, weight bridge, layers, masking, decode,
TNet.

Same numpy inputs and bridged flax weights through the JAX package and
`transferable3d_torch`. Float32 results agree to 1e-5 (sums in another
order); bf16 layer outputs agree to one bf16 step (2^-7 relative).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import bridged, init_flax, n, t
from transferable3d_tpu.core import bins as jbins
from transferable3d_tpu.core import geometry as jgeo
from transferable3d_tpu.models import layers as jlayers
from transferable3d_tpu.models import model_util as jmu
from transferable3d_tpu.models.frustum_pointnet_v1 import TNet as JTNet
from transferable3d_torch.core import bins as tbins
from transferable3d_torch.core import geometry as tgeo
from transferable3d_torch.models import layers as tlayers
from transferable3d_torch.models import model_util as tmu
from transferable3d_torch.models.frustum_pointnet_v1 import TNet as TTNet
from transferable3d_torch.utils import bridge

KW = dict(train=False, bn_momentum=0.9)


@pytest.mark.parametrize("name", ["SUNRGBD", "KITTI"])
def test_bin_configs_equal_jax(name):
    j, p = getattr(jbins, name), getattr(tbins, name)
    assert j.classes == p.classes and j.mean_sizes == p.mean_sizes
    assert j.box_output_dim == p.box_output_dim
    assert tbins.NUM_OBJECT_POINT == jbins.NUM_OBJECT_POINT
    assert tbins.NUM_HEADING_BIN == jbins.NUM_HEADING_BIN


def test_class_codecs():
    rng = np.random.RandomState(0)
    cls = rng.randint(0, 12, 50)
    res = rng.uniform(-0.4, 0.4, 50).astype(np.float32)
    np.testing.assert_allclose(
        n(tbins.class_to_angle(torch.from_numpy(cls), t(res))),
        np.asarray(jbins.class_to_angle(jnp.asarray(cls), jnp.asarray(res))),
        atol=1e-6)
    scls = rng.randint(0, 10, 50)
    sres = rng.normal(size=(50, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        n(tbins.class_to_size(torch.from_numpy(scls), t(sres),
                              tbins.SUNRGBD)),
        np.asarray(jbins.class_to_size(jnp.asarray(scls), jnp.asarray(sres),
                                       jbins.SUNRGBD)))


def test_rotate_points_y_np_is_the_jax_packages():
    pts = np.random.RandomState(1).normal(size=(4, 9, 3)).astype(np.float32)
    ang = np.float32(0.7)
    np.testing.assert_array_equal(tgeo.rotate_points_y_np(pts, ang),
                                  jgeo.rotate_points_y_np(pts, ang))
    np.testing.assert_array_equal(tgeo.roty_np(ang), jgeo.roty_np(ang))


def test_bridge_maps_every_leaf_once_and_refuses_mismatch():
    x = np.random.RandomState(2).normal(size=(3, 7, 5)).astype(np.float32)
    params, stats = init_flax(jlayers.PointMLP([8, 6]), 0, jnp.asarray(x),
                              **KW)
    sd = bridge.flax_to_state_dict(params, stats)
    assert sorted(sd) == sorted(
        tlayers.PointMLP(5, [8, 6], device="cpu").state_dict())
    np.testing.assert_array_equal(n(sd["dense_0.weight"]),
                                  params["dense_0"]["kernel"].T)
    with pytest.raises(ValueError, match="shape"):
        bridge.load_flax_variables(
            tlayers.PointMLP(4, [8, 6], device="cpu"), params, stats)
    with pytest.raises(ValueError, match="differ"):
        bridge.load_flax_variables(
            tlayers.PointMLP(5, [8, 6, 2], device="cpu"), params, stats)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_point_mlp_and_head(dtype):
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    rng = np.random.RandomState(3)
    x = rng.normal(size=(2, 11, 6)).astype(np.float32)
    mlp = jlayers.PointMLP([16, 8], pool=True, dtype=jdt)
    params, stats = init_flax(mlp, 1, jnp.asarray(x), **KW)
    ref = mlp.apply({"params": params, "batch_stats": stats},
                    jnp.asarray(x).astype(jdt), **KW)
    port = bridged(tlayers.PointMLP(6, [16, 8], pool=True, dtype=tdt,
                                    device="cpu"), params, stats)
    with torch.no_grad():
        got = port(t(x).to(tdt))
    assert got.dtype == tdt
    tol = 1e-5 if dtype == "float32" else 2 ** -7
    np.testing.assert_allclose(n(got), n(ref), rtol=tol, atol=tol)

    head = jlayers.MLPHead([12, 9], out_features=4, dtype=jdt)
    params, stats = init_flax(head, 2, jnp.asarray(x[:, 0]), **KW)
    ref = head.apply({"params": params, "batch_stats": stats},
                     jnp.asarray(x[:, 0]).astype(jdt), **KW)
    port = bridged(tlayers.MLPHead(6, [12, 9], 4, dtype=tdt, device="cpu"),
                   params, stats)
    with torch.no_grad():
        got = port(t(x[:, 0]).to(tdt))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(n(got), n(ref), rtol=tol, atol=tol)


def test_batchnorm_train_mode_and_running_update():
    x = np.random.RandomState(4).normal(1.0, 2.0, (4, 10, 6)).astype(
        np.float32)
    bn = jlayers.ScheduledBatchNorm(use_running_average=False)
    params, stats = init_flax(bn, 3, jnp.asarray(x), 0.7)
    ref, muts = bn.apply({"params": params, "batch_stats": stats},
                         jnp.asarray(x), 0.7, mutable=["batch_stats"])
    port = bridged(tlayers.ScheduledBatchNorm(6, device="cpu"), params,
                   stats).train()
    with torch.no_grad():
        got = port(t(x), 0.7)
    np.testing.assert_allclose(n(got), np.asarray(ref), rtol=1e-5, atol=1e-5)
    for k in ("mean", "var"):
        np.testing.assert_allclose(n(getattr(port, k)),
                                   np.asarray(muts["batch_stats"][k]),
                                   rtol=1e-5, atol=1e-6)


def test_masked_max_pool():
    rng = np.random.RandomState(5)
    x = rng.normal(size=(3, 8, 4)).astype(np.float32)
    mask = (rng.rand(3, 8) > 0.5).astype(np.float32)
    np.testing.assert_array_equal(
        n(tlayers.masked_max_pool(t(x), t(mask))),
        np.asarray(jlayers.masked_max_pool(jnp.asarray(x), jnp.asarray(mask))))


def _masking_inputs():
    """Rows with: more masked points than k, fewer than k, none."""
    rng = np.random.RandomState(6)
    pts = rng.normal(size=(3, 40, 4)).astype(np.float32)
    pts[..., 2] += 4.0
    logits = rng.normal(size=(3, 40, 2)).astype(np.float32)
    logits[0, :, 1] = logits[0, :, 0] + 1.0        # all 40 masked
    logits[1, :, 1] = logits[1, :, 0] - 1.0        # 5 masked
    logits[1, [3, 8, 9, 20, 39], 1] += 2.0
    logits[2, :, 1] = logits[2, :, 0] - 1.0        # empty mask
    return pts, logits


@pytest.mark.parametrize("k", [16, 64])
def test_point_cloud_masking(k):
    pts, logits = _masking_inputs()
    ref = jmu.point_cloud_masking(jnp.asarray(pts), jnp.asarray(logits), k)
    got = tmu.point_cloud_masking(t(pts), t(logits), k)
    np.testing.assert_array_equal(n(got.mask), np.asarray(ref.mask))
    np.testing.assert_allclose(n(got.mask_centroid),
                               np.asarray(ref.mask_centroid), atol=1e-5)
    # The JAX selection rebuilds xyz from bf16 hi/lo parts (exact to
    # 2^-17 relative, core/numerics.exact_hi_lo); the port gathers.
    np.testing.assert_allclose(n(got.object_points),
                               np.asarray(ref.object_points),
                               atol=8 * 2.0 ** -17)
    np.testing.assert_array_equal(n(got.object_points[2]),
                                  np.broadcast_to(pts[2, 0, :3], (k, 3)))


@pytest.mark.parametrize("use_class", [False, True])
def test_parse_and_decode_box(use_class):
    cfg = tbins.SUNRGBD
    rng = np.random.RandomState(7)
    out = rng.normal(size=(5, cfg.box_output_dim)).astype(np.float32)
    cls = rng.randint(0, 10, 5)
    ep_j = jmu.parse_box_output(jnp.asarray(out), jbins.SUNRGBD)
    ep_t = tmu.parse_box_output(t(out), cfg)
    assert sorted(ep_j) == sorted(ep_t)
    for k in ep_j:
        np.testing.assert_allclose(n(ep_t[k]), np.asarray(ep_j[k]),
                                   rtol=1e-6, atol=1e-7)
    ep_j["center"] = jnp.asarray(out[:, :3])
    ep_t["center"] = t(out[:, :3])
    dj = jmu.decode_box(ep_j, jbins.SUNRGBD,
                        class_idx=jnp.asarray(cls) if use_class else None)
    dt = tmu.decode_box(ep_t, cfg,
                        class_idx=torch.from_numpy(cls) if use_class else None)
    for a, b in zip(dt, dj):
        np.testing.assert_allclose(n(a), np.asarray(b), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tnet(dtype):
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    rng = np.random.RandomState(8)
    pts = rng.normal(size=(2, 32, 3)).astype(np.float32)
    oh = np.eye(10, dtype=np.float32)[[3, 7]]
    net = JTNet(dtype=jdt)
    params, stats = init_flax(net, 4, jnp.asarray(pts), jnp.asarray(oh), **KW)
    ref = net.apply({"params": params, "batch_stats": stats},
                    jnp.asarray(pts), jnp.asarray(oh), **KW)
    port = bridged(TTNet(10, dtype=tdt, device="cpu"), params, stats)
    with torch.no_grad():
        got = port(t(pts), t(oh))
    tol = 1e-5 if dtype == "float32" else 0.02 * float(np.abs(ref).max())
    np.testing.assert_allclose(n(got), np.asarray(ref), rtol=tol, atol=tol)
