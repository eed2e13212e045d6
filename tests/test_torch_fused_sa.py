"""Port parity: fused SA inference (plain twin of kernel K2) and
GroupedPointMLP in eval mode (training: tests/test_torch_fused_train*.py).

The JAX side runs `fused_grouped_chain(train=False)` with the Pallas
inference kernel in interpret mode, in both its `rows` and `planar`
layouts, at the shapes of tests/test_fused_sa.py, with centroids whose
balls are empty, short and overfull.

Tolerance (the same as the card's check in chip_smoke.py): at least 99%
of the pooled bf16 values bit-identical and max |diff| <= 1% of
max |pooled|. The rounding sites are the same on both sides; what may
differ is the order of the f32 sums inside the chain's dots (and a
1-ulp rsqrt in the packs), which can move a bf16 rounding by one step.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import bridged, init_flax, n, t
from transferable3d_tpu.models import pointnet2 as jpn2
from transferable3d_tpu.ops import fused_sa as jfs
from transferable3d_tpu.ops.grouping import ball_query_group
from transferable3d_torch.models import pointnet2 as tpn2
from transferable3d_torch.ops import fused_sa as tfs

B, S, N, F0, K, R = 2, 8, 64, 16, 16, 0.9
FEATS = (F0, 24, 40)
EPS = 1e-3


def _setup(seed):
    rng = np.random.RandomState(seed)
    xyz = rng.uniform(-1.5, 1.5, (B, N, 3)).astype(np.float32)
    xyz[:, :24] = rng.normal(0, 0.2, (B, 24, 3))
    cent = rng.uniform(-1.5, 1.5, (B, S, 3)).astype(np.float32)
    cent[:, 0] = 0.0    # overfull ball
    cent[:, 1] = 10.0   # empty ball
    pf = rng.uniform(-1, 1, (B, N, F0)).astype(np.float32)
    qc = rng.uniform(-1, 1, (B, S, F0)).astype(np.float32)
    gammas = [rng.uniform(0.5, 1.5, f).astype(np.float32) for f in FEATS]
    betas = [rng.uniform(-0.3, 0.3, f).astype(np.float32) for f in FEATS]
    ws = [(rng.normal(size=(FEATS[i], FEATS[i + 1])) * 0.3).astype(
        np.float32) for i in range(len(FEATS) - 1)]
    bs = [rng.uniform(-0.1, 0.1, FEATS[i + 1]).astype(np.float32)
          for i in range(len(FEATS) - 1)]
    running = [(rng.normal(0, 0.2, f).astype(np.float32),
                rng.uniform(0.5, 2.0, f).astype(np.float32)) for f in FEATS]
    return cent, xyz, pf, qc, gammas, betas, ws, bs, running


def _assert_pooled_close(got, ref):
    got, ref = n(got), n(ref)
    assert got.shape == ref.shape
    assert (ref != 0).mean() >= 0.10, "comparison would be zeros vs zeros"
    assert (got == ref).mean() >= 0.99
    assert np.abs(got - ref).max() <= 0.01 * np.abs(ref).max()


def test_setup_has_empty_short_and_overfull_balls():
    cent, xyz, *_ = _setup(0)
    _, count = ball_query_group(jnp.asarray(cent), jnp.asarray(xyz), None,
                                R, K)
    count = np.asarray(count)
    assert (count == 0).any() and (count > K).any()
    assert ((count > 0) & (count < K)).any()


@pytest.mark.parametrize("layout", ["rows", "planar"])
@pytest.mark.parametrize("seed", [0, 1])
def test_plain_twin_matches_jax_infer_kernel(layout, seed):
    cent, xyz, pf, qc, gammas, betas, ws, bs, running = _setup(seed)
    bf = jnp.bfloat16
    ref, _, _ = jfs.fused_grouped_chain(
        jnp.asarray(cent), jnp.asarray(xyz), jnp.asarray(pf).astype(bf),
        jnp.asarray(qc).astype(bf), tuple(map(jnp.asarray, gammas)),
        tuple(map(jnp.asarray, betas)), tuple(map(jnp.asarray, ws)),
        tuple(map(jnp.asarray, bs)), R, K, EPS, False,
        tuple((jnp.asarray(m), jnp.asarray(v)) for m, v in running),
        True, layout)
    got, means, variances = tfs.fused_grouped_chain(
        t(cent), t(xyz), t(pf).bfloat16(), t(qc).bfloat16(),
        [t(g) for g in gammas], [t(b) for b in betas], [t(w) for w in ws],
        [t(b) for b in bs], R, K, EPS, False,
        [(t(m), t(v)) for m, v in running])
    assert got.dtype == torch.bfloat16
    _assert_pooled_close(got, ref)
    np.testing.assert_array_equal(n(means[0]), running[0][0])
    np.testing.assert_array_equal(n(variances[-1]), running[-1][1])


def test_make_pack_matches_jax():
    rng = np.random.RandomState(3)
    g, b, m = (rng.normal(size=12).astype(np.float32) for _ in range(3))
    v = rng.uniform(0.5, 2, 12).astype(np.float32)
    ref = jfs._make_pack(*map(jnp.asarray, (g, b, m, v)), EPS)
    got = tfs._make_pack(t(g), t(b), t(m), t(v), EPS)
    np.testing.assert_allclose(n(got), np.asarray(ref), rtol=1e-6,
                               atol=1e-7)


def test_train_mode_returns_batch_statistics():
    """Train mode runs (tests/test_torch_fused_train.py holds it against
    the JAX op): it returns the batch's statistics, not the running ones
    it was given, and the eval call that follows still takes K2's twin."""
    cent, xyz, pf, qc, gammas, betas, ws, bs, running = _setup(0)
    args = (t(cent), t(xyz), t(pf).bfloat16(), t(qc).bfloat16(),
            [t(g) for g in gammas], [t(b) for b in betas],
            [t(w) for w in ws], [t(b) for b in bs], R, K, EPS)
    run = [(t(m), t(v)) for m, v in running]
    pooled, means, variances = tfs.fused_grouped_chain(*args, True, run)
    assert pooled.dtype == torch.bfloat16
    assert pooled.shape == (B, S, FEATS[-1])
    for (m, v), mean, var in zip(running, means, variances):
        assert np.abs(n(mean) - m).max() > 1e-2 and (n(var) > 0).all()
    evald, means, _ = tfs.fused_grouped_chain(*args, False, run)
    np.testing.assert_array_equal(n(means[0]), running[0][0])
    assert not np.array_equal(n(evald), n(pooled))


def test_kernel_wrapper_refuses_cpu_tensors():
    cent, xyz, pf, qc, gammas, betas, ws, bs, running = _setup(0)
    packs = [tfs._make_pack(t(g), t(b), t(m), t(v), EPS)
             for g, b, (m, v) in zip(gammas, betas, running)]
    with pytest.raises(ValueError):
        tfs.sa_infer_cuda(t(cent), t(xyz), t(pf).bfloat16(),
                          t(qc).bfloat16(), R, K, packs,
                          [t(w) for w in ws], [t(b) for b in bs])


def test_smem_budget_of_the_largest_path_scale():
    # seg-SA2 scale 3: K=128, F 128 -> 128 -> 256, bf16 ping-pong buffers.
    assert tfs.sa_infer_smem_bytes(128, (128, 128, 256)) < 232448


def _module_inputs(seed):
    rng = np.random.RandomState(seed)
    xyz = rng.uniform(-1.5, 1.5, (B, N, 3)).astype(np.float32)
    feats = rng.uniform(-1, 1, (B, N, 5)).astype(np.float32)
    return xyz, feats, xyz[:, :S].copy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grouped_point_mlp_module(dtype, monkeypatch):
    """GroupedPointMLP, eval: f32 takes the plain grouped branch on both
    sides; bf16 takes the fused branch (JAX: interpret-mode Pallas, the
    port: the K2 plain twin)."""
    xyz, feats, new_xyz = _module_inputs(2)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    feats_j = jnp.asarray(feats).astype(jdt)
    mod = jpn2.GroupedPointMLP((16, 24, 32), R, K, dtype=jdt)
    params, stats = init_flax(mod, 0, jnp.asarray(new_xyz),
                              jnp.asarray(xyz), feats_j, train=False,
                              bn_momentum=0.9)
    if dtype == "bfloat16":
        monkeypatch.setattr(jfs, "INTERPRET", True)
        monkeypatch.setattr(jpn2, "on_tpu", lambda: True)
    ref = mod.apply({"params": params, "batch_stats": stats},
                    jnp.asarray(new_xyz), jnp.asarray(xyz), feats_j,
                    train=False, bn_momentum=0.9)
    port = bridged(tpn2.GroupedPointMLP(5, (16, 24, 32), R, K, dtype=tdt,
                                        device="cpu"), params, stats)
    with torch.no_grad():
        got = port(t(new_xyz), t(xyz), t(feats_j))
    assert got.dtype == tdt
    if dtype == "float32":
        np.testing.assert_allclose(n(got), n(ref), rtol=1e-5, atol=1e-5)
    else:
        _assert_pooled_close(got, ref)


def test_set_abstraction_group_all_and_msg():
    xyz, feats, _ = _module_inputs(4)
    kw = dict(train=False, bn_momentum=0.9)
    msg = jpn2.SetAbstractionMSG(16, (0.4, 0.9), (8, 16),
                                 ((8, 8, 16), (8, 12, 16)))
    params, stats = init_flax(msg, 1, jnp.asarray(xyz), jnp.asarray(feats),
                              **kw)
    jx, jf = msg.apply({"params": params, "batch_stats": stats},
                       jnp.asarray(xyz), jnp.asarray(feats), **kw)
    port = bridged(tpn2.SetAbstractionMSG(16, (0.4, 0.9), (8, 16),
                                          ((8, 8, 16), (8, 12, 16)), 5,
                                          device="cpu"), params, stats)
    with torch.no_grad():
        tx, tf = port(t(xyz), t(feats))
    np.testing.assert_array_equal(n(tx), np.asarray(jx))
    np.testing.assert_allclose(n(tf), np.asarray(jf), rtol=1e-5, atol=1e-5)

    sa = jpn2.SetAbstraction(0, 0.0, 0, (8, 16), group_all=True)
    params, stats = init_flax(sa, 2, jx, jf, **kw)
    _, jg = sa.apply({"params": params, "batch_stats": stats}, jx, jf, **kw)
    port = bridged(tpn2.SetAbstraction(0, 0.0, 0, (8, 16), 32,
                                       group_all=True, device="cpu"),
                   params, stats)
    with torch.no_grad():
        _, tg = port(tx, tf)
    np.testing.assert_allclose(n(tg), np.asarray(jg), rtol=1e-5, atol=1e-5)


def test_feature_propagation():
    rng = np.random.RandomState(6)
    xyz_to = rng.normal(size=(B, 20, 3)).astype(np.float32)
    xyz_from = rng.normal(size=(B, 6, 3)).astype(np.float32)
    f_to = rng.normal(size=(B, 20, 4)).astype(np.float32)
    f_from = rng.normal(size=(B, 6, 7)).astype(np.float32)
    kw = dict(train=False, bn_momentum=0.9)
    fp = jpn2.FeaturePropagation((12, 8))
    args = tuple(map(jnp.asarray, (xyz_to, xyz_from, f_to, f_from)))
    params, stats = init_flax(fp, 3, *args, **kw)
    ref = fp.apply({"params": params, "batch_stats": stats}, *args, **kw)
    port = bridged(tpn2.FeaturePropagation(11, (12, 8), device="cpu"),
                   params, stats)
    with torch.no_grad():
        got = port(*map(t, (xyz_to, xyz_from, f_to, f_from)))
    np.testing.assert_allclose(n(got), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


# --- K2's plan and the launcher's padding ----------------------------------
# (K, widths) of the eight grouped SA scales of F-PointNet v2, and ragged
# chains: K = 24 with a width of 40, K = 1, widths not multiples of 16, a
# last layer wider than any inner one, and inner layers wider than 128.
V2_INFER_SHAPES = [(32, (32, 32, 64)), (64, (64, 64, 128)),
                   (128, (64, 96, 128)), (64, (64, 64, 128)),
                   (64, (128, 128, 256)), (128, (128, 128, 256)),
                   (64, (64, 64, 128)), (64, (128, 128, 256))]
RAGGED_INFER_SHAPES = [(24, (40, 40, 40)), (24, (40, 64, 40)),
                       (1, (64, 64, 128)), (16, (16, 24, 40, 8)),
                       (128, (20, 36, 130)), (64, (64, 64, 512)),
                       (64, (64, 160, 64)), (16, (32, 256, 256, 32))]


@pytest.mark.parametrize("k,dims", V2_INFER_SHAPES + RAGGED_INFER_SHAPES)
def test_infer_plan_fits_every_shape(k, dims):
    """The tensor-core kernel wherever the inner layers, padded to 16,
    are at most 128 wide and the weights fit: at every v2 scale and the
    ragged chains; its shared memory as the kernel lays it out (weights
    with 8 bf16 of padding a row, a | c | b, each of 16 warps' ring of 64
    members and running max and min of the last layer's z) within the
    card's 232,448 bytes. The f32
    kernel takes the rest."""
    plan = tfs.sa_infer_plan(k, dims)
    assert tfs.sa_infer_smem_bytes(k, dims) == plan.smem
    padded = tuple(-(-f // 16) * 16 for f in dims)
    if max(padded[:-1]) <= 128:
        assert plan.mma and plan.dims == padded
        w = sum(padded[d] * (padded[d + 1] + 8) * 2
                for d in range(len(dims) - 1))
        assert plan.smem == (w + 12 * sum(padded)
                             + 16 * (64 + 2 * padded[-1]) * 4)
        assert tfs.sa_infer_layout_bytes(padded) == (
            w, 12 * sum(padded), plan.smem)
    else:
        assert not plan.mma and plan.dims == dims
    assert plan.smem <= 232448


@pytest.mark.parametrize("k,dims", RAGGED_INFER_SHAPES[:5])
def test_infer_padding_changes_no_pooled_value(k, dims):
    """K2's padding to multiples of 16 (zero channels of pf and qc, which
    the launcher appends; zero weights and biases and a = c = 0, which the
    kernel writes into shared memory) applied to the plain twin: the first
    F_{L-1} pooled channels are bit-identical to the unpadded twin's, the
    padded ones zero."""
    g = torch.Generator().manual_seed(k + sum(dims))
    b, n, s = 3, 200, 40
    xyz = torch.rand(b, n, 3, generator=g) * 2
    cent = xyz[:, :s].clone()
    cent[:, ::5] += 100.0  # empty balls
    pf = torch.randn(b, n, dims[0], generator=g).bfloat16()
    qc = torch.randn(b, s, dims[0], generator=g).bfloat16()
    packs = [tfs._make_pack(torch.rand(f, generator=g) + 0.5,
                            torch.randn(f, generator=g) * 0.2,
                            torch.randn(f, generator=g) * 0.2,
                            torch.rand(f, generator=g) + 0.5, EPS)
             for f in dims]
    ws = [torch.randn(dims[i], dims[i + 1], generator=g) / dims[i] ** 0.5
          for i in range(len(dims) - 1)]
    bs = [torch.randn(dims[i + 1], generator=g) * 0.1
          for i in range(len(dims) - 1)]
    ref = tfs.sa_infer_plain(cent, xyz, pf, qc, 0.5, k, packs, ws, bs)
    kd = tfs.sa_infer_plan(k, dims).dims
    got = tfs.sa_infer_plain(
        cent, xyz, tfs._pad_to(pf, kd[0]), tfs._pad_to(qc, kd[0]), 0.5, k,
        [tfs._pad_to(p, f) for p, f in zip(packs, kd)],
        *tfs._pad_dense(kd, ws, bs))
    assert got.shape[-1] == kd[-1] and (ref != 0).float().mean() > 0.3
    assert torch.equal(got[..., :dims[-1]], ref)
    assert not bool(got[..., dims[-1]:].any())
