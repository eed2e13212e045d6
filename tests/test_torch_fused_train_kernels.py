"""Port parity: the plain twins of the fused-SA training kernels K5-K9
against the Pallas kernels they replace, called directly.

The JAX side runs `_call_extract`, `_call_fwd_step`, `_call_fwd_last`,
`_call_bwd_step`, `_call_bwd_step0` (rows layout) and their planar twins
`_call_extract_p`, `_call_fwd_step_cp`, `_call_fwd_pool_ymax_cp`,
`_call_bwd_step_cp`, `_call_bwd_step0_cp` in interpret mode, at the
shapes of tests/test_fused_sa.py with the empty, short and overfull
balls of tests/test_torch_fused_sa.py. The planar layout [B, F, S*K] is
the rows layout [B, S, K, F] transposed; the test transposes. The port
has one twin (and one CUDA kernel) for both layouts.

Both sides get the same packs, weights and z tensors (numpy, from a
seed). Tolerances: bf16 tensors (z, dy) at least 99% bit-identical with
max |diff| <= 1% of max |value| (the f32 sums inside the products run in
another order, which can move a bf16 rounding by one step); the slot
counts exact; and on integer-valued inputs, where every sum is exact in
any order and no rounding happens, everything exact: that is the tight
check of every f32 sum. On real-valued inputs the JAX kernels' sums are
not sums of their own bf16 outputs on the CPU: XLA keeps a value that was
rounded to bf16 and converted back in f32 ("excess precision"), so the
kernel sums the unrounded f32 values while it stores the rounded ones
(K5's z1 is bit-identical and its sums still differ by 8e-4). So the
real-valued sums are held to bf16's rounding noise: the forward's within
2e-3 of the reference's norm, the backward's within 2e-3 of the sums of
their terms' magnitudes (db_j is zero in exact arithmetic in train mode,
so its own value is no scale).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import n, t
from transferable3d_tpu.ops import fused_sa as jfs
from transferable3d_torch.ops import fused_sa as tfs

B, S, N, K, R = 2, 8, 64, 16, 0.9
FEATS = (16, 24, 40)
F_MAX = max(FEATS)
EPS = 1e-3
LAYOUTS = ["rows", "planar"]
BF = jnp.bfloat16


def _geometry(seed):
    rng = np.random.RandomState(seed)
    xyz = rng.uniform(-1.5, 1.5, (B, N, 3)).astype(np.float32)
    xyz[:, :24] = rng.normal(0, 0.2, (B, 24, 3))
    cent = rng.uniform(-1.5, 1.5, (B, S, 3)).astype(np.float32)
    cent[:, 0] = 0.0    # overfull ball
    cent[:, 1] = 10.0   # empty ball
    return rng, cent, xyz


def _bf(x):
    """float32 numpy array rounded to bf16 values."""
    return n(t(x).bfloat16())


def _pack(rng, f):
    g = rng.uniform(0.5, 1.5, f).astype(np.float32)
    g[::5] *= -1.0  # channels pooled from zmin
    pack = tfs._make_pack(
        t(g), t(rng.uniform(-0.3, 0.3, f).astype(np.float32)),
        t(rng.normal(0, 0.2, f).astype(np.float32)),
        t(rng.uniform(0.5, 2.0, f).astype(np.float32)), EPS,
        t(rng.normal(0, 1e-2, f).astype(np.float32)),
        t(rng.normal(0, 1e-2, f).astype(np.float32)))
    return n(pack)


def _case(seed, integer=False):
    """Inputs of every pass of one depth-3 chain, as numpy arrays: the z
    tensors come from the port's own forward twins."""
    rng, cent, xyz = _geometry(seed)
    if integer:
        pf = rng.randint(-4, 5, (B, N, FEATS[0])).astype(np.float32)
        qc = rng.randint(-2, 3, (B, S, FEATS[0])).astype(np.float32)
        packs = [np.zeros((6, f), np.float32) for f in FEATS]
        for p in packs:
            p[0] = p[3] = 1.0
        ws = [(rng.randint(-1, 2, (FEATS[i], FEATS[i + 1]))
               * (rng.rand(FEATS[i], FEATS[i + 1]) < 0.3)).astype(np.float32)
              for i in range(2)]
        bs = [rng.randint(-1, 2, FEATS[i + 1]).astype(np.float32)
              for i in range(2)]
    else:
        pf = _bf(rng.uniform(-1, 1, (B, N, FEATS[0])).astype(np.float32))
        qc = _bf(rng.uniform(-1, 1, (B, S, FEATS[0])).astype(np.float32))
        packs = [_pack(rng, f) for f in FEATS]
        ws = [(rng.normal(size=(FEATS[i], FEATS[i + 1])) * 0.3).astype(
            np.float32) for i in range(2)]
        bs = [rng.uniform(-0.1, 0.1, FEATS[i + 1]).astype(np.float32)
              for i in range(2)]
    z0 = tfs.sa_extract_plain(t(cent), t(xyz), t(pf).bfloat16(),
                              t(qc).bfloat16(), R, K)[0]
    z1 = tfs.sa_fwd_step_plain(z0, t(packs[0]), t(ws[0]), t(bs[0]))[0]
    z2, _, _, zmax, zmin = tfs.sa_fwd_step_plain(z1, t(packs[1]), t(ws[1]),
                                                 t(bs[1]), True)
    pooled = tfs._pool_epilogue(zmax, zmin, t(packs[2]))
    if integer:
        dpooled = rng.randint(-2, 3, pooled.shape).astype(np.float32) * 4
        dy2 = rng.randint(-1, 2, z2.shape).astype(np.float32)
    else:
        dpooled = _bf(rng.uniform(-1, 1, pooled.shape).astype(np.float32))
        dy2 = _bf(rng.uniform(-1, 1, z2.shape).astype(np.float32))
    return dict(cent=cent, xyz=xyz, pf=pf, qc=qc, packs=packs, ws=ws, bs=bs,
                zs=[n(z0), n(z1), n(z2)], pooled=n(pooled), dpooled=dpooled,
                dy2=dy2)


def _j(x, bf16=False):
    return jnp.asarray(x).astype(BF) if bf16 else jnp.asarray(x)


def _planar(x):
    """rows [B, S, K, F] (jax) -> planar [B, F, S*K]."""
    return jnp.swapaxes(x.reshape(B, S * K, x.shape[-1]), 1, 2)


def _rows(x):
    """planar [B, F, S*K] (jax) -> rows [B, S, K, F]."""
    return jnp.swapaxes(x, 1, 2).reshape(B, S, K, x.shape[1])


def _z(x, layout):
    x = _j(x, bf16=True)
    return _planar(x) if layout == "planar" else x


def _assert_bf16_close(got, ref, exact=False):
    got, ref = n(got), n(ref)
    assert got.shape == ref.shape
    assert (ref != 0).mean() >= 0.05, "comparison would be zeros vs zeros"
    if exact:
        np.testing.assert_array_equal(got, ref)
        return
    assert (got == ref).mean() >= 0.99
    assert np.abs(got - ref).max() <= 0.01 * np.abs(ref).max()


def _assert_sum_close(got, ref, exact=False, what="", mag=None):
    got, ref = n(got), np.asarray(ref, np.float32).reshape(n(got).shape)
    if exact:
        np.testing.assert_array_equal(got, ref, err_msg=what)
    elif mag is None:
        rel = np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30)
        assert rel <= 2e-3, (what, rel)
    else:
        excess = (np.abs(got - ref) / (2e-3 * n(mag) + 1e-30)).max()
        assert excess <= 1.0, (what, excess)


def test_case_has_empty_short_and_overfull_balls():
    _, cent, xyz = _geometry(0)
    d2 = ((cent[:, :, None] - xyz[:, None]) ** 2).sum(-1)
    count = (d2 <= R * R).sum(-1)
    assert (count == 0).any() and (count > K).any()
    assert ((count > 0) & (count < K)).any()


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("seed,integer", [(0, False), (1, False), (2, True)])
def test_extract_twin_matches_jax_kernel(layout, seed, integer):
    """K5 (`_extract_kernel`) and K14 (`_extract_kernel_p`)."""
    c = _case(seed, integer)
    args = (_j(c["cent"]), _j(c["xyz"]), _j(c["pf"], True), _j(c["qc"], True),
            R, K)
    if layout == "planar":
        z1, sums, sumsq = jfs._call_extract_p(*args, F_MAX, True)
        z1 = _rows(z1)
    else:
        z1, sums, sumsq = jfs._call_extract(*args, True)
    got = tfs.sa_extract(t(c["cent"]), t(c["xyz"]), t(c["pf"]).bfloat16(),
                         t(c["qc"]).bfloat16(), R, K)
    assert got[0].dtype == torch.bfloat16
    np.testing.assert_array_equal(n(got[0]), n(z1))
    _assert_sum_close(got[1], sums, integer, "sum")
    _assert_sum_close(got[2], sumsq, integer, "sumsq")


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("integer", [False, True])
def test_fwd_step_twin_matches_jax_kernel(layout, integer):
    """K6 (`_fwd_step_kernel`) and K10 (`_fwd_step_kernel_cp`)."""
    c = _case(3, integer)
    call = jfs._call_fwd_step_cp if layout == "planar" else jfs._call_fwd_step
    z, sums, sumsq = call(_z(c["zs"][0], layout), S, K, FEATS[0], FEATS[1],
                          _j(c["packs"][0]), _j(c["ws"][0]), _j(c["bs"][0]),
                          F_MAX, True)
    z = _rows(z) if layout == "planar" else z
    got = tfs.sa_fwd_step(t(c["zs"][0]).bfloat16(), t(c["packs"][0]),
                          t(c["ws"][0]), t(c["bs"][0]))
    assert len(got) == 3 and got[0].dtype == torch.bfloat16
    _assert_bf16_close(got[0], z, integer)
    _assert_sum_close(got[1], sums, integer, "sum")
    _assert_sum_close(got[2], sumsq, integer, "sumsq")


@pytest.mark.parametrize("integer", [False, True])
def test_fwd_last_twin_matches_jax_kernel(integer):
    """K7 (`_fwd_last_kernel`), and the pool epilogue on its extrema."""
    c = _case(4, integer)
    z, sums, sumsq, zmax, zmin = jfs._call_fwd_last(
        _z(c["zs"][1], "rows"), S, K, FEATS[1], FEATS[2], _j(c["packs"][1]),
        _j(c["ws"][1]), _j(c["bs"][1]), F_MAX, True)
    got = tfs.sa_fwd_step(t(c["zs"][1]).bfloat16(), t(c["packs"][1]),
                          t(c["ws"][1]), t(c["bs"][1]), last=True)
    _assert_bf16_close(got[0], z, integer)
    _assert_sum_close(got[1], sums, integer, "sum")
    _assert_sum_close(got[2], sumsq, integer, "sumsq")
    for mine, theirs in ((got[3], zmax), (got[4], zmin)):
        assert (n(mine) == n(theirs)).mean() >= (1.0 if integer else 0.99)
    # The extrema are those of the twin's own z'.
    np.testing.assert_array_equal(n(got[3]), n(got[0]).max(axis=2))
    np.testing.assert_array_equal(n(got[4]), n(got[0]).min(axis=2))
    pooled = jfs._pool_epilogue(zmax, zmin, _j(c["packs"][2]))
    _assert_bf16_close(tfs._pool_epilogue(got[3], got[4], t(c["packs"][2])),
                       pooled, integer)


def test_pool_epilogue_matches_planar_pool_kernel():
    """K11 (`_fwd_pool_ymax_kernel_cp`): the planar schedule's pool pass
    against K7's extrema and the pool epilogue."""
    c = _case(5)
    pack = c["packs"][2]
    pooled, ymax = jfs._call_fwd_pool_ymax_cp(
        _z(c["zs"][2], "planar"), S, K, FEATS[2], _j(pack), F_MAX, True)
    z2 = t(c["zs"][2])
    zmax, zmin = z2.amax(dim=2), z2.amin(dim=2)
    np.testing.assert_array_equal(
        n(tfs._pool_epilogue(zmax, zmin, t(pack))), n(pooled))
    a, cc = t(pack[0]), t(pack[1])
    mine = torch.where(a > 0, a * zmax + cc, a * zmin + cc)
    np.testing.assert_allclose(n(mine), n(ymax), rtol=1e-6, atol=1e-6)


def _dy_src(c, top, layout):
    if top:
        return (_j(c["pooled"], True), _j(c["dpooled"], True))
    return _z(c["dy2"], layout)


def _t_dy_src(c, top):
    if top:
        return (t(c["pooled"]).bfloat16(), t(c["dpooled"]).bfloat16())
    return t(c["dy2"]).bfloat16()


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("top", [False, True])
@pytest.mark.parametrize("train", [False, True])
def test_bwd_step_twin_matches_jax_kernel(layout, top, train):
    """K8 (`_bwd_step_kernel`) and K12 (`_bwd_step_kernel_cp`), j = 1."""
    c = _case(6)
    call = jfs._call_bwd_step_cp if layout == "planar" else jfs._call_bwd_step
    dy, sdy, sdyx, dw, db = call(
        train, top, _z(c["zs"][1], layout), _z(c["zs"][2], layout),
        _dy_src(c, top, layout), S, K, FEATS[1], FEATS[2], _j(c["packs"][1]),
        _j(c["packs"][2]), _j(c["ws"][1]), F_MAX, True)
    dy = _rows(dy) if layout == "planar" else dy
    got = tfs.sa_bwd_step(train, top, t(c["zs"][1]).bfloat16(),
                          t(c["zs"][2]).bfloat16(), _t_dy_src(c, top),
                          t(c["packs"][1]), t(c["packs"][2]), t(c["ws"][1]))
    _assert_bf16_close(got[0], dy)
    mags = tfs.sa_bwd_sum_magnitudes(
        train, top, t(c["zs"][1]).bfloat16(), t(c["zs"][2]).bfloat16(),
        _t_dy_src(c, top), t(c["packs"][1]), t(c["packs"][2]), t(c["ws"][1]))
    for name, mine, theirs, mag in zip(STEP0_OUTPUTS, got[1:],
                                       (sdy, sdyx, dw, db), mags):
        _assert_sum_close(mine, theirs, what=name, mag=mag)


def _step0_both(c, layout, train, top, j):
    """K9 and its JAX kernel at step j of `c` (j = 0 below a stored dy, or
    j = 1 as the top of a depth-2 chain)."""
    fj, fj1 = FEATS[j], FEATS[j + 1]
    rng = np.random.RandomState(11)
    qc = (c["qc"] if j == 0 else
          _bf(rng.uniform(-1, 1, (B, S, fj)).astype(np.float32)))
    if top:
        jdy, tdy = _dy_src(c, True, layout), _t_dy_src(c, True)
    else:
        dy1 = tfs.sa_bwd_step_plain(
            train, True, t(c["zs"][1]).bfloat16(), t(c["zs"][2]).bfloat16(),
            _t_dy_src(c, True), t(c["packs"][1]), t(c["packs"][2]),
            t(c["ws"][1]))[0]
        jdy, tdy = _z(n(dy1), layout), dy1
    jargs = (train, top, _z(c["zs"][j], layout), _z(c["zs"][j + 1], layout),
             jdy, _j(c["cent"]), _j(c["xyz"]), _j(qc, True), S, K, fj, fj1,
             _j(c["packs"][j]), _j(c["packs"][j + 1]), _j(c["ws"][j]), R)
    if layout == "planar":
        ref = jfs._call_bwd_step0_cp(*jargs, F_MAX, True)
    else:
        ref = jfs._call_bwd_step0(*jargs, True)
    got = tfs.sa_bwd_step0(
        train, top, t(c["zs"][j]).bfloat16(), t(c["zs"][j + 1]).bfloat16(),
        tdy, t(c["cent"]), t(c["xyz"]), t(qc).bfloat16(), t(c["packs"][j]),
        t(c["packs"][j + 1]), t(c["ws"][j]), R)
    mags = tfs.sa_bwd_sum_magnitudes(
        train, top, t(c["zs"][j]).bfloat16(), t(c["zs"][j + 1]).bfloat16(),
        tdy, t(c["packs"][j]), t(c["packs"][j + 1]), t(c["ws"][j]))
    return got, ref, mags


STEP0_OUTPUTS = ("sdy", "sdyx", "dw", "db", "H", "Mq", "cnt", "Sdy", "Sz")


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("top", [False, True])
@pytest.mark.parametrize("train", [False, True])
def test_bwd_step0_twin_matches_jax_kernel(layout, top, train):
    """K9 (`_bwd_step0_kernel`) and K13 (`_bwd_step0_kernel_cp`)."""
    got, ref, mags = _step0_both(_case(7), layout, train, top,
                                 1 if top else 0)
    assert len(got) == len(ref) == 9
    mags = (*mags, None, None, None, None, None)
    for name, mine, theirs, mag in zip(STEP0_OUTPUTS, got, ref, mags):
        assert tuple(mine.shape) == tuple(
            np.asarray(theirs).reshape(mine.shape).shape), name
        if name == "cnt":
            np.testing.assert_array_equal(n(mine), np.asarray(theirs))
            assert n(mine).sum() == B * S * K  # every slot has one point
        else:
            _assert_sum_close(mine, theirs, what=name, mag=mag)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_backward_twins_exact_on_integers(layout):
    """Identity packs, weights in {-1, 0, 1} and small-integer data and
    cotangents: every value is an integer that bf16 and the f32 sums hold
    exactly, so K8's and K9's twins equal the JAX kernels bit for bit."""
    c = _case(8, integer=True)
    call = jfs._call_bwd_step_cp if layout == "planar" else jfs._call_bwd_step
    ref = call(False, False, _z(c["zs"][1], layout), _z(c["zs"][2], layout),
               _z(c["dy2"], layout), S, K, FEATS[1], FEATS[2],
               _j(c["packs"][1]), _j(c["packs"][2]), _j(c["ws"][1]), F_MAX,
               True)
    got = tfs.sa_bwd_step(False, False, t(c["zs"][1]).bfloat16(),
                          t(c["zs"][2]).bfloat16(), t(c["dy2"]).bfloat16(),
                          t(c["packs"][1]), t(c["packs"][2]), t(c["ws"][1]))
    dy1 = _rows(ref[0]) if layout == "planar" else ref[0]
    _assert_bf16_close(got[0], dy1, exact=True)
    for mine, theirs in zip(got[1:], ref[1:]):
        _assert_sum_close(mine, theirs, exact=True)
    jargs = (False, False, _z(c["zs"][0], layout), _z(c["zs"][1], layout),
             _z(n(got[0]), layout), _j(c["cent"]), _j(c["xyz"]),
             _j(c["qc"], True), S, K, FEATS[0], FEATS[1], _j(c["packs"][0]),
             _j(c["packs"][1]), _j(c["ws"][0]), R)
    ref0 = (jfs._call_bwd_step0_cp(*jargs, F_MAX, True)
            if layout == "planar" else jfs._call_bwd_step0(*jargs, True))
    got0 = tfs.sa_bwd_step0(
        False, False, t(c["zs"][0]).bfloat16(), t(c["zs"][1]).bfloat16(),
        got[0], t(c["cent"]), t(c["xyz"]), t(c["qc"]).bfloat16(),
        t(c["packs"][0]), t(c["packs"][1]), t(c["ws"][0]), R)
    assert float(got0[4].abs().max()) > 0
    for name, mine, theirs in zip(STEP0_OUTPUTS, got0, ref0):
        _assert_sum_close(mine, theirs, exact=True, what=name)


# Heavy collisions for K9's sums onto the points: (B, S, N, K, F0,
# radius). Few points in many full balls, short balls whose members fill
# up to K slots, empty balls.
STEP0_COLLIDE = {
    "full_balls": (2, 32, 40, 64, 16, 5.0),
    "short_balls": (2, 24, 64, 128, 16, 0.3),
    "mixed": (3, 48, 96, 32, 32, 0.6),
}


@pytest.mark.parametrize("case", sorted(STEP0_COLLIDE))
def test_step0_twin_is_the_member_sequential_sum(case):
    """K9's twin adds H, Mq and cnt in the order the card's K9 adds them,
    bit for bit: each member's slot sum in f32 from +0.0 over its slots
    r - 1, r - 1 + eff, ... in ascending order, then onto its point from
    +0.0 in ascending s; Mq the members' mult * qc[s] and cnt their mult,
    mult = (K - r) // eff + 1, in the same order."""
    b, s, npt, k, f0, r = STEP0_COLLIDE[case]
    rng = np.random.RandomState(11)
    xyz = rng.normal(0, 0.6, (b, npt, 3)).astype(np.float32)
    cent = xyz[:, rng.randint(0, npt, s)] + rng.normal(0, 0.05, (b, s, 3))
    cent = cent.astype(np.float32)
    cent[:, ::5] += 100.0
    dy0 = t(rng.normal(0, 1, (b, s, k, f0)).astype(np.float32)).bfloat16()
    qc = t(rng.normal(0, 1, (b, s, f0)).astype(np.float32)).bfloat16()
    idx, count = tfs._slots(t(cent), t(xyz), r, k)
    h, mq, cnt = tfs.step0_scatter_plain(idx, count, dy0, qc, npt)
    idx, d, q = n(idx), n(dy0.float()), n(qc.float())
    eff = np.clip(n(count), 1, k)
    assert eff.min() == 1 and eff.max() > 1  # empty and many-member balls
    seq_h = np.zeros((b, npt, f0), np.float32)
    seq_q = np.zeros((b, npt, f0), np.float32)
    seq_c = np.zeros((b, npt), np.float32)
    for bb in range(b):
        for ss in range(s):
            e = int(eff[bb, ss])
            for j in range(e):
                m = np.zeros(f0, np.float32)
                for kk in range(j, k, e):
                    m += d[bb, ss, kk]
                mult = np.float32((k - 1 - j) // e + 1)
                p = idx[bb, ss, j]
                seq_h[bb, p] += m
                seq_q[bb, p] += mult * q[bb, ss]
                seq_c[bb, p] += mult
    assert seq_c.max() >= k  # some point fills K slots or more
    np.testing.assert_array_equal(n(h), seq_h)
    np.testing.assert_array_equal(n(mq), seq_q)
    np.testing.assert_array_equal(n(cnt)[:, 0], seq_c)
    assert int(n(cnt).sum()) == b * s * k  # every slot has one point


def test_step0_table_width():
    assert [tfs.step0_table_width(s) for s in (1, 4, 5, 32, 127, 128)] == [
        4, 4, 8, 32, 128, 128]


def test_step0_scratch_bytes_counts_the_balls_members():
    """K9's scratch at hand-placed balls: centroid 0 holds points 0-2,
    centroid 1 none (eff 1, its nearest point), centroid 2 all five but
    K = 4 of them; the member rows (f32, written and read), the table
    (zeroed and written, then read: S = 3 rounds up to 4 bytes a point),
    the member bytes and eff."""
    xyz = torch.tensor([[[0.0, 0, 0], [0.05, 0, 0], [0, 0.05, 0],
                         [0.3, 0, 0], [0.35, 0, 0]]])
    cent = torch.tensor([[[0.0, 0, 0], [9.0, 9, 9], [0.17, 0, 0]]])
    members, f0 = 3 + 1 + 4, 16
    assert tfs.step0_scratch_bytes(cent, xyz, 0.2, 4, f0) == (
        2 * members * f0 * 4 + 2 * 5 * 4 + members + 2 * 3 * 4)


def test_kernel_wrappers_refuse_cpu_tensors():
    c = _case(0)
    z0, z1 = t(c["zs"][0]).bfloat16(), t(c["zs"][1]).bfloat16()
    with pytest.raises(ValueError):
        tfs.sa_extract_cuda(t(c["cent"]), t(c["xyz"]), t(c["pf"]).bfloat16(),
                            t(c["qc"]).bfloat16(), R, K)
    with pytest.raises(ValueError):
        tfs.sa_fwd_step_cuda(z0, t(c["packs"][0]), t(c["ws"][0]),
                             t(c["bs"][0]))
    with pytest.raises(ValueError):
        tfs.sa_bwd_step_cuda(True, False, z0, z1, z1, t(c["packs"][0]),
                             t(c["packs"][1]), t(c["ws"][0]))
    with pytest.raises(ValueError):
        tfs.sa_bwd_step0_cuda(True, False, z0, z1, z1, t(c["cent"]),
                              t(c["xyz"]), t(c["qc"]).bfloat16(),
                              t(c["packs"][0]), t(c["packs"][1]),
                              t(c["ws"][0]), R)


SMEM_LIMIT = 232448
# K, F_j, F_j1, top: K8's (top) and K9's (below a stored dy) launches of
# the eight grouped set-abstraction scales of F-PointNet v2.
PATH_SHAPES = [(32, 32, 64, True), (64, 64, 128, True),
               (128, 96, 128, True), (64, 64, 128, True),
               (64, 128, 256, True), (128, 128, 256, True),
               (64, 64, 128, True), (64, 128, 256, True),
               (32, 32, 32, False), (64, 64, 64, False),
               (128, 64, 96, False), (64, 64, 64, False),
               (64, 128, 128, False), (128, 128, 128, False),
               (64, 64, 64, False), (64, 128, 128, False)]
CORNER_SHAPES = [(k, fj, fj1, top)
                 for k, fj, fj1 in ((16, 16, 16), (128, 256, 128),
                                    (128, 128, 256), (16, 128, 256),
                                    (16, 256, 128), (48, 96, 96),
                                    (80, 16, 16), (112, 160, 192))
                 for top in (True, False)]


@pytest.mark.parametrize("k,f_j,f_j1,top", PATH_SHAPES + CORNER_SHAPES)
def test_bwd_plan_fits_every_shape_the_launcher_admits(k, f_j, f_j1, top):
    """The tile plan of K8/K9: whole centroids, at most 128 rows, a power
    of two that divides the block's 16 warps; one to three stages; and a
    block's shared memory, as the kernel lays it out, within the card's
    232,448 bytes. Two stages need W_j resident (the plan never trades W
    for a stage)."""
    plan = tfs.sa_bwd_plan(k, f_j, f_j1, top)
    assert plan.ct >= 1 and plan.ct * k <= 128 and 16 % plan.ct == 0
    assert 1 <= plan.stages <= 3
    assert plan.stages == 1 or plan.w_smem
    assert plan.smem == tfs.sa_bwd_layout_bytes(
        k, f_j, f_j1, plan.ct, plan.stages, plan.w_smem, top)
    assert plan.smem <= SMEM_LIMIT
    assert tfs.sa_bwd_smem_bytes(k, f_j, f_j1, top) == plan.smem
    if plan.stages < 3:  # nothing larger would have fit
        more = plan.stages + 1 if plan.w_smem else 1
        assert tfs.sa_bwd_layout_bytes(k, f_j, f_j1, plan.ct, more, True,
                                       top) > SMEM_LIMIT


@pytest.mark.parametrize("k,f_j,f_j1,top,ct,stages,w_smem", [
    (32, 32, 64, True, 4, 3, True), (64, 64, 128, True, 2, 3, True),
    (128, 96, 128, True, 1, 2, True), (64, 128, 256, True, 1, 2, True),
    (128, 128, 256, True, 1, 1, True), (32, 32, 32, False, 4, 3, True),
    (64, 64, 64, False, 2, 3, True), (128, 64, 96, False, 1, 2, True),
    (64, 128, 128, False, 1, 3, True), (128, 128, 128, False, 1, 1, True),
    (16, 16, 16, False, 8, 3, True), (128, 256, 128, False, 1, 1, False),
    (128, 128, 256, False, 1, 1, False)])
def test_bwd_plan_of_the_path_shapes(k, f_j, f_j1, top, ct, stages, w_smem):
    """The plans the kernel's header states: several centroids a tile
    below K = 128, a ring of two or three stages wherever two fit with
    W_j, one stage at K = 128 with 128 <- 256 and 128 <- 128, and W_j
    through L2 only at the widest corners."""
    plan = tfs.sa_bwd_plan(k, f_j, f_j1, top)
    assert (plan.ct, plan.stages, plan.w_smem) == (ct, stages, w_smem)


@pytest.mark.parametrize("ncent,ct,tiles,last", [
    (15, 4, 4, 3), (15, 2, 8, 1), (15, 8, 2, 7), (15, 1, 15, 1),
    (16384, 4, 4096, 4), (1875, 2, 938, 1)])
def test_bwd_tiles_of_a_ragged_launch(ncent, ct, tiles, last):
    """`sa_bwd_tiles`: the tiles of a launch and the centroids of the last
    one, which the kernel neither loads nor uses beyond."""
    assert tfs.sa_bwd_tiles(ncent, ct) == (tiles, last)


def test_smem_budget_of_the_largest_path_scale():
    # seg-SA2 scale 3: K=128, F 128 -> 256 (one block of K8/K9, of K6/K7).
    assert tfs.sa_bwd_smem_bytes(128, 128, 256) < 232448
    assert tfs.sa_fwd_smem_bytes(128, 128, 256) < 232448


# K, F_in, F_out, last: K6's (last False) and K7's (last True) launches of
# the eight grouped set-abstraction scales of F-PointNet v2, and corners:
# the smallest tile, 48 and 80 rows a centroid, and the widest layers.
FWD_PATH_SHAPES = [(32, 32, 32, False), (64, 64, 64, False),
                   (128, 64, 96, False), (64, 128, 128, False),
                   (128, 128, 128, False), (32, 32, 64, True),
                   (64, 64, 128, True), (128, 96, 128, True),
                   (64, 128, 256, True), (128, 128, 256, True)]
FWD_CORNER_SHAPES = [(k, fi, fo, last)
                     for k, fi, fo in ((16, 16, 16), (48, 96, 96),
                                       (80, 16, 256), (128, 256, 256),
                                       (16, 256, 256), (112, 256, 128))
                     for last in (False, True)]


@pytest.mark.parametrize("k,f_in,f_out,last",
                         FWD_PATH_SHAPES + FWD_CORNER_SHAPES)
def test_fwd_plan_fits_every_shape_the_launcher_admits(k, f_in, f_out, last):
    """The tile plan of K6/K7: whole centroids, at most 128 rows; one to
    three stages; a block's shared memory, as the kernel lays it out
    (`fwd_layout`: the z_prev ring, W, the z' staging tile, a | c | b and
    K7's extrema of 8 row blocks), within the card's 232,448 bytes; and
    nothing larger would have fit (W resident before a stage)."""
    plan = tfs.sa_fwd_plan(k, f_in, f_out, last)
    rows = plan.ct * k
    assert plan.ct == max(1, 128 // k) and rows <= 128
    assert 1 <= plan.stages <= 3
    assert plan.smem == (plan.stages * rows * (f_in + 8) * 2
                         + (f_in * (f_out + 8) * 2 if plan.w_smem else 0)
                         + rows * (f_out + 8) * 2 + (2 * f_in + f_out) * 4
                         + (64 * f_out if last else 0))
    assert plan.smem == tfs.sa_fwd_layout_bytes(
        k, f_in, f_out, plan.ct, plan.stages, plan.w_smem, last)
    assert plan.smem <= SMEM_LIMIT
    if plan.stages < 3:
        assert tfs.sa_fwd_layout_bytes(k, f_in, f_out, plan.ct,
                                       plan.stages + 1, plan.w_smem,
                                       last) > SMEM_LIMIT
    if not plan.w_smem:
        assert tfs.sa_fwd_layout_bytes(k, f_in, f_out, plan.ct, 1, True,
                                       last) > SMEM_LIMIT


@pytest.mark.parametrize("k,f_in,f_out,last,ct,stages,w_smem", [
    (32, 32, 32, False, 4, 3, True), (32, 32, 64, True, 4, 3, True),
    (64, 64, 128, True, 2, 3, True), (128, 96, 128, True, 1, 3, True),
    (64, 128, 128, False, 2, 3, True), (64, 128, 256, True, 2, 2, True),
    (128, 128, 256, True, 1, 2, True), (128, 256, 256, True, 1, 2, False)])
def test_fwd_plan_of_the_path_shapes(k, f_in, f_out, last, ct, stages,
                                     w_smem):
    """The plans sa_train_fwd.cu's design states: 128-row tiles of whole
    centroids, a ring of three stages with W resident wherever it fits,
    two at 128 -> 256, and W through L2 only at 256 -> 256."""
    plan = tfs.sa_fwd_plan(k, f_in, f_out, last)
    assert (plan.ct, plan.stages, plan.w_smem) == (ct, stages, w_smem)


@pytest.mark.parametrize("k", range(16, 129, 16))
def test_extract_plan_fits_every_shape_the_launcher_admits(k):
    """K5's plan: 16 warps a block (one centroid a warp), 16-byte accesses
    wherever F0 is a multiple of 8, and two blocks an SM, with each warp's
    member list (K ints) and its f64 sums (256 pairs of 8 bytes) within
    the card's 232,448 bytes, for every F0 up to 256 that is a multiple
    of 16."""
    for f0 in range(16, 257, 16):
        plan = tfs.sa_extract_plan(k, f0)
        assert (plan.warps, plan.vec, plan.per_sm) == (16, 8, 2), f0
        assert plan.smem == 16 * (4 * k + 2 * 256 * 8), f0
        assert plan.smem == tfs.sa_extract_layout_bytes(k, f0, 16), f0
        assert 2 * (plan.smem + 1024) <= 233472 and plan.smem <= SMEM_LIMIT


@pytest.mark.parametrize("k,f0,warps,vec,per_sm", [
    (24, 20, 16, 1, 2), (1, 3, 16, 1, 2), (784, 256, 16, 8, 2),
    (785, 256, 16, 8, 1), (2608, 256, 16, 8, 1), (2609, 256, 15, 8, 1),
    (4096, 256, 11, 8, 1), (4096, 1, 11, 1, 1)])
def test_extract_plan_beyond_the_training_path(k, f0, warps, vec, per_sm):
    """K5 also takes what the unfused branch's shapes would give it: K up
    to 4,096 (fewer warps a block once 16 lists do not fit) and any F0
    (one bf16 an access where F0 is not a multiple of 8)."""
    plan = tfs.sa_extract_plan(k, f0)
    assert (plan.warps, plan.vec, plan.per_sm) == (warps, vec, per_sm)
    assert plan.smem == tfs.sa_extract_layout_bytes(k, f0, warps)
    assert plan.smem <= SMEM_LIMIT
    if warps < 16:
        assert tfs.sa_extract_layout_bytes(k, f0, warps + 1) > SMEM_LIMIT


@pytest.mark.parametrize("f_in,f_out", [(24, 40), (16, 24), (40, 64)])
def test_fwd_step_padding_changes_no_z(f_in, f_out):
    """The card's padding of a training chain (`_padded_chain`: zero
    channels of z, zero rows and columns of W, zero biases, and gamma =
    beta = 0 there, so a = c = 0) applied to K6/K7's plain twin: z' on the
    real channels bit-identical to the unpadded twin's, zero on the
    padding, and K7's extrema likewise."""
    g = torch.Generator().manual_seed(f_in * f_out)
    z = torch.randn(2, 8, K, f_in, generator=g).bfloat16()
    pack = tfs._make_pack(torch.rand(f_in, generator=g) + 0.5,
                          torch.randn(f_in, generator=g) * 0.2,
                          torch.randn(f_in, generator=g) * 0.2,
                          torch.rand(f_in, generator=g) + 0.5, EPS)
    w = torch.randn(f_in, f_out, generator=g) / f_in ** 0.5
    b = torch.randn(f_out, generator=g) * 0.1
    ref = tfs.sa_fwd_step_plain(z, pack, w, b, True)
    pi, po = -(-f_in // 16) * 16, -(-f_out // 16) * 16
    (wp,), (bp,) = tfs._pad_dense((pi, po), [w], [b])
    got = tfs.sa_fwd_step_plain(tfs._pad_to(z, pi), tfs._pad_to(pack, pi),
                                wp, bp, True)
    assert torch.equal(got[0][..., :f_out], ref[0])
    assert not bool(got[0][..., f_out:].any())
    for i in (3, 4):
        assert torch.equal(got[i][..., :f_out], ref[i])
