"""Card-only checks of the port's CUDA kernels against their plain twins.

Marked `cuda`; each test skips without a CUDA card. This file imports no
JAX, so it also runs on the card's machine, which has none:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(`--noconftest` because tests/conftest.py configures JAX.)
chip_smoke.py runs the same comparisons at the full serving shapes.
"""

import math

import pytest
import torch

from transferable3d_torch.data import frustum_jit
from transferable3d_torch.ops import _build, fused_sa, grouping, sampling

pytestmark = pytest.mark.cuda


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA)")


@pytest.mark.parametrize("b,n,k", [(4, 1024, 128), (3, 128, 32),
                                   (2, 100, 130), (1, 5000, 64)])
def test_fps_kernel_equals_plain(b, n, k):
    _need_cuda()
    g = torch.Generator().manual_seed(b * n + k)
    xyz = (torch.rand(b, n, 3, generator=g) * 8 - 4).cuda()
    xyz[:, 1] = xyz[:, 0]
    xyz[:, 9:14] = xyz[:, 3:4]
    before = _build.LAUNCHES["fps"]
    got = sampling.farthest_point_sample(xyz, k)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["fps"] == before + 1
    assert torch.equal(got, sampling.fps_plain(xyz, k))


# K1 at the sizes of its plan's corners and its register and shared-memory
# paths (1 to 12,288 points), k of 1, 2 and every point.
FPS_SIZES = [(n, k) for n in (1, 31, 32, 33, 128, 512, 1024, 4096, 12288)
             for k in sorted({1, 2, n})]


@pytest.mark.parametrize("n,k", FPS_SIZES)
def test_fps_kernel_indices_at_every_size(n, k):
    """K1's indices identical to the plain twin's on random points with
    repeats, on all-equal points (index 0, then the lowest on ties: 0
    again) and on every point given twice."""
    _need_cuda()
    g = torch.Generator().manual_seed(n + k)
    xyz = (torch.rand(2, n, 3, generator=g) * 8 - 4).cuda()
    xyz[:, n // 2:n // 2 + 5] = xyz[:, :1]
    same = torch.full((2, n, 3), 1.5, device="cuda")
    twice = xyz[:, :(n + 1) // 2].repeat(1, 2, 1)[:, :n].contiguous()
    for pts in (xyz, same, twice):
        got = sampling.fps_cuda(pts, k)
        torch.cuda.synchronize()
        assert torch.equal(got, sampling.fps_plain(pts, k)), n
    assert not bool(sampling.fps_cuda(same, k).any())


def _chain(g, dims, dev):
    packs = [fused_sa._make_pack(
        (torch.rand(f, generator=g) + 0.5).to(dev),
        (torch.randn(f, generator=g) * 0.2).to(dev),
        (torch.randn(f, generator=g) * 0.2).to(dev),
        (torch.rand(f, generator=g) * 1.5 + 0.5).to(dev), 1e-3)
        for f in dims]
    ws = [(torch.randn(dims[i], dims[i + 1], generator=g)
           / dims[i] ** 0.5).to(dev) for i in range(len(dims) - 1)]
    bs = [(torch.randn(dims[i + 1], generator=g) * 0.1).to(dev)
          for i in range(len(dims) - 1)]
    return packs, ws, bs


@pytest.mark.parametrize("s,n,k,r,dims", [
    (16, 256, 32, 0.2, (32, 32, 64)),
    (8, 128, 128, 1.6, (128, 128, 256)),
    (12, 200, 16, 0.5, (16, 24, 40, 8)),
    # ragged chains (padded to 16 by the launcher), K = 24 and K = 1,
    # every ball with one member, a last layer of 512, and the f32 kernel
    # for inner layers wider than 128
    (40, 200, 24, 0.5, (40, 64, 40)),
    (40, 200, 1, 0.5, (64, 64, 128)),
    (20, 256, 128, 1e-4, (64, 96, 128)),
    (8, 128, 128, 1.6, (20, 36, 130)),
    (16, 256, 64, 0.5, (64, 64, 512)),
    (16, 256, 64, 0.5, (64, 160, 64)),
])
def test_sa_infer_kernel_equals_plain(s, n, k, r, dims):
    _need_cuda()
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(s * n + k)
    xyz = (torch.rand(3, n, 3, generator=g) * 2).to(dev)
    cent = xyz[:, :s].clone()
    cent[:, 0] += 100.0  # an empty ball
    pf = torch.randn(3, n, dims[0], generator=g).to(dev).bfloat16()
    qc = torch.randn(3, s, dims[0], generator=g).to(dev).bfloat16()
    packs, ws, bs = _chain(g, dims, dev)
    before = _build.LAUNCHES["sa_infer"]
    got = fused_sa.sa_infer(cent, xyz, pf, qc, r, k, packs, ws, bs)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["sa_infer"] == before + 1
    ref = fused_sa.sa_infer_plain(cent, xyz, pf, qc, r, k, packs, ws, bs)
    assert (ref != 0).float().mean() >= 0.10
    assert (got == ref).float().mean() >= 0.99
    diff = (got.float() - ref.float()).abs().max()
    assert diff <= 0.01 * ref.float().abs().max()


def test_sa_infer_kernel_refuses_bad_inputs():
    _need_cuda()
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    xyz = torch.rand(2, 64, 3, device=dev)
    packs, ws, bs = _chain(g, (16, 16, 32), dev)
    pf = torch.randn(2, 64, 16, device=dev)  # float32: refused
    qc = torch.randn(2, 8, 16, device=dev).bfloat16()
    with pytest.raises(ValueError):
        fused_sa.sa_infer(xyz[:, :8].contiguous(), xyz, pf, qc, 0.4, 16,
                          packs, ws, bs)


# The 8 grouped SA scales of a v2 train step (N, S, radius, K, C = F1):
# seg-SA1 x3, seg-SA2 x3, box-SA1, box-SA2.
SLICE_SCALES = [(1024, 128, 0.2, 32, 32), (1024, 128, 0.4, 64, 64),
                (1024, 128, 0.8, 128, 64), (128, 32, 0.4, 64, 64),
                (128, 32, 0.8, 64, 128), (128, 32, 1.6, 128, 128),
                (512, 128, 0.2, 64, 64), (128, 32, 0.4, 64, 128)]


def _extract_inputs(n, s, c, seed, dev, b=4):
    g = torch.Generator().manual_seed(seed)
    xyz = (torch.randn(b, n, 3, generator=g) * 0.5).to(dev)
    cent = xyz[:, :s].clone()
    cent[:, ::7] += 100.0  # empty balls
    pay = torch.randn(b, n, c, generator=g).to(dev).bfloat16()
    return g, cent, xyz, pay


@pytest.mark.parametrize("n,s,r,k,c", SLICE_SCALES)
def test_extract_kernels_equal_plain(n, s, r, k, c):
    _need_cuda()
    dev = torch.device("cuda")
    g, cent, xyz, pay = _extract_inputs(n, s, c, n + s + k + c, dev)
    before = dict(_build.LAUNCHES)
    pay.requires_grad_(True)
    got, cnt = grouping.grouped_payload(cent, xyz, pay, r, k)
    dg = torch.randn(got.shape, generator=g).to(dev).bfloat16()
    got.backward(dg)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["extract_fwd"] == before["extract_fwd"] + 1
    assert _build.LAUNCHES["extract_bwd"] == before["extract_bwd"] + 1
    ref, cref = grouping.extract_fwd_plain(cent, xyz, pay.detach(), r, k)
    assert torch.equal(cnt, cref) and (cref == 0).any()
    assert torch.equal(got, ref)
    _k4_exact(cent, xyz, dg, r, k, pay.grad, g)


def _k4_exact(cent, xyz, dg, r, k, have, g):
    """K4's result `have` bit-identical to the plain twin run on CPU copies
    (both add each point's slots in ascending (s, k) in f32 and round
    once), the same bits again, and identical to the twin on the card on
    integer-valued cotangents."""
    n = xyz.shape[1]
    want = grouping.extract_bwd_plain(cent.cpu(), xyz.cpu(), dg.cpu(), r, k,
                                      n)
    assert torch.equal(have.cpu(), want)
    assert torch.equal(grouping.extract_bwd_cuda(cent, xyz, dg, r, k), have)
    dgi = torch.randint(-4, 5, dg.shape, generator=g).to(dg.device)
    dgi = dgi.bfloat16()
    assert torch.equal(grouping.extract_bwd_cuda(cent, xyz, dgi, r, k),
                       grouping.extract_bwd_plain(cent, xyz, dgi, r, k, n))


# K3 and K4 at the ends of their plans (B, N, S, radius, K, C, offset):
# every ball one member and every ball full, N = 1 and N = 100, K = 4,096,
# 700 centroids (K4's gather in passes of 128), C of 20 and 3 (one bf16 an
# access), and rows 2 bytes past a 16-byte boundary.
EXTRACT_PROBES = [(4, 512, 128, 1e-4, 64, 64, 0),
                  (4, 512, 128, 100.0, 128, 128, 0), (4, 1, 8, 0.4, 32, 64, 0),
                  (4, 100, 40, 0.4, 64, 32, 0),
                  (2, 4500, 4, 100.0, 4096, 16, 0),
                  (2, 1024, 700, 0.3, 16, 8, 0), (4, 200, 40, 0.5, 24, 20, 0),
                  (4, 256, 64, 0.4, 32, 3, 0), (4, 1024, 128, 0.4, 64, 64, 1)]


@pytest.mark.parametrize("b,n,s,r,k,c,off", EXTRACT_PROBES)
def test_extract_kernels_at_their_plan_edges(b, n, s, r, k, c, off):
    """K3's rows and counts identical to the twin's, K4 as `_k4_exact`
    says, every other centroid 100 m away (empty balls)."""
    _need_cuda()
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(n + s + k + c + off)
    xyz = (torch.randn(b, n, 3, generator=g) * 0.5).to(dev)
    cent = xyz[:, torch.arange(s) % n].clone()
    cent[:, ::2] += 100.0

    def rows(*shape):
        t = torch.empty(math.prod(shape) + off, dtype=torch.bfloat16,
                        device=dev)[off:]
        t.copy_(torch.randn(math.prod(shape), generator=g))
        return t.view(shape)

    pay, dg = rows(b, n, c), rows(b, s, k, c)
    got, cnt = grouping.extract_fwd_cuda(cent, xyz, pay, r, k)
    ref, cref = grouping.extract_fwd_plain(cent, xyz, pay, r, k)
    assert torch.equal(cnt, cref) and torch.equal(got, ref)
    _k4_exact(cent, xyz, dg, r, k, grouping.extract_bwd_cuda(
        cent, xyz, dg, r, k), g)


def test_extract_kernels_refuse_bad_inputs():
    _need_cuda()
    dev = torch.device("cuda")
    _, cent, xyz, pay = _extract_inputs(64, 8, 16, 0, dev, b=2)
    dg = torch.zeros(2, 8, 16, 16, device=dev, dtype=torch.bfloat16)
    bad_fwd = [
        (cent.cpu(), xyz.cpu(), pay.cpu()),             # wrong device
        (cent, xyz, pay.float()),                       # wrong dtype
        (cent, xyz[:, :32].contiguous(), pay),          # N mismatch
        (cent, xyz, pay.transpose(0, 1).contiguous().transpose(0, 1)),
    ]
    for a in bad_fwd:
        with pytest.raises(ValueError):
            grouping.extract_fwd_cuda(*a, 0.4, 16)
    with pytest.raises(ValueError):
        grouping.extract_fwd_cuda(cent, xyz, pay, 0.4, 5000)  # K too big
    bad_bwd = [dg.float(), dg[:, :, :8], dg.cpu(),
               dg.transpose(2, 3).contiguous().transpose(2, 3)]
    for d in bad_bwd:
        with pytest.raises(ValueError):
            grouping.extract_bwd_cuda(cent, xyz, d, 0.4, 16)


# --- fused SA training, K5-K9 ---------------------------------------------
# K5 alone (B, N, S, radius, K, F0): the 8 main-path scales; the corners of
# its plan (K = 16 with F0 = 16, F0 = 256, K = 128 with F0 = 256); every
# ball one member (eff = 1) and every ball full (eff = K); N = 1 and N not
# a multiple of 32; F0 not a multiple of 8 and K not one of 16 (one bf16
# an access); F0 = 48 (6 lanes of 8 a row).
K5_CASES = ([(4, n, s, r, k, c) for n, s, r, k, c in SLICE_SCALES]
            + [(4, 256, 64, 0.4, 16, 16), (4, 256, 64, 0.4, 64, 256),
               (2, 1024, 128, 0.8, 128, 256), (4, 512, 128, 1e-4, 64, 64),
               (4, 512, 128, 100.0, 128, 128), (4, 1, 8, 0.4, 32, 64),
               (4, 100, 40, 0.4, 64, 32), (4, 200, 40, 0.5, 24, 20),
               (4, 256, 64, 0.4, 32, 48)])


def _assert_k5(cent, xyz, pf, qc, r, k):
    """z1 identical to the twin's; the sums within 1e-4 of the sums of
    their terms' magnitudes (and of the twin's norm); the same bits
    twice."""
    fs = fused_sa
    z1, s1, q1 = fs.sa_extract_cuda(cent, xyz, pf, qc, r, k)
    ref = fs.sa_extract_plain(cent, xyz, pf, qc, r, k)
    again = fs.sa_extract_cuda(cent, xyz, pf, qc, r, k)
    torch.cuda.synchronize()
    assert torch.equal(z1, ref[0])
    mag = ref[0].float().abs().sum((0, 1, 2))
    assert float(((s1 - ref[1]).abs() / (mag + 1e-30)).max()) <= 1e-4
    assert float(((q1 - ref[2]).abs() / (ref[2] + 1e-30)).max()) <= 1e-4
    assert _rel(s1, ref[1]) <= 1e-4 and _rel(q1, ref[2]) <= 1e-4
    assert torch.equal(s1, again[1]) and torch.equal(q1, again[2])
    assert torch.equal(z1, again[0])


@pytest.mark.parametrize("b,n,s,r,k,f0", K5_CASES)
def test_sa_extract_kernel_equals_plain(b, n, s, r, k, f0):
    """K5 on seeded points, on the same centroids with every other one
    moved 100 m away (empty balls), and on pf and qc that start 2 bytes
    past a 16-byte boundary (one bf16 an access)."""
    _need_cuda()
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(n + s + k + f0)
    xyz = (torch.randn(b, n, 3, generator=g) * 0.5).to(dev)
    cent = xyz[:, torch.arange(s) % n].contiguous()
    pf = torch.randn(b, n, f0, generator=g).to(dev).bfloat16()
    qc = torch.randn(b, s, f0, generator=g).to(dev).bfloat16()
    before = _build.LAUNCHES["sa_extract"]
    _assert_k5(cent, xyz, pf, qc, r, k)
    assert _build.LAUNCHES["sa_extract"] == before + 2
    far = cent.clone()
    far[:, ::2] += 100.0
    _assert_k5(far, xyz, pf, qc, r, k)
    off_pf = torch.empty(pf.numel() + 1, device=dev, dtype=pf.dtype)[1:]
    off_qc = torch.empty(qc.numel() + 1, device=dev, dtype=qc.dtype)[1:]
    off_pf.copy_(pf.reshape(-1))
    off_qc.copy_(qc.reshape(-1))
    _assert_k5(cent, xyz, off_pf.view(pf.shape), off_qc.view(qc.shape), r, k)


# The 8 grouped SA scales again, with their chains (N, S, radius, K, F0-F1-F2).
TRAIN_SCALES = [(1024, 128, 0.2, 32, (32, 32, 64)),
                (1024, 128, 0.4, 64, (64, 64, 128)),
                (1024, 128, 0.8, 128, (64, 96, 128)),
                (128, 32, 0.4, 64, (64, 64, 128)),
                (128, 32, 0.8, 64, (128, 128, 256)),
                (128, 32, 1.6, 128, (128, 128, 256)),
                (512, 128, 0.2, 64, (64, 64, 128)),
                (128, 32, 0.4, 64, (128, 128, 256))]


def _rel(got, ref):
    """Norm-wise relative error of an f32 sum against the twin's."""
    return float((got - ref).norm() / ref.norm().clamp_min(1e-30))


BWD_SUMS = ("sdy", "sdyx", "dw", "db")


def _assert_bwd_sums(got, ref, args):
    """K8's and K9's four sums within 1e-4 of the sums of their terms'
    magnitudes: the order of an f32 sum over up to 2 M rows, and the few
    dy_j values the two products round one bf16 step apart. Not relative
    to the sums themselves: db_j is zero in exact arithmetic in train
    mode."""
    mags = fused_sa.sa_bwd_sum_magnitudes(*args)
    for name, a, b_, mag in zip(BWD_SUMS, got, ref, mags):
        assert a.shape == b_.shape, name
        excess = float(((a - b_).abs() / (1e-4 * mag + 1e-30)).max())
        assert excess <= 1.0, (name, excess)


def _close_bf16(got, ref, share=0.99):
    g, r = got.float(), ref.float()
    assert (r != 0).float().mean() >= 0.05
    assert (g == r).float().mean() >= share
    assert (g - r).abs().max() <= 0.01 * r.abs().max()


def _train_case(n, s, k, dims, seed, dev, b=4, all_empty=False):
    g = torch.Generator().manual_seed(seed)
    xyz = (torch.randn(b, n, 3, generator=g) * 0.5).to(dev)
    cent = xyz[:, :s].clone()
    if all_empty:
        cent += 100.0
    else:
        cent[:, ::7] += 100.0  # empty balls
    pf = torch.randn(b, n, dims[0], generator=g).to(dev).bfloat16()
    qc = torch.randn(b, s, dims[0], generator=g).to(dev).bfloat16()
    _, ws, bs = _chain(g, dims, dev)
    gammas = [(torch.rand(f, generator=g) + 0.5).to(dev) for f in dims]
    gammas[-1][::5] *= -1.0  # channels whose pooled value comes from zmin
    betas = [(torch.randn(f, generator=g) * 0.2).to(dev) for f in dims]
    return g, cent, xyz, pf, qc, gammas, betas, ws, bs


@pytest.mark.parametrize("n,s,r,k,dims", TRAIN_SCALES)
def test_sa_train_kernels_equal_plain(n, s, r, k, dims):
    """K5-K9 against their plain twins, each on the twin's inputs, in the
    order of one training step at depth 3; then K8 below a stored dy, K9
    at the top (depth 2) and the eval forms."""
    _run_train_kernels(4, n, s, r, k, dims)


# K8's and K9's tiles at their edges: an odd centroid count, no multiple
# of the 2, 4 or 8 centroids of a tile; the smallest tile (K = 16,
# 16 <- 16 <- 16); a 96-wide layer on both sides of the products; 48 rows
# a centroid (96-row tiles); and no ball with a member. Each probe keeps
# some 10,000 rows or more: the four sums are held to 1e-4 of their terms'
# magnitudes, and over a few hundred rows a single dy_j that the two
# products round one bf16 step apart is more than that.
BWD_PROBES = [(3, 512, 313, 0.4, 32, (32, 32, 64), False),
              (3, 256, 157, 0.4, 64, (64, 64, 128), False),
              (5, 512, 313, 0.4, 16, (16, 16, 16), False),
              (3, 256, 85, 0.8, 128, (64, 96, 128), False),
              (3, 256, 157, 0.4, 48, (96, 96, 96), False),
              (3, 128, 31, 0.4, 128, (128, 128, 256), False),
              (3, 512, 313, 0.4, 32, (32, 32, 64), True)]


@pytest.mark.parametrize("b,n,s,r,k,dims,all_empty", BWD_PROBES)
def test_sa_bwd_kernels_at_the_tile_edges(b, n, s, r, k, dims, all_empty):
    _run_train_kernels(b, n, s, r, k, dims, all_empty)


def _run_train_kernels(b, n, s, r, k, dims, all_empty=False):
    _need_cuda()
    dev = torch.device("cuda")
    g, cent, xyz, pf, qc, gammas, betas, ws, bs = _train_case(
        n, s, k, dims, n + s + k + sum(dims), dev, b, all_empty)
    fs = fused_sa
    m = cent.shape[0] * s * k
    before = dict(_build.LAUNCHES)

    def pack(d, sums, sumsq, **kw):
        mu = sums / m
        return fs._make_pack(gammas[d], betas[d], mu, sumsq / m - mu * mu,
                             1e-3, **kw)

    # K5
    z0, s0, q0 = fs.sa_extract_plain(cent, xyz, pf, qc, r, k)
    got = fs.sa_extract(cent, xyz, pf, qc, r, k)
    assert torch.equal(got[0], z0)
    assert _rel(got[1], s0) <= 1e-4 and _rel(got[2], q0) <= 1e-4
    again = fs.sa_extract(cent, xyz, pf, qc, r, k)
    assert torch.equal(got[1], again[1]) and torch.equal(got[2], again[2])
    p0 = pack(0, s0, q0)
    # K6
    z1, s1, q1 = fs.sa_fwd_step_plain(z0, p0, ws[0], bs[0])
    got = fs.sa_fwd_step(z0, p0, ws[0], bs[0])
    _close_bf16(got[0], z1)
    assert _rel(got[1], s1) <= 1e-4 and _rel(got[2], q1) <= 1e-4
    p1 = pack(1, s1, q1)
    # K7
    z2, s2, q2, zmax, zmin = fs.sa_fwd_step_plain(z1, p1, ws[1], bs[1], True)
    got = fs.sa_fwd_step(z1, p1, ws[1], bs[1], True)
    _close_bf16(got[0], z2)
    assert _rel(got[1], s2) <= 1e-4 and _rel(got[2], q2) <= 1e-4
    assert torch.equal(got[3], got[0].float().amax(dim=2))
    assert torch.equal(got[4], got[0].float().amin(dim=2))
    assert (got[3] == zmax).float().mean() >= 0.99
    p2 = pack(2, s2, q2, mdy=torch.randn(dims[2], generator=g).to(dev) * 1e-3,
              mdyx=torch.randn(dims[2], generator=g).to(dev) * 1e-3)
    pooled = fs._pool_epilogue(zmax, zmin, p2)
    dpooled = torch.randn(pooled.shape, generator=g).to(dev).bfloat16()
    # K8 at the top
    for train in (True, False):
        ref = fs.sa_bwd_step_plain(train, True, z1, z2, (pooled, dpooled),
                                   p1, p2, ws[1])
        got = fs.sa_bwd_step(train, True, z1, z2, (pooled, dpooled), p1, p2,
                             ws[1])
        _close_bf16(got[0], ref[0])
        _assert_bwd_sums(got[1:], ref[1:], (train, True, z1, z2,
                                            (pooled, dpooled), p1, p2, ws[1]))
        again = fs.sa_bwd_step(train, True, z1, z2, (pooled, dpooled), p1,
                               p2, ws[1])
        assert all(torch.equal(a, b_) for a, b_ in zip(got, again))
        if train:
            dy1, sdy1, sdyx1 = ref[:3]
    # K8 below a stored dy (a layer of a deeper chain)
    dy2 = (torch.randn(z2.shape, generator=g) * 1e-2).to(dev).bfloat16()
    for train in (True, False):
        a = (train, False, z1, z2, dy2, p1, p2, ws[1])
        ref, got, again = (fs.sa_bwd_step_plain(*a), fs.sa_bwd_step(*a),
                           fs.sa_bwd_step(*a))
        _close_bf16(got[0], ref[0])
        _assert_bwd_sums(got[1:], ref[1:], a)
        assert all(torch.equal(x, y) for x, y in zip(got, again))
    p1b = pack(1, s1, q1, mdy=sdy1 / m, mdyx=sdyx1 / m)
    # K9 below a stored dy, and at the top of a depth-2 chain
    cases = [(True, False, z0, z1, dy1, p0, p1b, ws[0]),
             (False, False, z0, z1, dy1, p0, p1b, ws[0]),
             (True, True, z1, z2, (pooled, dpooled), p1, p2, ws[1]),
             (False, True, z1, z2, (pooled, dpooled), p1, p2, ws[1])]
    for train, top, zj, zj1, dy_src, pj, pj1, w in cases:
        f_j = zj.shape[-1]
        qcj = torch.randn(cent.shape[0], s, f_j, generator=g).to(
            dev).bfloat16()
        ref = fs.sa_bwd_step0_plain(train, top, zj, zj1, dy_src, cent, xyz,
                                    qcj, pj, pj1, w, r)
        got = fs.sa_bwd_step0(train, top, zj, zj1, dy_src, cent, xyz, qcj,
                              pj, pj1, w, r)
        _assert_bwd_sums(got[:4], ref[:4],
                         (train, top, zj, zj1, dy_src, pj, pj1, w))
        h_acc, mq, cnt, sdy_s, sz_s = got[4:]
        assert torch.equal(cnt, ref[6])
        # dy_0 never leaves the kernel. Its scattered sum may differ from
        # the twin's by one bf16 step (2^-7 relative) of every slot (the
        # roundings of dh one step apart; the repeats of a short ball's
        # member move together), and by the f32 sum order inside dh's
        # product: 1e-5 of the sum of that product's terms' magnitudes,
        # which matters where the terms cancel.
        dz = fs._step_dz_plain(train, top, zj1, dy_src, pj1)
        dy0 = fs.sa_bwd_step_plain(train, top, zj, zj1, dy_src, pj, pj1, w)[0]
        mag = torch.matmul(dz.float().abs(), w.bfloat16().float().abs().t())
        idx, _ = fs._slots(cent, xyz, r, k)
        scale = grouping.scatter_rows(idx, dy0.abs(), n, torch.float32)
        bound = scale / 128 + 1e-30 + 1e-5 * grouping.scatter_rows(
            idx, mag, n, torch.float32)
        excess = ((h_acc - ref[4]).abs() / bound).max()
        assert float(excess) <= 1.0, (train, top, float(excess))
        assert _rel(mq, ref[5]) <= 1e-5
        assert _rel(sdy_s, ref[7]) <= 1e-2 and _rel(sz_s, ref[8]) <= 1e-5
        again = fs.sa_bwd_step0(train, top, zj, zj1, dy_src, cent, xyz, qcj,
                                pj, pj1, w, r)
        assert all(torch.equal(a, b_) for a, b_ in zip(got, again))
        # H, Mq and cnt have one owner each: the twin's order of summation
        # over the kernel's own dy_0 (K8's body, launched uncounted), on
        # CPU copies, bit for bit
        dy_own = fs._bwd_launch("dy_0", False, train, top, zj, zj1, dy_src,
                                pj, pj1, w, None)[0]
        idx_c, count_c = fs._slots(cent.cpu(), xyz.cpu(), r, k)
        order = fs.step0_scatter_plain(idx_c, count_c, dy_own.cpu(),
                                       qcj.cpu(), n)
        assert all(torch.equal(a.cpu(), b_) for a, b_ in zip(got[4:7], order))
    torch.cuda.synchronize()
    after = _build.LAUNCHES
    assert after["sa_extract"] == before["sa_extract"] + 2
    assert after["sa_fwd_step"] == before["sa_fwd_step"] + 1
    assert after["sa_fwd_last"] == before["sa_fwd_last"] + 1
    assert after["sa_bwd_step"] == before["sa_bwd_step"] + 8
    assert after["sa_bwd_step0"] == before["sa_bwd_step0"] + 8


@pytest.mark.parametrize("b,s,k,f_in,f_out", [
    (3, 17, 128, 128, 256), (3, 17, 128, 128, 128), (3, 17, 128, 256, 256),
    (5, 313, 16, 16, 16), (3, 157, 16, 256, 256), (3, 61, 80, 16, 256)])
def test_sa_fwd_kernels_at_the_corners(b, s, k, f_in, f_out):
    """K6 and K7 alone: 128 rows of 128 -> 256 and 128 -> 128 (two and
    three ring stages), 256 -> 256 (W read through L2), the smallest tile
    (K = 16, 16 -> 16, 8 centroids), 80 rows a centroid; odd centroid
    counts leave a ragged last tile. z' within the limits, K7's extrema
    those of its own z', the sums within 1e-4 and the same bits twice."""
    _need_cuda()
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(b * s + k + f_in + f_out)
    z = torch.randn(b, s, k, f_in, generator=g)
    eff = torch.randint(1, k + 1, (b, s, 1), generator=g)
    slot = (torch.arange(k) % eff)[..., None]
    z = z.gather(2, slot.expand_as(z)).to(dev).bfloat16()  # rows repeat
    pack = fused_sa._make_pack(
        (torch.rand(f_in, generator=g) + 0.5).to(dev),
        (torch.randn(f_in, generator=g) * 0.2).to(dev),
        (torch.randn(f_in, generator=g) * 0.2).to(dev),
        (torch.rand(f_in, generator=g) + 0.5).to(dev), 1e-3)
    w = (torch.randn(f_in, f_out, generator=g) / f_in ** 0.5).to(dev)
    bias = (torch.randn(f_out, generator=g) * 0.1).to(dev)
    for last in (False, True):
        ref = fused_sa.sa_fwd_step_plain(z, pack, w, bias, last)
        got = fused_sa.sa_fwd_step_cuda(z, pack, w, bias, last)
        again = fused_sa.sa_fwd_step_cuda(z, pack, w, bias, last)
        torch.cuda.synchronize()
        _close_bf16(got[0], ref[0])
        assert _rel(got[1], ref[1]) <= 1e-4 and _rel(got[2], ref[2]) <= 1e-4
        assert all(torch.equal(a, b_) for a, b_ in zip(got, again))
        if last:
            assert torch.equal(got[3], got[0].float().amax(dim=2))
            assert torch.equal(got[4], got[0].float().amin(dim=2))


@pytest.mark.parametrize("n,s,r,k,dims", TRAIN_SCALES[2:5])
def test_sa_train_kernels_exact_on_integers(n, s, r, k, dims):
    """Integer-valued inputs, identity packs and weights in {-1, 0, 1}
    make every sum exact in f32 in any order: K5-K9 equal their twins."""
    _need_cuda()
    dev = torch.device("cuda")
    g, cent, xyz, *_ = _train_case(n, s, k, dims, 7, dev, b=1)
    fs = fused_sa

    def ints(lo, hi, *shape):
        return torch.randint(lo, hi + 1, shape, generator=g).to(dev)

    b = cent.shape[0]
    pf = ints(-4, 4, b, n, dims[0]).bfloat16()
    qc = ints(-2, 2, b, s, dims[0]).bfloat16()
    packs = [torch.zeros(6, f, device=dev) for f in dims]
    for p in packs:
        p[0] = 1.0
        p[3] = 1.0
    ws = [(ints(-1, 1, dims[i], dims[i + 1])
           * (torch.rand(dims[i], dims[i + 1], generator=g) < 0.1).to(dev))
          .float() for i in range(2)]
    bs = [ints(-1, 1, dims[i + 1]).float() for i in range(2)]
    ref0 = fs.sa_extract_plain(cent, xyz, pf, qc, r, k)
    got0 = fs.sa_extract(cent, xyz, pf, qc, r, k)
    ref1 = fs.sa_fwd_step_plain(ref0[0], packs[0], ws[0], bs[0])
    got1 = fs.sa_fwd_step(ref0[0], packs[0], ws[0], bs[0])
    ref2 = fs.sa_fwd_step_plain(ref1[0], packs[1], ws[1], bs[1], True)
    got2 = fs.sa_fwd_step(ref1[0], packs[1], ws[1], bs[1], True)
    dy2 = ints(-1, 1, *ref2[0].shape).bfloat16()
    ref3 = fs.sa_bwd_step_plain(False, False, ref1[0], ref2[0], dy2,
                                packs[1], packs[2], ws[1])
    got3 = fs.sa_bwd_step(False, False, ref1[0], ref2[0], dy2, packs[1],
                          packs[2], ws[1])
    ref4 = fs.sa_bwd_step0_plain(False, False, ref0[0], ref1[0], ref3[0],
                                 cent, xyz, qc, packs[0], packs[1], ws[0], r)
    got4 = fs.sa_bwd_step0(False, False, ref0[0], ref1[0], ref3[0], cent,
                           xyz, qc, packs[0], packs[1], ws[0], r)
    assert float(ref3[0].float().abs().max()) > 0
    for name, got, ref in (("K5", got0, ref0), ("K6", got1, ref1),
                           ("K7", got2, ref2), ("K8", got3, ref3),
                           ("K9", got4, ref4)):
        for i, (a, b_) in enumerate(zip(got, ref)):
            assert torch.equal(a, b_), (name, i)


def test_fused_chain_on_the_card_matches_the_cpu():
    """`fused_grouped_chain(train=True)` and its gradients: K5-K9 on the
    card against the plain twins on the CPU, same inputs."""
    _need_cuda()
    n, s, r, k, dims = 256, 32, 0.4, 32, (32, 48, 64)
    g, cent, xyz, pf, qc, gammas, betas, ws, bs = _train_case(
        n, s, k, dims, 11, torch.device("cpu"))
    wr = torch.randn(cent.shape[0], s, dims[-1], generator=g)
    outs = []
    for dev in ("cuda", "cpu"):
        leaves = [t.to(dev).requires_grad_() for t in
                  (pf, qc, *gammas, *betas, *ws, *bs)]
        d = len(dims)
        pooled, means, variances = fused_sa.fused_grouped_chain(
            cent.to(dev), xyz.to(dev), leaves[0], leaves[1],
            leaves[2:2 + d], leaves[2 + d:2 + 2 * d],
            leaves[2 + 2 * d:1 + 3 * d], leaves[1 + 3 * d:], r, k, 1e-3,
            True, None)
        (pooled.float() * wr.to(dev)).sum().backward()
        outs.append([pooled, *means, *variances]
                    + [t.grad for t in leaves])
    card, cpu = outs
    _close_bf16(card[0].cpu(), cpu[0], share=0.98)
    for a, b_ in zip(card[1:1 + 2 * len(dims)], cpu[1:1 + 2 * len(dims)]):
        torch.testing.assert_close(a.cpu(), b_, atol=2e-3, rtol=0)
    for a, b_ in zip(card[1 + 2 * len(dims):-2], cpu[1 + 2 * len(dims):-2]):
        assert _rel(a.float().cpu(), b_.float()) <= 0.05


def _ragged_v2(model):
    """F-PointNet v2 with two SA scales of shapes outside the v2 presets:
    the seg net's first scale groups K = 24 points (the unfused branch,
    K3/K4) and its second has an inner layer of 40 channels (K5-K9 with
    the widths padded to 48 on the card)."""
    from transferable3d_torch.models import pointnet2

    sa1 = model.seg_net.sa1
    dev = next(model.parameters()).device
    for i, (feats, k) in enumerate((((40, 40, 64), 24),
                                    ((64, 40, 128), 64))):
        old = getattr(sa1, f"mlp_{i}")
        setattr(sa1, f"mlp_{i}", pointnet2.GroupedPointMLP(
            old.cin - 3, feats, old.radius, k, dtype=old.dtype, device=dev,
            generator=torch.Generator().manual_seed(i)))


def test_ragged_v2_trains_a_step_on_the_card_as_on_the_cpu():
    """A bf16 v2 model with a K = 24 scale and a 40-wide layer trains one
    step on the card through the route `fused_route` pins (one scale
    rerouted to the unfused branch, the 40-wide one padded), against the
    CPU's step at phase 14's limits (`chip_smoke.FUSED_COS`, loss 2%),
    with the mask and the box net's input pinned as chip_smoke pins them."""
    _need_cuda()
    import chip_smoke
    from transferable3d_torch.core import bins
    from transferable3d_torch.models import registry
    from transferable3d_torch.train import schedules

    cfg = bins.SUNRGBD
    initial = registry.get_model(
        "frustum_pointnets_v2", cfg, dtype=torch.bfloat16, device="cuda",
        generator=torch.Generator().manual_seed(1))
    _ragged_v2(initial)
    b = chip_smoke.B
    one_step = chip_smoke.SmallStep(
        cfg, initial, chip_smoke.train_batch(cfg),
        schedules.exponential_staircase_lr(batch_size=b),
        schedules.bn_momentum_schedule(batch_size=b), 0,
        torch.device("cuda"), adapt=_ragged_v2)
    before = _build.LAUNCHES["fused_sa_rerouted"]
    on_card = one_step(torch.bfloat16, "cuda", True)
    assert _build.LAUNCHES["fused_sa_rerouted"] > before
    on_cpu = one_step(torch.bfloat16, "cpu", True)
    assert torch.equal(on_card[2], on_cpu[2])
    res = chip_smoke.compare(on_card, on_cpu)
    assert not chip_smoke.failed(res, chip_smoke.FUSED_COS), res


def test_sa_train_kernels_refuse_bad_inputs():
    _need_cuda()
    dev = torch.device("cuda")
    z = torch.zeros(2, 4, 16, 32, device=dev, dtype=torch.bfloat16)
    pack = torch.zeros(6, 32, device=dev)
    w, b = torch.zeros(32, 48, device=dev), torch.zeros(48, device=dev)
    bad = [(z.float(), pack, w, b), (z[:, :, :8], pack, w, b),
           (z, pack[:5], w, b), (z, pack, w[:, :40].contiguous(), b[:40]),
           (z.cpu(), pack, w, b), (z, pack, w.t(), b)]
    for a in bad:
        with pytest.raises(ValueError):
            fused_sa.sa_fwd_step_cuda(*a)
    z1 = torch.zeros(2, 4, 16, 48, device=dev, dtype=torch.bfloat16)
    pack1 = torch.zeros(6, 48, device=dev)
    with pytest.raises(ValueError):
        fused_sa.sa_bwd_step_cuda(True, False, z, z1, z1.float(), pack,
                                  pack1, w)
    with pytest.raises(ValueError):
        fused_sa.sa_extract_cuda(torch.zeros(2, 4, 3, device=dev),
                                 torch.zeros(2, 64, 3, device=dev),
                                 torch.zeros(2, 64, 32, device=dev),
                                 z[:, :, 0].contiguous(), 0.4, 16)


# K15's cases: (kind, F, MB, N, C, npoints). Random masks at the e2e
# shapes (96x128 and 480x640 at 128 frustums), at 530x730 (a ragged last
# word, 4-byte loads), N below 32 (4-byte and 1-byte loads), N a multiple
# of 32, and the largest N the plan takes (the most shared memory); every
# point in or none; one block's span without an in-box point; in-box
# points only in the first word of each block's span, so that every rank
# falls on a block's first word; a mask that starts off a 16-byte
# boundary (1-byte loads).
FETCH_CASES = [
    ("random", 3, 4, 12288, 3, 1024), ("random", 2, 2, 20000, 4, 1000),
    ("random", 1, 3, 307200, 3, 2048), ("random", 2, 5, 100, 3, 64),
    ("random", 32, 4, 12288, 3, 1024), ("random", 32, 4, 307200, 3, 1024),
    ("random", 2, 4, 386900, 3, 1024), ("random", 2, 3, 20, 3, 64),
    ("random", 1, 2, 5, 3, 16), ("random", 2, 3, 4096, 3, 256),
    ("random", 1, 1, frustum_jit.FETCH_MAX_POINTS, 3, 1024),
    ("all_in", 2, 4, 307200, 3, 1024), ("all_in", 3, 4, 12288, 3, 1024),
    ("all_out", 2, 4, 307200, 3, 1024), ("empty_span", 2, 4, 307200, 3, 1024),
    ("empty_span", 32, 4, 307200, 3, 1024),
    ("first_words", 2, 4, 307200, 3, 1024),
    ("first_words", 2, 4, 386900, 3, 1024),
    ("unaligned", 2, 4, 307200, 3, 1024)]


def _fetch_mask(kind, f, mb, n, g):
    plan = frustum_jit.fetch_select_plan(n, f * mb)
    span = plan.span * 32                      # points a block owns
    if kind == "all_in":
        return torch.ones(f, mb, n, dtype=torch.bool)
    if kind == "all_out":
        return torch.zeros(f, mb, n, dtype=torch.bool)
    inside = torch.rand(f, mb, n, generator=g) < 0.3
    if kind == "empty_span":
        assert plan.group > 1
        inside[..., span:2 * span] = False
    elif kind == "first_words":
        assert plan.group > 1
        first = torch.zeros(n, dtype=torch.bool)
        for lo in range(0, n, span):
            first[lo:lo + 32] = True
        inside &= first
    return inside


@pytest.mark.parametrize("kind,f,mb,n,c,npoints", FETCH_CASES)
def test_fetch_select_kernel_equals_plain(kind, f, mb, n, c, npoints):
    """K15 is a rank search and a gather: identical to its twin, empty
    and short frustums included, and the same bits on a second run."""
    _need_cuda()
    g = torch.Generator().manual_seed(f * n + npoints)
    pts = (torch.rand(f, n, c, generator=g) * 8 - 4).cuda()
    inside = _fetch_mask(kind, f, mb, n, g)
    if kind == "random":
        inside[0, 0] = False                   # an empty frustum
        inside[0, 1 % mb, 17:] = False         # fewer points than slots
    if kind == "unaligned":
        buf = torch.zeros(inside.numel() + 1, dtype=torch.bool,
                          device="cuda")
        buf[1:] = inside.reshape(-1).cuda()
        inside = buf[1:].view(f, mb, n)
        assert inside.is_contiguous() and inside.data_ptr() % 16 != 0
    inside = inside.cuda()
    u = torch.rand(f, mb, generator=g).cuda()
    u[0, -1] = 0.0
    before = _build.LAUNCHES["fetch_select"]
    got = frustum_jit.fetch_select(pts, inside, u, npoints)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["fetch_select"] == before + 1
    again = frustum_jit.fetch_select(pts, inside, u, npoints)
    ref = frustum_jit.fetch_select_plain(pts, inside, u, npoints)
    torch.cuda.synchronize()
    for a, b, r in zip(got, again, ref):
        assert torch.equal(a, b) and torch.equal(a, r)
    count = inside.sum(-1, dtype=torch.int32)
    assert torch.equal(got[2], count)
    if kind in ("random", "all_out"):
        assert (got[1][0, 0] == -1).all() and (got[0][0, 0] == 0).all()
        assert got[2][0, 0] == 0
    if kind == "all_in":
        want = frustum_jit.want_ranks(u, count.float(), npoints)
        assert torch.equal(got[1], want.int() - 1)
    if kind == "first_words":
        span = frustum_jit.fetch_select_plan(n, f * mb).span * 32
        assert bool(((got[1] % span) < 32).all())


def test_fetch_select_kernel_refuses_bad_inputs():
    _need_cuda()
    pts = torch.zeros(1, 64, 3).cuda()
    inside = torch.zeros(1, 2, 64, dtype=torch.bool).cuda()
    u = torch.zeros(1, 2).cuda()
    for bad in ((pts.cpu(), inside, u),                        # wrong device
                (pts.transpose(1, 2).contiguous().transpose(1, 2), inside,
                 u),                                           # strided
                (pts.double(), inside, u)):                    # wrong type
        with pytest.raises(ValueError):
            frustum_jit.fetch_select_cuda(*bad, 16)
