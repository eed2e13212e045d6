"""Card-only checks of the port's CUDA kernels against their plain twins.

Marked `cuda`; each test skips without a CUDA card. This file imports no
JAX, so it also runs on the card's machine, which has none:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(`--noconftest` because tests/conftest.py configures JAX.)
chip_smoke.py runs the same comparisons at the full serving shapes.
"""

import pytest
import torch

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


def _bf16_ulp(x):
    """One bf16 unit in the last place of each value of x (float32)."""
    return torch.ldexp(torch.ones_like(x), torch.frexp(x).exponent - 8)


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
    want = grouping.extract_bwd_plain(cent, xyz, dg, r, k, n).float()
    have = pay.grad.float()
    scale = grouping.extract_bwd_plain(cent, xyz, dg.abs(), r, k, n,
                                       torch.float32)
    assert (have == want).float().mean() >= 0.999
    assert bool(((have - want).abs() <= _bf16_ulp(scale)).all())
    dgi = torch.randint(-4, 5, got.shape, generator=g).to(dev).bfloat16()
    assert torch.equal(grouping.extract_bwd_cuda(cent, xyz, dgi, r, k),
                       grouping.extract_bwd_plain(cent, xyz, dgi, r, k, n))


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
