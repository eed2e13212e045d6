"""Card-only checks of the port's CUDA kernels against their plain twins.

Marked `cuda`; each test skips without a CUDA card. This file imports no
JAX, so it also runs on the card's machine, which has none:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(`--noconftest` because tests/conftest.py configures JAX.)
chip_smoke.py runs the same comparisons at the full serving shapes.
"""

import pytest
import torch

from transferable3d_torch.ops import _build, fused_sa, sampling

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
