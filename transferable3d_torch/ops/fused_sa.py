"""Fused set-abstraction inference: CUDA kernel K2 (csrc/sa_infer.cu) +
plain twin.

Port of the eval half of `transferable3d_tpu/ops/fused_sa.py`. One SA
scale is: ball query around each centroid (direct-form squared
distance, first K in-radius points by index, cyclic repetition past the
count, the nearest point for an empty ball), then
z1 = bf16(pf[sel] - qc), then for each layer
h = relu(bf16(z * a + c)) and, between layers, z' = bf16(h @ bf16(W) + b)
with float32 accumulation, then the max of the last h over the K slots.
`a` and `c` come from the f32 [6, F] pack of `_make_pack` built from the
BN running statistics. Only `pooled` [B, S, F_last] bf16 leaves the
kernel. The TPU's one-hot MXU selection, lane prefix sums, the `+0.25`
reciprocal bias and the planar layout are TPU workarounds and are not
carried over: a gather is exact on the card.

Training (the multi-pass exact-BN forward and its backward kernels)
is not ported yet: `fused_grouped_chain(train=True)` raises.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from transferable3d_torch.ops import _build
from transferable3d_torch.ops.grouping import (flat_row_gather, radius_sq,
                                               select_slots)

# csrc/sa_infer.cu: threads per block, max chain depth, and the shared
# memory one block may use on an H100 (227 KB).
_THREADS = 256
_MAX_DEPTH = 6
_SMEM_LIMIT = 232448


def _make_pack(gamma, beta, mu, var, eps):
    """f32 [6, F], the JAX pack layout: a = gamma * rsqrt(var + eps),
    c = beta - mu * a, mu, rsqrt(var + eps), and the two rows the
    training backward fills (zero here). The kernel reads rows 0-1."""
    r = torch.rsqrt(var + eps)
    a = gamma * r
    c = beta - mu * a
    z = torch.zeros_like(a)
    return torch.stack([a, c, mu, r, z, z]).float()


def sa_infer_plain(cent, xyz, pf, qc, radius: float, nsample: int,
                   packs: Sequence[torch.Tensor], ws: Sequence[torch.Tensor],
                   bs: Sequence[torch.Tensor]) -> torch.Tensor:
    """Plain PyTorch twin of K2, with the rounding sites of the JAX
    `_infer_kernel` (`_rank_rows`, `_chain_all`, fused_sa.py:118-179)."""
    d2 = None
    for i in range(3):
        diff = cent[:, :, None, i] - xyz[:, None, :, i]  # [B, S, N]
        d2 = diff * diff if d2 is None else d2 + diff * diff
    idx, _ = select_slots(d2 <= radius_sq(radius), d2, nsample)
    g = flat_row_gather(pf, idx)                          # [B, S, K, F0]
    z = (g.float() - qc.float()[:, :, None, :]).to(torch.bfloat16)
    h = None
    for i, pack in enumerate(packs):
        y = (z.float() * pack[0] + pack[1]).to(torch.bfloat16)
        h = torch.clamp_min(y, 0)
        if i < len(ws):
            w = ws[i].to(torch.bfloat16).float()
            z = (torch.matmul(h.float(), w) + bs[i]).to(torch.bfloat16)
    return h.amax(dim=2)


def _flat_params(packs, ws, bs) -> torch.Tensor:
    """The kernel's parameter block: for each layer d, a_d and c_d, then
    (between layers) bf16-rounded W_d [F_d, F_d+1] row-major and b_d."""
    parts = []
    for d, pack in enumerate(packs):
        parts += [pack[0], pack[1]]
        if d < len(ws):
            parts += [ws[d].to(torch.bfloat16).float().reshape(-1),
                      bs[d].float()]
    return torch.cat(parts).contiguous()


def sa_infer_smem_bytes(nsample: int, dims: Sequence[int]) -> int:
    """Dynamic shared memory of one K2 block (mirrors sa_infer.cu)."""
    head = (nsample + 3 * (_THREADS // 32)) * 4
    head = (head + 15) // 16 * 16
    return head + 2 * nsample * max(dims) * 2


def sa_infer_cuda(cent, xyz, pf, qc, radius: float, nsample: int,
                  packs, ws, bs) -> torch.Tensor:
    """Launch K2 on the current stream. Raises on anything it does not
    take; never falls back to the plain twin."""
    dev = cent.device
    if dev.type != "cuda":
        raise ValueError(f"sa_infer_cuda needs CUDA tensors, got {dev}")
    b, s, _ = cent.shape
    n = xyz.shape[1]
    f0 = pf.shape[-1]
    depth = len(packs)
    dims = [p.shape[-1] for p in packs]
    expect = {
        "cent": (cent, torch.float32, (b, s, 3)),
        "xyz": (xyz, torch.float32, (b, n, 3)),
        "pf": (pf, torch.bfloat16, (b, n, f0)),
        "qc": (qc, torch.bfloat16, (b, s, f0)),
    }
    for d in range(depth):
        expect[f"packs[{d}]"] = (packs[d], torch.float32, (6, dims[d]))
        if d < depth - 1:
            expect[f"ws[{d}]"] = (ws[d], torch.float32,
                                  (dims[d], dims[d + 1]))
            expect[f"bs[{d}]"] = (bs[d], torch.float32, (dims[d + 1],))
    for name, (t, dt, shape) in expect.items():
        if t.device != dev or t.dtype != dt or tuple(t.shape) != shape:
            raise ValueError(
                f"sa_infer_cuda: {name} must be {dt} {shape} on {dev}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"sa_infer_cuda: {name} must be contiguous")
    if len(ws) != depth - 1 or len(bs) != depth - 1:
        raise ValueError("sa_infer_cuda: need depth-1 Dense layers")
    if not 2 <= depth <= _MAX_DEPTH or dims[0] != f0:
        raise ValueError(f"sa_infer_cuda: unsupported chain {dims}, F0={f0}")
    if min(b, s, n, nsample) < 1 or b > 65535:
        raise ValueError(f"sa_infer_cuda: unsupported B={b} S={s} N={n} "
                         f"K={nsample}")
    smem = sa_infer_smem_bytes(nsample, dims)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"sa_infer_cuda: K={nsample} x F={max(dims)} needs "
                         f"{smem} B of shared memory (> {_SMEM_LIMIT})")
    lib = _build.library()
    params = _flat_params(packs, ws, bs)
    pooled = torch.empty(b, s, dims[-1], dtype=torch.bfloat16, device=dev)
    dims_c = (ctypes.c_int * depth)(*dims)
    with torch.cuda.device(dev):
        code = lib.t3d_sa_infer(
            cent.data_ptr(), xyz.data_ptr(), pf.data_ptr(), qc.data_ptr(),
            params.data_ptr(), pooled.data_ptr(), b, s, n, nsample, depth,
            ctypes.addressof(dims_c), radius_sq(radius),
            _build.stream_ptr(dev))
    _build.check(code, "t3d_sa_infer")
    _build.LAUNCHES["sa_infer"] += 1
    return pooled


def sa_infer(cent, xyz, pf, qc, radius: float, nsample: int, packs, ws,
             bs) -> torch.Tensor:
    """One eval-mode SA scale -> pooled [B, S, F_last] bf16. CPU tensors
    take the plain twin; CUDA tensors take K2."""
    if cent.device.type == "cpu":
        return sa_infer_plain(cent, xyz, pf, qc, radius, nsample, packs,
                              ws, bs)
    return sa_infer_cuda(cent, xyz, pf, qc, radius, nsample, packs, ws, bs)


def fused_grouped_chain(new_xyz, xyz, pf, qc, gammas, betas, ws, bs,
                        radius: float, nsample: int, eps: float,
                        train: bool, running
                        ) -> Tuple[torch.Tensor, tuple, tuple]:
    """Fused ball query + grouped MLP chain + max-pool (one SA scale).

    Args as `transferable3d_tpu.ops.fused_sa.fused_grouped_chain` minus
    the TPU-only `interpret`/`layout`: new_xyz [B,S,3] f32, xyz [B,N,3]
    f32, pf [B,N,F0] bf16 (dense_0 on all points), qc [B,S,F0] bf16
    (dense_0's kernel on the centroids), BN gammas/betas per layer,
    Dense ws/bs of layers 1..L-1, running ((mean, var), ...).

    Returns (pooled [B,S,F_last] bf16, means, variances).
    """
    if train:
        raise NotImplementedError(
            "fused_grouped_chain(train=True): the training kernels "
            "(fused_sa K5-K9) are not ported yet (ROADMAP queue B, B3 "
            "steps 1-5)")
    depth = len(gammas)
    if depth < 2:
        raise ValueError("fused_grouped_chain requires chain depth >= 2")
    if pf.dtype != torch.bfloat16 or qc.dtype != torch.bfloat16:
        raise ValueError(f"pf and qc must be bfloat16, got {pf.dtype}, "
                         f"{qc.dtype}")
    packs = [_make_pack(gammas[d], betas[d], running[d][0], running[d][1],
                        eps) for d in range(depth)]
    pooled = sa_infer(new_xyz.contiguous(), xyz.contiguous(),
                      pf.contiguous(), qc.contiguous(), radius, nsample,
                      packs, [w.contiguous() for w in ws], list(bs))
    means = tuple(r[0] for r in running)
    variances = tuple(r[1] for r in running)
    return pooled, means, variances
