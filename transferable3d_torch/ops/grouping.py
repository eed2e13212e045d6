"""Ball-query grouping: plain PyTorch gathers, and CUDA kernels K3/K4.

Port of `transferable3d_tpu/ops/grouping.py`. The XLA half: the
expanded-form `pairwise_sqdist`, the classic `ball_query` (first hit
repeated past the count), and the one-hot grouping `ball_query_group` /
`grouped_payload` (cyclic repetition past the count), all with the
nearest point standing in for an empty ball. On the TPU the one-hot
selection is an MXU contraction; here it is a gather, which is exact,
and its backward sums the cotangent in f32 and rounds once, as the JAX
custom VJP does.

The Pallas half, `ball_query_extract` (`_extract_fwd_kernel`,
`_extract_bwd_kernel`), becomes `BallQueryExtract`: kernel K3 gathers the
payload rows and kernel K4 scatter-adds their cotangent back
(csrc/ball_extract.cu), with the plain twins `extract_fwd_plain` and
`extract_bwd_plain`. Both select with the direct-form distance of the
TPU kernel, ((0 + dx*dx) + dy*dy) + dz*dz with dx = c - p, so the twins
match the kernels at the radius boundary. `grouped_payload` takes them
for a bf16 payload on CUDA, as the JAX package takes the kernel only for
bf16 on the TPU; CPU tensors keep the expanded-form gather of the JAX
package's CPU path (the two forms can differ at the radius boundary).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from transferable3d_torch.ops import _build

# csrc/ball_extract.cu keeps the K selected indices of one centroid in
# shared memory (4 bytes each, within the default 48 KB).
EXTRACT_MAX_K = 4096


def radius_sq(radius: float) -> float:
    """float32(radius * radius), the product taken in double as the
    JAX code's Python-level `radius * radius` is."""
    return float(np.float32(radius * radius))


def pairwise_sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[B, S, 3] x [B, N, 3] -> squared distances [B, S, N], expanded
    form |a|^2 + |b|^2 - 2 a.b clamped at 0 (grouping.py:25-35)."""
    cross = torch.einsum("bsc,bnc->bsn", a, b)
    na = torch.sum(a * a, dim=-1)[:, :, None]
    nb = torch.sum(b * b, dim=-1)[:, None, :]
    return torch.clamp_min(na + nb - 2 * cross, 0.0)


def direct_sqdist(cent: torch.Tensor, xyz: torch.Tensor) -> torch.Tensor:
    """[B, S, 3] x [B, N, 3] -> squared distances [B, S, N] in the direct
    form of the TPU kernels, ((0 + dx*dx) + dy*dy) + dz*dz, dx = c - p."""
    d2 = None
    for i in range(3):
        diff = cent[:, :, None, i] - xyz[:, None, :, i]
        d2 = diff * diff if d2 is None else d2 + diff * diff
    return d2


def select_slots(within: torch.Tensor, d2: torch.Tensor, nsample: int,
                 cyclic: bool = True
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Slot indices [B, S, K] (int64) and true in-radius counts [B, S].

    The in-radius points of a centroid, in index order, have ranks
    1..count. With eff = clip(count, 1, K), slot k takes rank
    (k mod eff) + 1 when `cyclic`, else rank k + 1 below eff and rank 1
    past it. An empty ball takes its nearest point (lowest index on
    ties) in every slot.
    """
    rank = torch.cumsum(within.to(torch.int32), dim=-1, dtype=torch.int32)
    count = rank[..., -1]
    eff = torch.clamp(count, 1, nsample)[..., None]
    slot = torch.arange(nsample, dtype=torch.int32, device=d2.device)
    if cyclic:
        want = torch.remainder(slot, eff) + 1
    else:
        want = torch.where(slot < eff, slot + 1, 1)
    # rank steps by one exactly at in-radius points, so the first
    # position whose rank reaches `want` is the want-th in-radius point.
    idx = torch.searchsorted(rank.contiguous(), want.contiguous())
    nearest = torch.argmin(d2, dim=-1)[..., None]
    idx = torch.where(count[..., None] == 0, nearest, idx)
    return idx, count


def ball_query(centroids: torch.Tensor, xyz: torch.Tensor, radius: float,
               nsample: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Indices [B, S, nsample] int32 of the first in-radius points by
    index, the first hit repeated past the count, the nearest point for
    an empty ball; plus the in-radius count [B, S] int32."""
    d2 = pairwise_sqdist(centroids, xyz)
    idx, count = select_slots(d2 <= radius_sq(radius), d2, nsample,
                              cyclic=False)
    return idx.to(torch.int32), count


def flat_row_gather(points: torch.Tensor, idx: torch.Tensor
                    ) -> torch.Tensor:
    """Gather rows of points [B, N, C] at idx [B, ...] -> [B, ..., C]."""
    b, n, c = points.shape
    offsets = torch.arange(b, device=idx.device, dtype=torch.long) * n
    flat = (idx.reshape(b, -1).long() + offsets[:, None]).reshape(-1)
    return points.reshape(b * n, c)[flat].reshape(*idx.shape, c)


def scatter_rows(idx: torch.Tensor, dg: torch.Tensor, n: int,
                 dtype: torch.dtype) -> torch.Tensor:
    """The transpose of `flat_row_gather`: rows dg [B, ..., C] summed
    onto [B, n, C] at idx [B, ...], in f32 and rounded to `dtype` once,
    as the JAX package's one-hot VJP (`_onehot_select_bwd`) and kernel
    K4 sum."""
    b, c = dg.shape[0], dg.shape[-1]
    offsets = torch.arange(b, device=idx.device) * n
    flat = (idx.reshape(b, -1).long() + offsets[:, None]).reshape(-1)
    acc = torch.zeros(b * n, c, dtype=torch.float32, device=dg.device)
    acc.index_add_(0, flat, dg.to(dtype).float().reshape(-1, c))
    return acc.reshape(b, n, c).to(dtype)


class _SlotGather(torch.autograd.Function):
    """`flat_row_gather` whose backward is `scatter_rows`. Autograd of the
    plain gather would accumulate a bf16 cotangent in bf16, rounding at
    every add."""

    @staticmethod
    def forward(ctx, src, idx):
        ctx.save_for_backward(idx)
        ctx.n = src.shape[1]
        return flat_row_gather(src, idx)

    @staticmethod
    def backward(ctx, dg):
        idx, = ctx.saved_tensors
        return scatter_rows(idx, dg, ctx.n, dg.dtype), None


def group_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """points [B, N, C], idx [B, S, K] -> grouped [B, S, K, C]."""
    return flat_row_gather(points, idx)


def ball_query_group(centroids: torch.Tensor, xyz: torch.Tensor,
                     features: Optional[torch.Tensor], radius: float,
                     nsample: int, include_xyz: bool = True
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Grouped rows [B, S, K, C] (raw xyz first when `include_xyz`) with
    cyclic repetition past the count, and the true count [B, S]. The
    gradient of the rows is summed in f32 and rounded once."""
    if include_xyz:
        src = (xyz if features is None
               else torch.cat([xyz, features.to(xyz.dtype)], dim=-1))
    else:
        src = features
    d2 = pairwise_sqdist(centroids, xyz)
    idx, count = select_slots(d2 <= radius_sq(radius), d2, nsample)
    return _SlotGather.apply(src, idx), count


def grouped_payload(centroids: torch.Tensor, xyz: torch.Tensor,
                    payload: torch.Tensor, radius: float, nsample: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Grouped payload rows [B, S, K, C] (no xyz channels) and the true
    count [B, S]: kernels K3/K4 for a bf16 payload on CUDA, the
    expanded-form gather otherwise."""
    if payload.device.type == "cuda" and payload.dtype == torch.bfloat16:
        return ball_query_extract(centroids, xyz, payload, radius, nsample)
    return ball_query_group(centroids, xyz, payload, radius, nsample,
                            include_xyz=False)


def _extract_slots(cent, xyz, radius: float, nsample: int):
    d2 = direct_sqdist(cent, xyz)
    return select_slots(d2 <= radius_sq(radius), d2, nsample)


def extract_fwd_plain(cent: torch.Tensor, xyz: torch.Tensor,
                      payload: torch.Tensor, radius: float, nsample: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of K3: grouped rows [B, S, K, C] and counts [B, S]
    int32, as the JAX `ball_query_extract` forward."""
    idx, count = _extract_slots(cent, xyz, radius, nsample)
    return flat_row_gather(payload, idx), count


def extract_bwd_plain(cent: torch.Tensor, xyz: torch.Tensor,
                      dg: torch.Tensor, radius: float, nsample: int,
                      n: int, dtype=torch.bfloat16) -> torch.Tensor:
    """Plain twin of K4: dpay [B, N, C] in `dtype`, the sum over every
    slot of its cotangent rounded to `dtype`, taken in f32 and rounded
    once (`_extract_bwd_kernel`)."""
    idx, _ = _extract_slots(cent, xyz, radius, nsample)
    return scatter_rows(idx, dg, n, dtype)


def _check_extract_args(what, cent, xyz, other, other_name, other_shape,
                        nsample):
    dev = cent.device
    if dev.type != "cuda":
        raise ValueError(f"{what} needs CUDA tensors, got {dev}")
    for name, t, dt, shape in (
            ("cent", cent, torch.float32, (other_shape[0], cent.shape[1], 3)),
            ("xyz", xyz, torch.float32, (other_shape[0], xyz.shape[1], 3)),
            (other_name, other, torch.bfloat16, other_shape)):
        if (t.device != dev or t.dtype != dt or t.dim() != len(shape)
                or tuple(t.shape) != tuple(shape)):
            raise ValueError(
                f"{what}: {name} must be {dt} {tuple(shape)} on {dev}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    b, s, n = other_shape[0], cent.shape[1], xyz.shape[1]
    if (min(b, s, n, nsample, other_shape[-1]) < 1 or b > 65535
            or nsample > EXTRACT_MAX_K):
        raise ValueError(f"{what}: unsupported B={b} S={s} N={n} "
                         f"K={nsample} C={other_shape[-1]}")


def extract_fwd_cuda(cent: torch.Tensor, xyz: torch.Tensor,
                     payload: torch.Tensor, radius: float, nsample: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K3 on the current stream: cent [B, S, 3] f32, xyz
    [B, N, 3] f32, payload [B, N, C] bf16, all contiguous on one card.
    Raises on anything else; never falls back to the plain twin."""
    if payload.dim() != 3:
        raise ValueError("extract_fwd_cuda: payload must be [B, N, C]")
    b, n, c = payload.shape
    _check_extract_args("extract_fwd_cuda", cent, xyz, payload, "payload",
                        (b, xyz.shape[1] if xyz.dim() == 3 else -1, c),
                        nsample)
    s = cent.shape[1]
    lib = _build.library()
    out = torch.empty(b, s, nsample, c, dtype=torch.bfloat16,
                      device=payload.device)
    count = torch.empty(b, s, dtype=torch.int32, device=payload.device)
    with torch.cuda.device(payload.device):
        code = lib.t3d_extract_fwd(
            cent.data_ptr(), xyz.data_ptr(), payload.data_ptr(),
            out.data_ptr(), count.data_ptr(), b, s, n, nsample, c,
            radius_sq(radius), _build.stream_ptr(payload.device))
    _build.check(code, "t3d_extract_fwd")
    _build.LAUNCHES["extract_fwd"] += 1
    return out, count


def extract_bwd_cuda(cent: torch.Tensor, xyz: torch.Tensor,
                     dg: torch.Tensor, radius: float, nsample: int
                     ) -> torch.Tensor:
    """Launch K4 (scatter-add into a zeroed f32 workspace, then one
    rounding pass) on the current stream: dg [B, S, K, C] bf16
    contiguous -> dpay [B, N, C] bf16. Raises on anything else."""
    if dg.dim() != 4:
        raise ValueError("extract_bwd_cuda: dg must be [B, S, K, C]")
    b, s, _, c = dg.shape
    _check_extract_args("extract_bwd_cuda", cent, xyz, dg, "dg",
                        (b, s, nsample, c), nsample)
    n = xyz.shape[1]
    lib = _build.library()
    acc = torch.zeros(b, n, c, dtype=torch.float32, device=dg.device)
    dpay = torch.empty(b, n, c, dtype=torch.bfloat16, device=dg.device)
    with torch.cuda.device(dg.device):
        code = lib.t3d_extract_bwd(
            cent.data_ptr(), xyz.data_ptr(), dg.data_ptr(), acc.data_ptr(),
            dpay.data_ptr(), b, s, n, nsample, c, radius_sq(radius),
            _build.stream_ptr(dg.device))
    _build.check(code, "t3d_extract_bwd")
    _build.LAUNCHES["extract_bwd"] += 1
    return dpay


class BallQueryExtract(torch.autograd.Function):
    """`ball_query_extract` with its custom VJP: K3 forward, K4 backward
    on CUDA tensors, the plain twins on CPU tensors. Differentiable in
    the payload only: the selection is discrete, so centroids and xyz
    get no gradient."""

    @staticmethod
    def forward(ctx, cent, xyz, payload, radius, nsample):
        if payload.device.type == "cpu":
            grouped, count = extract_fwd_plain(cent, xyz, payload, radius,
                                               nsample)
        else:
            grouped, count = extract_fwd_cuda(cent, xyz, payload, radius,
                                              nsample)
        ctx.save_for_backward(cent, xyz)
        ctx.radius, ctx.nsample = radius, nsample
        ctx.pay_dtype = payload.dtype
        ctx.mark_non_differentiable(count)
        return grouped, count

    @staticmethod
    def backward(ctx, dg, _dcount):
        cent, xyz = ctx.saved_tensors
        if dg.device.type == "cpu":
            dpay = extract_bwd_plain(cent, xyz, dg, ctx.radius, ctx.nsample,
                                     xyz.shape[1], ctx.pay_dtype)
        else:
            dpay = extract_bwd_cuda(cent, xyz,
                                    dg.to(ctx.pay_dtype).contiguous(),
                                    ctx.radius, ctx.nsample)
        return None, None, dpay, None, None


def ball_query_extract(cent: torch.Tensor, xyz: torch.Tensor,
                       payload: torch.Tensor, radius: float, nsample: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused ball query + payload-row extraction -> (grouped [B, S, K, C]
    in the payload's dtype, count [B, S] int32); the payload gradient
    is the scatter-add of the grouped cotangent (f32 sums, one rounding).
    CPU tensors take the plain twins; CUDA tensors take K3/K4 and must
    be contiguous f32 coordinates and a bf16 payload."""
    return BallQueryExtract.apply(cent.detach(), xyz.detach(), payload,
                                  radius, nsample)
