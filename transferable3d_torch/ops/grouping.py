"""Ball-query grouping as plain PyTorch gathers.

Port of the XLA half of `transferable3d_tpu/ops/grouping.py`: the
expanded-form `pairwise_sqdist`, the classic `ball_query` (first hit
repeated past the count), and the one-hot grouping
`ball_query_group` / `grouped_payload` (cyclic repetition past the
count), all with the nearest point standing in for an empty ball. On the
TPU the one-hot selection is an MXU contraction; here it is a gather,
which is exact. The Pallas extraction kernels (`_extract_fwd_kernel`,
`_extract_bwd_kernel`) serve only the non-default `T3D_FUSED_SA=0` path
and training, and are not ported yet (ROADMAP queue B).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


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


def group_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """points [B, N, C], idx [B, S, K] -> grouped [B, S, K, C]."""
    return flat_row_gather(points, idx)


def ball_query_group(centroids: torch.Tensor, xyz: torch.Tensor,
                     features: Optional[torch.Tensor], radius: float,
                     nsample: int, include_xyz: bool = True
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Grouped rows [B, S, K, C] (raw xyz first when `include_xyz`) with
    cyclic repetition past the count, and the true count [B, S]."""
    if include_xyz:
        src = (xyz if features is None
               else torch.cat([xyz, features.to(xyz.dtype)], dim=-1))
    else:
        src = features
    d2 = pairwise_sqdist(centroids, xyz)
    idx, count = select_slots(d2 <= radius_sq(radius), d2, nsample)
    return flat_row_gather(src, idx), count


def grouped_payload(centroids: torch.Tensor, xyz: torch.Tensor,
                    payload: torch.Tensor, radius: float, nsample: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Grouped payload rows [B, S, K, C] (no xyz channels)."""
    return ball_query_group(centroids, xyz, payload, radius, nsample,
                            include_xyz=False)
