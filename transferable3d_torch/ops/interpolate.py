"""3-NN inverse-squared-distance interpolation as plain PyTorch gathers.

Port of `transferable3d_tpu/ops/interpolate.py` (no Pallas there): the
three nearest support points are picked on the expanded-form distance
matrix (first index on ties, index 0 repeated when there are fewer than
three), their squared distances are recomputed in direct form, and the
features are weighted by w_i = (1/d_i) / sum_j (1/d_j). The one-hot MXU
contractions of the TPU version become gathers.
"""

from __future__ import annotations

from typing import Tuple

import torch

from transferable3d_torch.ops.grouping import flat_row_gather, pairwise_sqdist


def _min3(d2: torch.Tensor) -> torch.Tensor:
    """Indices [B, M, 3] int32 of the three smallest entries along the
    last axis, first index on ties; an all-inf row repeats index 0."""
    n = d2.shape[-1]
    iota = torch.arange(n, device=d2.device)
    cur = d2
    idxs = []
    for _ in range(3):
        m = cur.amin(dim=-1, keepdim=True)
        i = torch.where(cur <= m, iota, n).amin(dim=-1)
        i = torch.clamp_max(i, n - 1)
        idxs.append(i)
        cur = torch.where(iota == i[..., None], torch.inf, cur)
    return torch.stack(idxs, dim=-1).to(torch.int32)


def three_nn(queries: torch.Tensor, support: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """queries [B, M, 3], support [B, N, 3] -> (SQUARED distances
    [B, M, 3], idx [B, M, 3] int32)."""
    idx = _min3(pairwise_sqdist(queries, support))
    sel = flat_row_gather(support, idx)  # [B, M, 3, 3]
    diff = sel - queries[:, :, None, :]
    exact = diff[..., 0] * diff[..., 0]
    exact = exact + diff[..., 1] * diff[..., 1]
    exact = exact + diff[..., 2] * diff[..., 2]
    return torch.clamp_min(exact, 0.0), idx


def three_interpolate(features: torch.Tensor, idx: torch.Tensor,
                      dist: torch.Tensor) -> torch.Tensor:
    """features [B, N, C], idx/dist [B, M, 3] -> [B, M, C] float32 (or
    wider), inverse-squared-distance weighted."""
    w = 1.0 / torch.clamp_min(dist, 1e-10)
    w = w / torch.sum(w, dim=-1, keepdim=True)  # [B, M, 3]
    f = flat_row_gather(features.float(), idx)  # [B, M, 3, C]
    out = (f[:, :, 0] * w[..., 0:1] + f[:, :, 1] * w[..., 1:2]
           + f[:, :, 2] * w[..., 2:3])
    return out.to(torch.promote_types(features.dtype, torch.float32))
