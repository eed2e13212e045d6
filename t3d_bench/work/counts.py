"""The benchmark's work counts: the FLOP rule for `mfu_*`, the SA chain's
function-level bytes and operations for its rooflines, and the chip's
published peaks.

FLOP rule. Every dense layer of the configuration's published layer
equations is counted at its published widths on every row it applies
to: each point, each object point, each ball slot of an SA scale (S x K,
cyclic repeats included), each frustum for a head. No algebraic
factoring is taken (v1's concatenated seg layer counts per point, an SA
scale's first layer per slot), so the count depends on shapes alone and
not on the implementation. A multiply-add is 2 FLOPs; a training step
counts the backward as twice the forward; recomputed work is not
counted.

SA roofline. One SA scale's chain (ball query, grouped MLP with
train-mode BN, max over the slots) is a function of its inputs: the
centroids [B, S, 3] and points [B, N, 3] in f32, the first layer's
per-point payload [B, N, F0] and per-centroid term [B, S, F0] in bf16,
and the layers' weights; its outputs are the pooled features [B, S, F]
(bf16) and, in training, the batch statistics and the gradients of the
payload, the centroid term and the weights, which read the pooled
features' gradient. Each is counted read once or written once, in the
narrowest type the chain's math uses; no intermediate activation and no
scratch of any design counts. Its operations are the products of
layers 1.. on the unique members of each ball (min(in-radius count, K),
at least 1: cyclic repeats give no new product), three times over in
training. The least time is the larger of bytes over the bandwidth and
operations over the bf16 tensor rate.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

# NVIDIA H100 SXM, the data sheet's dense rates (no sparsity) at 700 W.
PEAKS = {
    "NVIDIA H100": {"bf16_flops": 989e12, "f32_flops": 67e12,
                    "tf32_flops": 495e12, "fp8_flops": 1979e12,
                    "hbm_bytes_per_s": 3.35e12, "hbm_bytes": 80e9},
}


def peaks(kind: str) -> Optional[Dict[str, float]]:
    """The peaks of the card named `kind` (`torch.cuda.get_device_name`),
    None for a device without published peaks here (the CPU)."""
    for prefix, table in PEAKS.items():
        if kind.startswith(prefix):
            return table
    return None


def _mlp(rows: float, cin: int, widths: Sequence[int]) -> float:
    macs, f = 0.0, cin
    for w in widths:
        macs += rows * f * w
        f = w
    return macs


def _head(cin: int, widths: Sequence[int], out: int) -> float:
    return _mlp(1, cin, list(widths) + [out])


def box_output_dim(cfg: Dict) -> int:
    nh = cfg["bins"]["num_heading_bin"]
    ns = len(cfg["bins"]["mean_sizes"])
    return 3 + 2 * nh + 4 * ns


def forward_macs(cfg: Dict) -> float:
    """Multiply-adds of one frustum's forward pass by the FLOP rule."""
    n, c = cfg["num_point"], cfg["num_channels"]
    m = cfg["num_object_point"]
    k = len(cfg["bins"]["classes"])
    out = box_output_dim(cfg)
    seg, tnet, box = cfg["seg_net"], cfg["tnet"], cfg["box_net"]
    macs = _mlp(m, 3, tnet["mlp"]) + _head(tnet["mlp"][-1] + k,
                                           tnet["head"], 3)
    if cfg["version"] == "v1":
        macs += _mlp(n, c, seg["mlp1"])
        macs += _mlp(n, seg["mlp1"][-1], seg["mlp2"])
        concat = seg["mlp1"][-1] + seg["mlp2"][-1] + k
        macs += _mlp(n, concat, seg["mlp3"])
        macs += n * seg["mlp3"][-1] * 2
        macs += _mlp(m, 3, box["mlp"])
        return macs + _head(box["mlp"][-1] + k, box["head"], out)
    # v2: PointNet++ MSG seg net and the SA box net.
    pts, feat = n, c - 3
    level_feats = []
    for sa in seg["sa_msg"]:
        level_feats.append((pts, feat))
        s = sa["npoint"]
        f_out = 0
        for _radius, nsample, widths in sa["scales"]:
            macs += _mlp(s * nsample, 3 + feat, widths)
            f_out += widths[-1]
        pts, feat = s, f_out
    macs += _mlp(pts, 3 + feat, seg["sa_all"])
    # FP: from the global feature back to each level, coarsest first.
    up = seg["sa_all"][-1] + k
    targets = [(pts, feat)] + level_feats[::-1]
    for (p, f_skip), widths in zip(targets, seg["fp"]):
        skip = f_skip if p != n else c
        macs += _mlp(p, up + skip, widths)
        up = widths[-1]
    macs += _mlp(n, up, seg["head"]) + n * seg["head"][-1] * 2
    pts, feat = m, 0
    for sa in box["sa"]:
        macs += _mlp(sa["npoint"] * sa["nsample"], 3 + feat, sa["mlp"])
        pts, feat = sa["npoint"], sa["mlp"][-1]
    macs += _mlp(pts, 3 + feat, box["sa_all"])
    return macs + _head(box["sa_all"][-1] + k, box["head"], out)


def step_flops(cfg: Dict, frustums: int, train: bool) -> float:
    """FLOPs a step over `frustums` frustums requires."""
    return 2.0 * forward_macs(cfg) * frustums * (3 if train else 1)


def sa_chain_work(b: int, s: int, n: int, f0: int, widths: Sequence[int],
                  unique_rows: float, train: bool) -> Tuple[float, float]:
    """(bytes, operations) of one SA scale's chain function; `widths`
    are the grouped MLP's layer widths (widths[0] == f0) and
    `unique_rows` the sum over the centroids of the unique members."""
    f_last = widths[-1]
    weights = sum(2 * a * w + 4 * w for a, w in zip(widths[:-1], widths[1:]))
    bn = sum(8 * w for w in widths)
    inputs = 12 * b * s + 12 * b * n + 2 * b * n * f0 + 2 * b * s * f0
    nbytes = inputs + weights + bn + 2 * b * s * f_last
    ops = unique_rows * sum(2 * a * w for a, w in zip(widths[:-1], widths[1:]))
    if train:
        # dpooled in; d_pf, d_qc, the weights' gradients and the batch
        # statistics out.
        nbytes += 2 * b * s * f_last + 2 * b * n * f0 + 2 * b * s * f0
        nbytes += weights + bn + sum(8 * w for w in widths)
        ops *= 3
    return float(nbytes), float(ops)


def least_seconds(nbytes: float, ops: float, peak: Dict[str, float]
                  ) -> float:
    return max(nbytes / peak["hbm_bytes_per_s"], ops / peak["bf16_flops"])
