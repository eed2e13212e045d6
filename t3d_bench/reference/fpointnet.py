"""Plain float32 PyTorch reference of F-PointNet v1 and v2: forward, loss,
Adam, the on-device batch draw and the serving decode.

Written from the layer equations of Qi et al., "Frustum PointNets for 3D
Object Detection from RGB-D Data" (arXiv:1711.08488) and of PointNet++
(arXiv:1706.02413), with the conventions of the program it judges
(flax's Dense and BatchNorm, eps 1e-3 and a call-time momentum; the hard
mask, masked centroid and cyclic pick of the object points; ball query
on the direct-form squared distance with cyclic repetition past the
count; the Appendix-A multi-task loss; Adam with eps 1e-8). It imports
nothing of the program: parameters are a dict keyed by the program's
`state_dict` names, which the benchmark makes from the seed and hands to
both sides, and everything the program derives (the device-resident
records, each step's draw and batch, dropout masks) is worked out here
again.

`Precision` sets the compute type of every dense product: "f32" (TF32
off, the reference) or "fp8" (both operands rounded to e4m3 with a
per-tensor scale, the gradient's to e5m2, f32 accumulation), the
control that stands one precision below the configuration's bfloat16.

Where the program's seg mask is given (`mask=`), the stages after the
masking run on the program's mask: the mask is a discrete decision that
rounding flips near ties, and it is judged apart by the logit gap of the
program's choice (`seg_choice_gap`).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

BN_EPS = 1e-3
NUM_OBJECT_POINT = 512


# ---------------------------------------------------------------------------
# Precision of the dense products
# ---------------------------------------------------------------------------

def _fp8(x: torch.Tensor, dtype) -> torch.Tensor:
    """x rounded to `dtype` (an fp8 type) under a per-tensor scale that
    maps its largest magnitude to the type's largest value."""
    top = torch.finfo(dtype).max
    amax = x.detach().abs().amax().clamp_min(1e-30)
    scale = top / amax
    return (x * scale).to(dtype).to(torch.float32) / scale


class _Fp8Matmul(torch.autograd.Function):
    """y = q(x) @ q(w).T with e4m3 operands; backward with the output
    gradient in e5m2, accumulations in f32."""

    @staticmethod
    def forward(ctx, x, w):
        xq, wq = _fp8(x, torch.float8_e4m3fn), _fp8(w, torch.float8_e4m3fn)
        ctx.save_for_backward(xq, wq)
        return xq @ wq.t()

    @staticmethod
    def backward(ctx, dy):
        xq, wq = ctx.saved_tensors
        dq = _fp8(dy, torch.float8_e5m2)
        dx = dq @ wq
        dw = dq.reshape(-1, dq.shape[-1]).t() @ xq.reshape(-1, xq.shape[-1])
        return dx, dw


class Precision:
    def __init__(self, kind: str = "f32"):
        if kind not in ("f32", "fp8"):
            raise ValueError(f"unknown precision {kind!r}")
        self.kind = kind

    def dense(self, x, w, b=None):
        """x [..., in] @ w[out, in].T (+ b)."""
        if self.kind == "fp8":
            y = _Fp8Matmul.apply(x, w)
        else:
            y = x @ w.t()
        return y if b is None else y + b


F32 = Precision("f32")


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

class Ctx:
    """One forward pass: parameters, buffers, mode, BN momentum,
    precision; in train mode it collects the BN buffers' new values."""

    def __init__(self, params: Dict[str, torch.Tensor],
                 buffers: Dict[str, torch.Tensor], train: bool,
                 momentum: float, prec: Precision):
        self.p, self.buf, self.train = params, buffers, train
        self.momentum, self.prec = momentum, prec
        self.new_buffers: Dict[str, torch.Tensor] = {}

    def dense(self, name, x, bias=True):
        return self.prec.dense(x, self.p[name + ".weight"],
                               self.p[name + ".bias"] if bias else None)

    def bn(self, name, x):
        if self.train:
            flat = x.reshape(-1, x.shape[-1])
            mean = flat.mean(dim=0)
            var = (flat * flat).mean(dim=0) - mean * mean
            m = self.momentum
            with torch.no_grad():
                self.new_buffers[name + ".mean"] = (
                    m * self.buf[name + ".mean"] + (1 - m) * mean.detach())
                self.new_buffers[name + ".var"] = (
                    m * self.buf[name + ".var"] + (1 - m) * var.detach())
        else:
            mean, var = self.buf[name + ".mean"], self.buf[name + ".var"]
        inv = torch.rsqrt(var + BN_EPS) * self.p[name + ".scale"]
        return (x - mean) * inv + self.p[name + ".bias"]

    def point_mlp(self, name, x, depth, pool_dim=None):
        for i in range(depth):
            x = torch.relu(self.bn(f"{name}.bn_{i}",
                                   self.dense(f"{name}.dense_{i}", x)))
        return x if pool_dim is None else x.amax(dim=pool_dim)

    def head(self, name, x, depth):
        for i in range(depth):
            x = torch.relu(self.bn(f"{name}.bn_{i}",
                                   self.dense(f"{name}.fc_{i}", x)))
        return self.dense(f"{name}.out", x)


def dropout(x, keep):
    return torch.where(keep, x / 0.5, torch.zeros_like(x))


# ---------------------------------------------------------------------------
# Point-set operations
# ---------------------------------------------------------------------------

def gather_rows(points, idx):
    """points [B, N, C], idx [B, ...] -> [B, ..., C]."""
    b, n, c = points.shape
    flat = idx.reshape(b, -1).long()
    out = torch.gather(points, 1, flat[..., None].expand(-1, -1, c))
    return out.reshape(*idx.shape, c)


def fps(xyz, k):
    """Farthest-point sampling from index 0: running distance from 1e10,
    d = (dx*dx + dy*dy) + dz*dz, argmax with the first index on ties."""
    b, n, _ = xyz.shape
    out = torch.zeros(b, k, dtype=torch.long, device=xyz.device)
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    rows = torch.arange(b, device=xyz.device)
    dist = torch.full((b, n), 1e10, dtype=xyz.dtype, device=xyz.device)
    last = torch.zeros(b, dtype=torch.long, device=xyz.device)
    for i in range(1, k):
        dx = x - x[rows, last][:, None]
        dy = y - y[rows, last][:, None]
        dz = z - z[rows, last][:, None]
        d = dx * dx
        d = d + dy * dy
        d = d + dz * dz
        dist = torch.minimum(dist, d)
        last = torch.argmax(dist, dim=1)
        out[:, i] = last
    return out


def ball_slots(cent, xyz, radius, k):
    """[B, S, K] indices: the in-radius points of each centroid (direct
    form ((0 + dx*dx) + dy*dy) + dz*dz <= float32(r*r)) in index order,
    repeated cyclically past their count; the nearest point for an empty
    ball."""
    d2 = None
    for i in range(3):
        diff = cent[:, :, None, i] - xyz[:, None, :, i]
        d2 = diff * diff if d2 is None else d2 + diff * diff
    within = d2 <= float(np.float32(radius * radius))
    rank = torch.cumsum(within.to(torch.int32), dim=-1, dtype=torch.int32)
    count = rank[..., -1]
    eff = torch.clamp(count, 1, k)[..., None]
    slot = torch.arange(k, dtype=torch.int32, device=xyz.device)
    want = torch.remainder(slot, eff) + 1
    idx = torch.searchsorted(rank.contiguous(), want.contiguous())
    nearest = torch.argmin(d2, dim=-1)[..., None]
    return torch.where(count[..., None] == 0, nearest, idx), count


def sqdist_expanded(a, b):
    cross = torch.einsum("bsc,bnc->bsn", a, b)
    na = torch.sum(a * a, dim=-1)[:, :, None]
    nb = torch.sum(b * b, dim=-1)[:, None, :]
    return torch.clamp_min(na + nb - 2 * cross, 0.0)


def three_interp(xyz_to, xyz_from, feat_from):
    """Inverse-squared-distance weights over the three nearest support
    points (first index on ties, index 0 repeated when fewer)."""
    d2 = sqdist_expanded(xyz_to, xyz_from)
    n = d2.shape[-1]
    iota = torch.arange(n, device=d2.device)
    cur, idxs = d2, []
    for _ in range(3):
        m = cur.amin(dim=-1, keepdim=True)
        i = torch.clamp_max(torch.where(cur <= m, iota, n).amin(dim=-1),
                            n - 1)
        idxs.append(i)
        cur = torch.where(iota == i[..., None], torch.inf, cur)
    idx = torch.stack(idxs, dim=-1)
    diff = gather_rows(xyz_from, idx) - xyz_to[:, :, None, :]
    dist = diff[..., 0] * diff[..., 0]
    dist = dist + diff[..., 1] * diff[..., 1]
    dist = dist + diff[..., 2] * diff[..., 2]
    w = 1.0 / torch.clamp_min(torch.clamp_min(dist, 0.0), 1e-10)
    w = w / torch.sum(w, dim=-1, keepdim=True)
    f = gather_rows(feat_from, idx)
    return (f[:, :, 0] * w[..., 0:1] + f[:, :, 1] * w[..., 1:2]
            + f[:, :, 2] * w[..., 2:3])


def grouped_mlp(ctx, name, cent, xyz, feats, radius, k, depth):
    """One SA scale: concat(xyz_j - c, feat_j) over each ball's slots ->
    (Dense, BN, ReLU) x depth -> max over the slots."""
    idx, _ = ball_slots(cent.detach(), xyz.detach(), radius, k)
    g = gather_rows(xyz, idx) - cent[:, :, None, :]
    if feats is not None:
        g = torch.cat([g, gather_rows(feats, idx)], dim=-1)
    return ctx.point_mlp(name, g, depth, pool_dim=2)


def set_abstraction(ctx, name, xyz, feats, npoint, radius, k, depth):
    cent = gather_rows(xyz, fps(xyz.detach(), npoint))
    return cent, grouped_mlp(ctx, f"{name}.mlp", cent, xyz, feats, radius,
                             k, depth)


def set_abstraction_all(ctx, name, xyz, feats, depth):
    g = xyz if feats is None else torch.cat([xyz, feats], dim=-1)
    return ctx.point_mlp(f"{name}.mlp", g[:, None], depth).amax(dim=2)


# ---------------------------------------------------------------------------
# F-PointNet v1 and v2
# ---------------------------------------------------------------------------

def seg_v1(ctx, arch, points, one_hot, keep):
    x = ctx.point_mlp("seg_net.mlp1", points, len(arch["mlp1"]))
    point_feat = x
    glob = ctx.point_mlp("seg_net.mlp2", x, len(arch["mlp2"]), pool_dim=1)
    g = torch.cat([glob, one_hot], dim=-1)
    # The published layer on concat(point feature, global, one-hot), with
    # its weight split by rows as the program holds it.
    x = (ctx.dense("seg_net.mlp3_point", point_feat)
         + ctx.dense("seg_net.mlp3_global", g, bias=False)[:, None, :])
    x = torch.relu(ctx.bn("seg_net.mlp3_bn", x))
    x = ctx.point_mlp("seg_net.mlp3", x, len(arch["mlp3"]) - 1)
    if keep is not None:
        x = dropout(x, keep)
    return ctx.dense("seg_net.seg_out", x)


def _msg(ctx, name, sa, xyz, feats):
    cent = gather_rows(xyz, fps(xyz.detach(), sa["npoint"]))
    f = torch.cat([grouped_mlp(ctx, f"{name}.mlp_{i}", cent, xyz, feats,
                               r, k, len(widths))
                   for i, (r, k, widths) in enumerate(sa["scales"])], dim=-1)
    return cent, f


def seg_v2(ctx, arch, points, one_hot, keep):
    xyz = points[..., :3]
    feats = points[..., 3:] if points.shape[-1] > 3 else None
    c1, f1 = _msg(ctx, "seg_net.sa1", arch["sa_msg"][0], xyz, feats)
    c2, f2 = _msg(ctx, "seg_net.sa2", arch["sa_msg"][1], c1, f1)
    f3 = set_abstraction_all(ctx, "seg_net.sa3", c2, f2,
                             len(arch["sa_all"]))              # [B, 1, F]
    g = torch.cat([f3, one_hot[:, None, :]], dim=-1)
    c3 = torch.zeros_like(c2[:, :1])
    depth = [len(w) for w in arch["fp"]]
    u2 = ctx.point_mlp("seg_net.fp1.mlp",
                       torch.cat([three_interp(c2, c3, g), f2], dim=-1),
                       depth[0])
    u1 = ctx.point_mlp("seg_net.fp2.mlp",
                       torch.cat([three_interp(c1, c2, u2), f1], dim=-1),
                       depth[1])
    skip = points if feats is not None else xyz
    u0 = ctx.point_mlp("seg_net.fp3.mlp",
                       torch.cat([three_interp(xyz, c1, u1), skip], dim=-1),
                       depth[2])
    x = ctx.point_mlp("seg_net.head_mlp", u0, len(arch["head"]))
    if keep is not None:
        x = dropout(x, keep)
    return ctx.dense("seg_net.seg_out", x)


def tnet(ctx, arch, obj, one_hot):
    x = ctx.point_mlp("tnet.mlp", obj, len(arch["mlp"]), pool_dim=1)
    return ctx.head("tnet.head", torch.cat([x, one_hot], dim=-1),
                    len(arch["head"]))


def box_v1(ctx, arch, obj, one_hot):
    x = ctx.point_mlp("box_net.mlp", obj, len(arch["mlp"]), pool_dim=1)
    return ctx.head("box_net.head", torch.cat([x, one_hot], dim=-1),
                    len(arch["head"]))


def box_v2(ctx, arch, obj, one_hot):
    xyz, feats = obj, None
    for i, sa in enumerate(arch["sa"]):
        xyz, feats = set_abstraction(ctx, f"box_net.sa{i + 1}", xyz, feats,
                                     sa["npoint"], sa["radius"],
                                     sa["nsample"], len(sa["mlp"]))
    f3 = set_abstraction_all(ctx, f"box_net.sa{len(arch['sa']) + 1}", xyz,
                             feats, len(arch["sa_all"]))
    return ctx.head("box_net.head", torch.cat([f3[:, 0], one_hot], dim=-1),
                    len(arch["head"]))


def masking(points, seg_logits, mask=None, k=NUM_OBJECT_POINT):
    """Hard mask (the given one, else the seg argmax), masked centroid,
    and the first k masked points in index order, cyclically repeated,
    centred on the centroid; an empty mask takes point 0."""
    xyz = points[..., :3]
    if mask is None:
        mask = (seg_logits[..., 1] > seg_logits[..., 0]).float()
    count = mask.sum(dim=1, keepdim=True)
    centroid = (xyz * mask[..., None]).sum(dim=1) / torch.clamp_min(count, 1)
    n = mask.shape[1]
    n_masked = count.to(torch.int32)
    rank = torch.cumsum(mask.to(torch.int32), dim=1, dtype=torch.int32)
    slot = torch.arange(k, dtype=torch.int32, device=points.device)
    want = torch.remainder(slot[None, :],
                           torch.clamp(n_masked, 1, min(k, n))) + 1
    idx = torch.searchsorted(rank.contiguous(), want.contiguous())
    idx = torch.where(n_masked == 0, 0, idx)
    obj = torch.gather(xyz, 1, idx[..., None].expand(-1, -1, 3))
    return obj - centroid[:, None, :], centroid, mask


def forward(cfg, ctx, points, one_hot, keep=None, mask=None,
            bins=None) -> Dict[str, torch.Tensor]:
    """The end points of one pass of the configuration `cfg`'s model;
    `mask` [B, N] the program's seg mask for the stages after the
    masking (else the pass's own)."""
    v1 = cfg["version"] == "v1"
    seg = (seg_v1 if v1 else seg_v2)(ctx, cfg["seg_net"], points, one_hot,
                                     keep)
    obj, centroid, mask = masking(points, seg, mask,
                                  cfg["num_object_point"])
    delta = tnet(ctx, cfg["tnet"], obj, one_hot)
    stage1 = delta + centroid
    box = (box_v1 if v1 else box_v2)(ctx, cfg["box_net"],
                                      obj - delta[:, None, :], one_hot)
    ep = parse_box(box, bins)
    ep.update(seg_logits=seg, mask=mask, mask_centroid=centroid,
              stage1_center=stage1, center=ep["center_delta"] + stage1)
    return ep


# ---------------------------------------------------------------------------
# Bins, boxes, loss, decode
# ---------------------------------------------------------------------------

class Bins:
    def __init__(self, mean_sizes, num_heading_bin: int):
        self.means = np.asarray(mean_sizes, np.float32)
        self.nh = num_heading_bin
        self.ns = len(mean_sizes)

    def mean_t(self, device):
        return torch.as_tensor(self.means, device=device)


def parse_box(out, bins: Bins):
    nh, ns = bins.nh, bins.ns
    hres = out[:, 3 + nh:3 + 2 * nh]
    sres = out[:, 3 + 2 * nh + ns:].reshape(-1, ns, 3)
    return {"center_delta": out[:, 0:3],
            "heading_scores": out[:, 3:3 + nh],
            "heading_residuals_normalized": hres,
            "heading_residuals": hres * (math.pi / nh),
            "size_scores": out[:, 3 + 2 * nh:3 + 2 * nh + ns],
            "size_residuals_normalized": sres,
            "size_residuals": sres * bins.mean_t(out.device)[None]}


def roty(t):
    c, s = torch.cos(t), torch.sin(t)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack([torch.stack([c, z, s], -1), torch.stack([z, o, z], -1),
                        torch.stack([-s, z, c], -1)], dim=-2)


_SIGNS = [[+1, -1, +1], [+1, -1, -1], [-1, -1, -1], [-1, -1, +1],
          [+1, +1, +1], [+1, +1, -1], [-1, +1, -1], [-1, +1, +1]]


def box_corners(center, size, heading):
    half = torch.stack([size[..., 0] / 2, size[..., 2] / 2, size[..., 1] / 2],
                       dim=-1)
    local = torch.tensor(_SIGNS, dtype=torch.float32,
                         device=size.device) * half[..., None, :]
    return (torch.einsum("...ij,...nj->...ni", roty(heading), local)
            + center[..., None, :])


def angle_to_class(angle, nh):
    angle = torch.remainder(angle, 2 * math.pi)
    w = 2 * math.pi / nh
    shifted = torch.remainder(angle + w / 2.0, 2 * math.pi)
    cls = torch.floor(shifted / w).to(torch.int32)
    return cls, shifted - (cls.to(angle.dtype) * w + w / 2.0)


def class_to_angle(cls, res, nh):
    angle = torch.remainder(cls.to(res.dtype) * (2 * math.pi / nh) + res,
                            2 * math.pi)
    return torch.where(angle > math.pi, angle - 2 * math.pi, angle)


def get_loss(ep, lab, bins: Bins, box_w=1.0, corner_w=10.0):
    """(total, terms): total = seg CE + box_w * (center huber(2) +
    stage-1 huber(1) +
    heading CE + size CE + 20 heading-residual huber + 20 size-residual
    huber + corner_w * corner huber); each term a mean over the
    frustums (the seg term over their points)."""
    nh, ns = bins.nh, bins.ns
    dev = lab["center"].device

    def huber(a, delta):
        a = torch.abs(a)
        q = torch.clamp_max(a, delta)
        per = 0.5 * q ** 2 + delta * (a - q)
        return per.reshape(per.shape[0], -1).mean(dim=1).mean()

    def ce(logits, y):
        per = torch.logsumexp(logits, -1) - torch.gather(
            logits, -1, y.long()[..., None])[..., 0]
        return per.reshape(per.shape[0], -1).mean(dim=1).mean()

    def dist(pred, gt, delta):
        return huber(torch.sqrt(((pred - gt) ** 2).sum(-1) + 1e-12), delta)

    h1 = F.one_hot(lab["heading_class"].long(), nh).float()
    s1 = F.one_hot(lab["size_class"].long(), ns).float()
    means = bins.mean_t(dev)
    gt_means = means[lab["size_class"].long()]
    hres = (ep["heading_residuals_normalized"] * h1).sum(1)
    sres = (ep["size_residuals_normalized"] * s1[..., None]).sum(1)
    centers = torch.arange(nh, dtype=torch.float32, device=dev) * (
        2 * math.pi / nh)
    pred_h = ((centers[None] * h1).sum(1)
              + (ep["heading_residuals"] * h1).sum(1))
    pred_s = gt_means + (ep["size_residuals"] * s1[..., None]).sum(1)
    pred_c = box_corners(ep["center"], pred_s, pred_h)
    gt_h = class_to_angle(lab["heading_class"], lab["heading_residual"], nh)
    gt_s = gt_means + lab["size_residual"]
    gt_c = box_corners(lab["center"], gt_s, gt_h)
    gt_cf = box_corners(lab["center"], gt_s, gt_h + math.pi)
    d = torch.sqrt(((pred_c - gt_c) ** 2).sum(-1) + 1e-12).mean(1)
    df = torch.sqrt(((pred_c - gt_cf) ** 2).sum(-1) + 1e-12).mean(1)
    t = {"seg_loss": ce(ep["seg_logits"], lab["seg"]),
         "center_loss": dist(ep["center"], lab["center"], 2.0),
         "stage1_center_loss": dist(ep["stage1_center"], lab["center"], 1.0),
         "heading_class_loss": ce(ep["heading_scores"], lab["heading_class"]),
         "heading_residual_loss": huber(
             hres - lab["heading_residual"] / (math.pi / nh), 1.0),
         "size_class_loss": ce(ep["size_scores"], lab["size_class"]),
         "size_residual_loss": huber(sres - lab["size_residual"] / gt_means,
                                     1.0),
         "corner_loss": huber(torch.minimum(d, df), 1.0)}
    box = (t["center_loss"] + t["stage1_center_loss"]
           + t["heading_class_loss"] + t["size_class_loss"]
           + 20.0 * t["heading_residual_loss"]
           + 20.0 * t["size_residual_loss"] + corner_w * t["corner_loss"])
    return t["seg_loss"] + box_w * box, t


def decode(ep, bins: Bins, class_idx):
    """center, size (the known class's cluster, floored at 1 cm),
    heading from the argmax heading bin; the heading class."""
    rows = torch.arange(ep["center"].shape[0], device=ep["center"].device)
    hcls = torch.argmax(ep["heading_scores"], dim=-1)
    heading = class_to_angle(hcls, ep["heading_residuals"][rows, hcls],
                             bins.nh)
    scls = class_idx.long()
    size = torch.clamp_min(bins.mean_t(scls.device)[scls]
                           + ep["size_residuals"][rows, scls], 0.01)
    return ep["center"], size, heading, hcls


# ---------------------------------------------------------------------------
# Schedules, the batch draw, Adam
# ---------------------------------------------------------------------------

def _stairs(step, batch, decay_samples):
    return np.floor(np.float32(step) * np.float32(batch)
                    / np.float32(decay_samples))


def lr_at(step, opt) -> float:
    lr = np.float32(opt["learning_rate"]) * np.float32(
        opt["lr_decay_rate"]) ** _stairs(step, opt["batch_size"],
                                         opt["lr_decay_samples"])
    return float(np.maximum(lr, np.float32(opt["min_lr"])))


def bn_momentum_at(step, opt) -> float:
    decay = np.float32(opt["bn_init_decay"]) * np.float32(
        opt["bn_decay_rate"]) ** _stairs(step, opt["batch_size"],
                                         opt["bn_decay_samples"])
    return float(np.minimum(np.float32(1.0) - decay,
                            np.float32(opt["bn_decay_clip"])))


class Records:
    """The records in the frustum frame, padded to `max_points`, on one
    device (what a device-resident dataset holds)."""

    def __init__(self, frames: Sequence[Tuple], classes: Sequence[int],
                 sizes: Sequence[np.ndarray], max_points: int, device):
        r, c = len(frames), frames[0][0].shape[1]
        pts = np.zeros((r, max_points, c), np.float32)
        seg = np.zeros((r, max_points), np.int64)
        count = np.zeros(r, np.int64)
        for i, (p, s, _, _) in enumerate(frames):
            pts[i, :len(p)], seg[i, :len(p)], count[i] = p, s, len(p)
        t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
        self.points, self.seg, self.count = t(pts), t(seg), t(count)
        self.center = t(np.stack([f[2] for f in frames]))
        self.heading = t(np.array([f[3] for f in frames], np.float32))
        self.size = t(np.stack(sizes).astype(np.float32))
        self.class_idx = t(np.asarray(classes, np.int64))


def draw_batch(rec: Records, idx, gen: torch.Generator, npoints, bins: Bins,
               flip_on=True, shift_on=True):
    """One step's batch from the data generator's next draws (u [B, n],
    flip [B], z [B], in this order): points drawn with replacement from
    each record's valid prefix, the x-mirror flip, the depth shift, the
    heading and size bins."""
    b = idx.shape[0]
    dev = gen.device
    u = torch.rand((b, npoints), generator=gen, device=dev)
    flip = torch.rand((b,), generator=gen, device=dev) < 0.5
    z = torch.randn((b,), generator=gen, device=dev)
    count = torch.clamp_min(rec.count[idx], 1)
    sel = torch.minimum(torch.floor(u * count[:, None].float()).long(),
                        count[:, None] - 1)
    pts = torch.gather(rec.points[idx], 1,
                       sel[..., None].expand(-1, -1, rec.points.shape[-1]))
    seg = torch.gather(rec.seg[idx], 1, sel)
    center = rec.center[idx].clone()
    heading = rec.heading[idx]
    pts = pts.clone()
    if flip_on:
        sign = torch.where(flip, -1.0, 1.0)
        pts[..., 0] *= sign[:, None]
        center[:, 0] *= sign
        heading = torch.where(flip, math.pi - heading, heading)
    if shift_on:
        d = torch.sqrt(center[:, 0] ** 2 + center[:, 2] ** 2)
        shift = torch.clamp(z * d * 0.05, -d * 0.2, d * 0.2)
        pts[..., 2] += shift[:, None]
        center[:, 2] += shift
    hcls, hres = angle_to_class(heading, bins.nh)
    cls = rec.class_idx[idx]
    return {"points": pts, "seg": seg, "center": center,
            "heading_class": hcls.long(), "heading_residual": hres,
            "size_class": cls,
            "size_residual": rec.size[idx] - bins.mean_t(dev)[cls],
            "one_hot": F.one_hot(cls, bins.ns).float(), "class_idx": cls}


class Adam:
    """torch.optim.Adam's arithmetic (betas 0.9, 0.999, eps 1e-8)."""

    def __init__(self, params: List[torch.Tensor]):
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]
        self.t = 0

    @torch.no_grad()
    def step(self, params, grads, lr):
        self.t += 1
        bc1 = 1 - 0.9 ** self.t
        bc2 = 1 - 0.999 ** self.t
        for p, g, m, v in zip(params, grads, self.m, self.v):
            m.lerp_(g, 0.1)
            v.mul_(0.999).addcmul_(g, g, value=0.001)
            denom = (v.sqrt() / math.sqrt(bc2)).add_(1e-8)
            p.addcdiv_(m, denom, value=-lr / bc1)


# ---------------------------------------------------------------------------
# What the benchmark compares
# ---------------------------------------------------------------------------

def train_steps(cfg: Dict, weights: Dict[str, torch.Tensor],
                rec: Records, step_idx: Sequence[torch.Tensor],
                draw_seed: int, dropout_seed: int, opt: Dict, bins: Bins,
                npoints: int, masks: Optional[Sequence] = None,
                prec: Precision = F32) -> Dict:
    """The first len(step_idx) supervised steps from `weights` (the
    program's parameters and BN buffers at step 0).

    Returns each step's total loss, the first step's loss terms, each
    leaf's first gradient, the parameters and buffers after the last
    step, each step's seg logits (for `seg_choice_gap`) and masks."""
    dev = rec.points.device
    names = [k for k in weights if not k.endswith((".mean", ".var"))]
    params = {k: weights[k].detach().clone().float().requires_grad_(True)
              for k in names}
    buffers = {k: v.detach().clone().float() for k, v in weights.items()
               if k.endswith((".mean", ".var"))}
    data_gen = torch.Generator(device=dev).manual_seed(draw_seed)
    drop_gen = torch.Generator(device=dev).manual_seed(dropout_seed)
    adam = Adam([params[k] for k in names])
    out = {"loss": [], "seg_logits": [], "masks": []}
    for t, idx in enumerate(step_idx):
        batch = draw_batch(rec, idx, data_gen, npoints, bins)
        b, n = batch["points"].shape[:2]
        width = cfg["seg_net"]["mlp3" if cfg["version"] == "v1"
                                else "head"][-1]
        keep = torch.rand((b, n, width), generator=drop_gen,
                          device=dev) < 0.5
        ctx = Ctx(params, buffers, True, bn_momentum_at(t, opt), prec)
        ep = forward(cfg, ctx, batch["points"], batch["one_hot"], keep,
                     None if masks is None else masks[t], bins)
        loss, terms = get_loss(ep, batch, bins, opt["box_loss_weight"],
                               opt["corner_loss_weight"])
        if t == 0:
            out["terms"] = {k: float(v.detach()) for k, v in terms.items()}
        grads = torch.autograd.grad(loss, [params[k] for k in names],
                                    allow_unused=True)
        grads = [torch.zeros_like(params[k]) if g is None else g
                 for k, g in zip(names, grads)]
        if t == 0:
            out["grad"] = {k: g.detach().clone() for k, g in zip(names, grads)}
        adam.step([params[k] for k in names], grads, lr_at(t, opt))
        buffers.update(ctx.new_buffers)
        out["loss"].append(float(loss.detach()))
        out["seg_logits"].append(ep["seg_logits"].detach())
        out["masks"].append(ep["mask"].detach())
        del ep, loss, terms, grads
    out["after"] = {**{k: v.detach() for k, v in params.items()}, **buffers}
    return out


@torch.no_grad()
def predict(cfg: Dict, weights: Dict[str, torch.Tensor], points, one_hot,
            class_idx, bins: Bins, mask=None, prec: Precision = F32,
            rows: int = 64) -> Dict[str, torch.Tensor]:
    """The predict step's detections in eval mode (running statistics),
    in blocks of `rows` frustums; with `mask` the stages after the
    masking run on it."""
    params = {k: v.float() for k, v in weights.items()
              if not k.endswith((".mean", ".var"))}
    buffers = {k: v.float() for k, v in weights.items()
               if k.endswith((".mean", ".var"))}
    parts = []
    for i in range(0, points.shape[0], rows):
        sl = slice(i, i + rows)
        ctx = Ctx(params, buffers, False, 0.0, prec)
        ep = forward(cfg, ctx, points[sl], one_hot[sl], None,
                     None if mask is None else mask[sl], bins)
        center, size, heading, hcls = decode(ep, bins, class_idx[sl])
        parts.append({"center": center, "size": size, "heading": heading,
                      "heading_class": hcls,
                      "heading_scores": ep["heading_scores"],
                      "heading_residuals": ep["heading_residuals"],
                      "seg_logits": ep["seg_logits"], "mask": ep["mask"]})
    return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}


def seg_choice_gap(ref_logits: torch.Tensor, mask: torch.Tensor) -> float:
    """The widest margin by which the reference's seg logits prefer the
    other class over the program's choice (0 where they agree)."""
    chosen = torch.where(mask > 0, ref_logits[..., 1], ref_logits[..., 0])
    return float((ref_logits.amax(dim=-1) - chosen).amax())


def choice_gap(ref_scores: torch.Tensor, chosen: torch.Tensor) -> float:
    """The widest margin by which the reference's best score lies above
    the score of the program's choice."""
    picked = torch.gather(ref_scores, -1, chosen.long()[..., None])[..., 0]
    return float((ref_scores.amax(dim=-1) - picked).amax())
