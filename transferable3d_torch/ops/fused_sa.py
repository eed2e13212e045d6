"""Fused set-abstraction chain: CUDA kernels K2 (inference, csrc/sa_infer.cu)
and K5-K9 (training, csrc/sa_train_fwd.cu and csrc/sa_train_bwd.cu), their
plain PyTorch twins, and the host schedule with its autograd function.

Port of `transferable3d_tpu/ops/fused_sa.py`. One SA scale is: ball query
around each centroid (direct-form squared distance, first K in-radius
points by index, cyclic repetition past the count, the nearest point for
an empty ball), then z1 = bf16(pf[sel] - qc), then for each layer
h = relu(bf16(z * a + c)) and, between layers, z' = bf16(h @ bf16(W) + b)
with float32 accumulation, then the max of the last h over the K slots.
`a` and `c` come from the f32 [6, F] pack of `_make_pack`. The TPU's
one-hot MXU selection, lane prefix sums, the `+0.25` reciprocal bias and
the planar layout are TPU workarounds and are not carried over: a gather
is exact on the card, and one kernel answers both layouts.

Inference (no gradient, running statistics) is one kernel, K2: only
`pooled` [B, S, F_last] bf16 leaves it.

Training needs exact batch statistics of every layer before the next
product can run, so it is the JAX package's cached-z schedule:
  forward:  K5 extract (z1, sum z1, sum z1^2) -> K6 per middle layer
            (z_d from z_{d-1}, its sums) -> K7 for the last layer (also
            the max and min of z over K), then `pooled` from the extrema;
  backward: the top layer's BN sums from the pool extrema (plain ops),
            K8 for j = L-2 .. 1 (BN backward of dy_{j+1}, dh through
            W_j, ReLU mask, writes dy_j; sums dW_j, db_j, sum dy_j,
            sum dy_j * xhat_j; at the top it redoes the max-pool
            gradient with ties split equally), K9 for j = 0 (the same
            without writing dy_0: it scatters dy_0 to its points, with
            the slot multiplicities), then d_pf and d_qc (plain ops).
Under data parallelism (`parallel/mesh.py`) the schedule sums K5-K7's
statistics and the backward's sum dy and sum dy * xhat over the ranks
before they enter a pack, with the global row count, so every kernel
reads the whole batch's BN terms; dgamma and dbeta stay the rank's own
sums, which the gradient all-reduce adds. Eval mode under autograd takes
the same schedule with packs from the
running statistics. Gradients to the geometry are zero; the returned
means and variances carry none. Every whole-grid sum of K5-K9 is
deterministic (per-block partials added in a fixed order); only K9's
scatter uses atomics. `torch.autograd.gradcheck` does not apply: the
chain is bf16 and its rounding is part of the function.
"""

from __future__ import annotations

import ctypes
import functools
import warnings
from typing import NamedTuple, Sequence, Tuple

import torch

from transferable3d_torch.ops import _build
from transferable3d_torch.ops.grouping import (direct_sqdist, flat_row_gather,
                                               radius_sq, select_slots)
from transferable3d_torch.parallel import mesh as mesh_lib

# csrc/sa_infer.cu: threads per block of the f32 kernel, max chain depth,
# and the shared memory one block may use on an H100 (227 KB); the
# tensor-core kernel's warps a block, member slots a warp and widest inner
# layer.
_THREADS = 256
_MAX_DEPTH = 6
_SMEM_LIMIT = 232448
_INF_WARPS, _INF_RING, _INF_MAX_INNER = 16, 64, 128
_PAD = 8  # bf16 elements of padding per shared-memory tile row


def _make_pack(gamma, beta, mu, var, eps, mdy=None, mdyx=None):
    """f32 [6, F], the JAX pack layout: a = gamma * rsqrt(var + eps),
    c = beta - mu * a, mu, r = rsqrt(var + eps), and the two rows the
    training backward fills once layer's own sums are known,
    mdy = sum(dy) / M and mdyx = sum(dy * xhat) / M (zero until then).
    So y = z * a + c, xhat = (z - mu) * r, and the train-mode BN backward
    is dz = a * (dy - mdy - xhat * mdyx)."""
    r = torch.rsqrt(var + eps)
    a = gamma * r
    c = beta - mu * a
    z = torch.zeros_like(a)
    return torch.stack([a, c, mu, r, z if mdy is None else mdy,
                        z if mdyx is None else mdyx]).float()


def sa_infer_plain(cent, xyz, pf, qc, radius: float, nsample: int,
                   packs: Sequence[torch.Tensor], ws: Sequence[torch.Tensor],
                   bs: Sequence[torch.Tensor]) -> torch.Tensor:
    """Plain PyTorch twin of K2, with the rounding sites of the JAX
    `_infer_kernel` (`_rank_rows`, `_chain_all`, fused_sa.py:118-179)."""
    d2 = direct_sqdist(cent, xyz)
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


class InferPlan(NamedTuple):
    """How K2 runs one chain: on the tensor cores (`mma`, widths padded to
    multiples of 16 in `dims`) or on the general f32 kernel (`dims` as
    given), and the block's dynamic shared memory in bytes."""
    mma: bool
    dims: Tuple[int, ...]
    smem: int


def _ceil16(f: int) -> int:
    return -(-f // 16) * 16


def sa_infer_layout_bytes(dims: Sequence[int]) -> Tuple[int, int, int]:
    """Shared memory of one block of K2's tensor-core kernel (mirrors
    sa_infer.cu): (bf16(W_d) as [F_d][F_d+1 + 8] rows back to back, every
    layer's a | c | b in f32, and the total with each warp's ring of
    members and the running max and min of the last layer's z)."""
    wbytes = sum(dims[d] * (dims[d + 1] + _PAD) * 2
                 for d in range(len(dims) - 1))
    pbytes = 3 * sum(dims) * 4
    return (wbytes, pbytes,
            wbytes + pbytes + _INF_WARPS * (_INF_RING + 2 * dims[-1]) * 4)


@functools.lru_cache(maxsize=None)
def sa_infer_plan(nsample: int, dims: Tuple[int, ...]) -> InferPlan:
    """The tensor-core kernel wherever its inner layers (all but the
    last), padded to multiples of 16, are at most 128 wide and the weights
    fit in shared memory; the general f32 kernel otherwise."""
    padded = tuple(_ceil16(f) for f in dims)
    if max(padded[:-1]) <= _INF_MAX_INNER:
        smem = sa_infer_layout_bytes(padded)[2]
        if smem <= _SMEM_LIMIT:
            return InferPlan(True, padded, smem)
    head = (nsample + 3 * (_THREADS // 32)) * 4
    head = (head + 15) // 16 * 16
    return InferPlan(False, tuple(dims), head + 2 * nsample * max(dims) * 2)


def sa_infer_smem_bytes(nsample: int, dims: Sequence[int]) -> int:
    """Dynamic shared memory of one K2 block under `sa_infer_plan`."""
    return sa_infer_plan(nsample, tuple(dims)).smem


def _pad_to(t: torch.Tensor, *sizes: int) -> torch.Tensor:
    """t with zeros appended to its last len(sizes) dims up to `sizes`."""
    pad = []
    for dim, size in zip(reversed(range(t.dim())), reversed(sizes)):
        pad += [0, size - t.shape[dim]]
    return torch.nn.functional.pad(t, pad) if any(pad) else t


def _pad_dense(dims, ws, bs):
    """The Dense layers of a chain at widths `dims`: zero rows and columns
    of every W, zero biases."""
    return ([_pad_to(w, dims[d], dims[d + 1]) for d, w in enumerate(ws)],
            [_pad_to(b, dims[d + 1]) for d, b in enumerate(bs)])


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
    plan = sa_infer_plan(nsample, tuple(dims))
    if plan.smem > _SMEM_LIMIT:
        raise ValueError(f"sa_infer_cuda: K={nsample} x F={max(dims)} needs "
                         f"{plan.smem} B of shared memory (> {_SMEM_LIMIT})")
    lib = _build.library()
    kd = plan.dims
    pooled = torch.empty(b, s, kd[-1], dtype=torch.bfloat16, device=dev)
    dims_c = (ctypes.c_int * depth)(*kd)
    with torch.cuda.device(dev):
        if plan.mma:
            # the rows are read 4 bytes at a time: a view at an odd offset
            # is copied to storage of its own
            pf_k, qc_k = (t if t.data_ptr() % 16 == 0 else t.clone()
                          for t in (_pad_to(pf, kd[0]), _pad_to(qc, kd[0])))
            # host arrays of the chain's device pointers, alive until the
            # launch has read them
            w_c, p_c, b_c = ((ctypes.c_void_p * len(ts))(
                *(t.data_ptr() for t in ts)) for ts in (ws, packs, bs))
            real_c = (ctypes.c_int * depth)(*dims)
            grid = _grid(dev, -(-b * s // _INF_WARPS), 1)
            code = lib.t3d_sa_infer_mma(
                cent.data_ptr(), xyz.data_ptr(), pf_k.data_ptr(),
                qc_k.data_ptr(), ctypes.addressof(w_c), ctypes.addressof(p_c),
                ctypes.addressof(b_c), pooled.data_ptr(), b, s, n, nsample,
                depth, ctypes.addressof(dims_c), ctypes.addressof(real_c),
                grid, radius_sq(radius), _build.stream_ptr(dev))
            what = "t3d_sa_infer_mma"
        else:
            params = _flat_params(packs, ws, bs)
            code = lib.t3d_sa_infer(
                cent.data_ptr(), xyz.data_ptr(), pf.data_ptr(),
                qc.data_ptr(), params.data_ptr(), pooled.data_ptr(), b, s,
                n, nsample, depth, ctypes.addressof(dims_c),
                radius_sq(radius), _build.stream_ptr(dev))
            what = "t3d_sa_infer"
    _build.check(code, what)
    _build.LAUNCHES["sa_infer"] += 1
    if kd[-1] != dims[-1]:
        pooled = pooled[..., :dims[-1]].contiguous()
    return pooled


def sa_infer(cent, xyz, pf, qc, radius: float, nsample: int, packs, ws,
             bs) -> torch.Tensor:
    """One eval-mode SA scale -> pooled [B, S, F_last] bf16. CPU tensors
    take the plain twin; CUDA tensors take K2."""
    if cent.device.type == "cpu":
        return sa_infer_plain(cent, xyz, pf, qc, radius, nsample, packs,
                              ws, bs)
    return sa_infer_cuda(cent, xyz, pf, qc, radius, nsample, packs, ws, bs)


# ---------------------------------------------------------------------------
# Training passes K5-K9: plain twins. Each has the rounding sites of its
# JAX kernel (`_bf16(...)` in transferable3d_tpu/ops/fused_sa.py) and f32
# sums everywhere else. z tensors are [B, S, K, F] bf16.
# ---------------------------------------------------------------------------

_BF = torch.bfloat16
_ROWS = (0, 1, 2)  # the axes a whole-grid sum runs over


def _bn_relu(z, pack):
    """h = max(bf16(f32(z) * a + c), 0), bf16."""
    return torch.clamp_min((z.float() * pack[0] + pack[1]).to(_BF), 0)


def _slots(cent, xyz, radius: float, nsample: int):
    d2 = direct_sqdist(cent, xyz)
    return select_slots(d2 <= radius_sq(radius), d2, nsample)


def _stats(z):
    zf = z.float()
    return zf.sum(_ROWS), (zf * zf).sum(_ROWS)


def sa_extract_plain(cent, xyz, pf, qc, radius: float, nsample: int):
    """Plain twin of K5 (`_extract_kernel`): z1 = bf16(pf[sel] - qc)
    [B, S, K, F0] bf16, and sum z1, sum z1^2 per channel, f32 [F0]."""
    idx, _ = _slots(cent, xyz, radius, nsample)
    z1 = (flat_row_gather(pf, idx).float()
          - qc.float()[:, :, None, :]).to(_BF)
    return (z1, *_stats(z1))


def sa_fwd_step_plain(z_prev, pack, w, b, last: bool = False):
    """Plain twin of K6 (`_fwd_step_kernel`) and, with `last`, of K7
    (`_fwd_last_kernel`): z' = bf16(relu(BN(z)) @ bf16(W) + b), its sums
    and, for K7, the max and min of z' over K, f32 [B, S, F_out]."""
    h = _bn_relu(z_prev, pack)
    z = (torch.matmul(h.float(), w.to(_BF).float()) + b).to(_BF)
    out = (z, *_stats(z))
    if last:
        zf = z.float()
        out += (zf.amax(dim=2), zf.amin(dim=2))
    return out


def _step_dz_plain(train: bool, top: bool, z_j1, dy_src, pack_j1):
    """dz_{j+1} (`_step_dz_rows`): BN backward of dy_{j+1}, which at the
    top is redone from (pooled, dpooled) with ties split equally
    (`_top_dy_rows`)."""
    a1, _, mu1, r1, mdy1, mdyx1 = pack_j1
    if top:
        pooled, dpooled = dy_src
        h1 = _bn_relu(z_j1, pack_j1).float()
        eq = (h1 == pooled.float()[:, :, None, :]).float()
        ties = eq.sum(dim=2, keepdim=True).clamp_min(1.0)
        dh = (dpooled.to(_BF).float()[:, :, None, :] * eq / ties).to(_BF)
        dy1 = torch.where(h1 > 0, dh, torch.zeros_like(dh))
    else:
        dy1 = dy_src
    if train:
        xhat1 = (z_j1.float() - mu1) * r1
        return ((dy1.float() - mdy1 - xhat1 * mdyx1) * a1).to(_BF)
    return (dy1.float() * a1).to(_BF)


def sa_bwd_step_plain(train: bool, top: bool, z_j, z_j1, dy_src, pack_j,
                      pack_j1, w_j):
    """Plain twin of K8 (`_bwd_step_kernel`). `dy_src` is dy_{j+1}
    [B, S, K, F_j1] bf16, or at the top (pooled, dpooled) [B, S, F_j1].
    Returns (dy_j bf16, sum dy_j, sum dy_j * xhat_j, dW_j, db_j)."""
    dz1 = _step_dz_plain(train, top, z_j1, dy_src, pack_j1)
    h_j = _bn_relu(z_j, pack_j)
    dh = torch.matmul(dz1.float(), w_j.to(_BF).float().t()).to(_BF)
    dy_j = torch.where(h_j > 0, dh, torch.zeros_like(dh))
    dyf = dy_j.float()
    xhat_j = (z_j.float() - pack_j[2]) * pack_j[3]
    f_j, f_j1 = z_j.shape[-1], z_j1.shape[-1]
    dw = torch.matmul(h_j.reshape(-1, f_j).float().t(),
                      dz1.reshape(-1, f_j1).float())
    return (dy_j, dyf.sum(_ROWS), (dyf * xhat_j).sum(_ROWS), dw,
            dz1.float().sum(_ROWS))


def sa_bwd_sum_magnitudes(train: bool, top: bool, z_j, z_j1, dy_src,
                          pack_j, pack_j1, w_j):
    """The sums of the magnitudes of the terms of K8's and K9's four
    whole-grid sums: (sum |dy_j|, sum |dy_j * xhat_j|, |h_j|^T |dz|,
    sum |dz|). A sum taken in another order is judged against these, not
    against its own value: db_j is zero in exact arithmetic in train mode
    (the batch-statistic identities), and the others cancel in part."""
    dz1 = _step_dz_plain(train, top, z_j1, dy_src, pack_j1).float().abs()
    dy_j = sa_bwd_step_plain(train, top, z_j, z_j1, dy_src, pack_j, pack_j1,
                             w_j)[0].float().abs()
    xhat_j = ((z_j.float() - pack_j[2]) * pack_j[3]).abs()
    h_j = _bn_relu(z_j, pack_j).float()
    dw = torch.matmul(h_j.reshape(-1, h_j.shape[-1]).t(),
                      dz1.reshape(-1, dz1.shape[-1]))
    return (dy_j.sum(_ROWS), (dy_j * xhat_j).sum(_ROWS), dw, dz1.sum(_ROWS))


def step0_table_width(s: int) -> int:
    """Bytes of a point's row of K9's rank table: S rounded up to 4."""
    return -(-s // 4) * 4


def step0_scratch_bytes(cent, xyz, r: float, k: int, f0: int) -> int:
    """Bytes K9 moves through its scratch at these balls, beyond its
    inputs and outputs: each member's f32 slot sums written and read,
    the rank table zeroed, its members' bytes written and the table
    read, eff written and read."""
    b, s, n = cent.shape[0], cent.shape[1], xyz.shape[1]
    members = int(torch.clamp(_slots(cent, xyz, r, k)[1], 1, k).sum())
    return (2 * members * f0 * 4 + 2 * b * n * step0_table_width(s)
            + members + 2 * b * s * 4)


def step0_scatter_plain(idx, count, dy0, qc, n: int):
    """K9's sums onto the points, in the kernel's order: the member of
    1-based rank r <= eff = clip(count, 1, K) of centroid s fills slots r
    - 1, r - 1 + eff, ...; its slot sum m (f32 from +0, the slots in
    ascending order), mult = (K - r) // eff + 1 and mult * qc[s] are
    added onto its point, in f32 from +0, in ascending s. idx [B, S, K]
    (slot k takes member k mod eff), count [B, S], dy0 [B, S, K, F0],
    qc [B, S, F0]. Returns (H [B, N, F0], Mq [B, N, F0], cnt [B, 1, N]),
    f32. On the CPU `index_add_` adds in the order of its rows, so this
    is the kernel's sequence; on CUDA it adds with atomics."""
    b, s, k, f0 = dy0.shape
    dev = dy0.device
    eff = torch.clamp(count, 1, k).long()
    rank = torch.arange(k, device=dev)
    # m[b, s, j]: slot k adds to member k mod eff, slots in ascending k,
    # one add a member at a time
    m = torch.zeros(b * s, k, f0, dtype=torch.float32, device=dev)
    rows = torch.arange(b * s, device=dev)
    member = (rank[None, :] % eff.reshape(-1, 1))
    dyf = dy0.float().reshape(b * s, k, f0)
    for slot in range(k):
        at = member[:, slot]
        m[rows, at] = m[rows, at] + dyf[:, slot]
    mult = torch.where(rank < eff[..., None], (k - 1 - rank) // eff[..., None]
                       + 1, 0).float()
    flat = (idx.long() + torch.arange(b, device=dev)[:, None, None]
            * n).reshape(-1)
    h_acc = torch.zeros(b * n, f0, device=dev).index_add_(
        0, flat, m.reshape(-1, f0))
    cnt = torch.zeros(b * n, device=dev).index_add_(0, flat,
                                                     mult.reshape(-1))
    mq = torch.zeros(b * n, f0, device=dev).index_add_(
        0, flat, (mult[..., None] * qc.float()[:, :, None, :])
        .reshape(-1, f0))
    return h_acc.reshape(b, n, f0), mq.reshape(b, n, f0), cnt.reshape(b, 1, n)


def sa_bwd_step0_plain(train: bool, top: bool, z_j, z_j1, dy_src, cent, xyz,
                       qc, pack_j, pack_j1, w_j, radius: float):
    """Plain twin of K9 (`_bwd_step0_kernel`): K8 at j = 0 without dy_0;
    instead H = the slots' dy_0 summed onto their points, cnt = slots per
    point, Mq = sum over centroids of (slots of the point) * qc, in the
    kernel's order (`step0_scatter_plain`), and per centroid sum_k dy_0
    and sum_k z_1. Returns (sum dy_0, sum dy_0 * xhat_0, dW_0, db_0, H
    [B,N,F0], Mq [B,N,F0], cnt [B,1,N], Sdy [B,S,F0], Sz [B,S,F0]), all
    f32."""
    dy_j, sdy, sdyx, dw, db = sa_bwd_step_plain(
        train, top, z_j, z_j1, dy_src, pack_j, pack_j1, w_j)
    idx, count = _slots(cent, xyz, radius, z_j.shape[2])
    h_acc, mq, cnt = step0_scatter_plain(idx, count, dy_j, qc, xyz.shape[1])
    return (sdy, sdyx, dw, db, h_acc, mq, cnt, dy_j.float().sum(dim=2),
            z_j.float().sum(dim=2))


# ---------------------------------------------------------------------------
# Training passes K5-K9: launchers (csrc/sa_train_fwd.cu, sa_train_bwd.cu).
# Each kernel runs a fixed grid of blocks that walk their centroids in
# order and keep partial sums; a second launch adds the partials in block
# order, so the sums are the same bits run after run.
# ---------------------------------------------------------------------------

# What the kernels take: K rows of one centroid are whole 16-row
# tensor-core fragments (at most 8), widths are fragment multiples, and the
# backward keeps dW_j in at most 8 16x16 accumulator blocks per warp.
_TRAIN_MAX_K = 128
_TRAIN_MAX_F = 256
_TRAIN_MAX_DW = 32768
# K6/K7 (sa_train_fwd.cu): rows of a tile, ring stages, 16-row blocks.
_FWD_TILE_ROWS, _FWD_MAX_STAGES, _FWD_WM = 128, 3, 8
# K8/K9 (sa_train_bwd.cu): threads, rows of a tile, ring stages, 16-row
# blocks.
_BWD_THREADS, _BWD_TILE_ROWS, _BWD_MAX_STAGES, _BWD_MAX_WM = 512, 128, 3, 8


def _need(what: str, dev, specs) -> None:
    """Raise unless every (name, tensor, dtype, shape) is a contiguous
    tensor of that dtype and shape on `dev`."""
    if dev.type != "cuda":
        raise ValueError(f"{what} needs CUDA tensors, got {dev}")
    for name, t, dt, shape in specs:
        if (t.device != dev or t.dtype != dt
                or tuple(t.shape) != tuple(shape)):
            raise ValueError(
                f"{what}: {name} must be {dt} {tuple(shape)} on {dev}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")


def _need_tile(what: str, k: int, *widths: int) -> None:
    if k % 16 or not 16 <= k <= _TRAIN_MAX_K:
        raise ValueError(f"{what}: K={k} must be a multiple of 16 up to "
                         f"{_TRAIN_MAX_K}")
    for f in widths:
        if f % 16 or not 16 <= f <= _TRAIN_MAX_F:
            raise ValueError(f"{what}: width {f} must be a multiple of 16 "
                             f"up to {_TRAIN_MAX_F}")


def fused_route(nsample: int, widths: Sequence[int], passes: bool) -> bool:
    """The branch of one SA scale, from its shapes alone, before any
    launch: True for the fused branch, False for the unfused one
    (`grouped_payload`, K3/K4, which take any K up to 4,096). Without the
    training passes (eval, no gradient) the fused branch is K2, which
    takes every chain. With them (`passes`: train mode, or a gradient
    wanted) it is K5-K9, which take K a multiple of 16 up to 128 and,
    with every width padded to a multiple of 16 (`_padded_chain` on the
    card), widths up to 256 and dW_j up to 32,768 entries (what
    `_need_tile` and the backward's launcher require). The same decision
    on every device, so the CPU's plain twins follow the card's route."""
    dims = [_ceil16(f) for f in widths]
    return not passes or (
        nsample % 16 == 0 and 16 <= nsample <= _TRAIN_MAX_K
        and max(dims) <= _TRAIN_MAX_F
        and all(a * b <= _TRAIN_MAX_DW for a, b in zip(dims, dims[1:])))


_REROUTED_SHAPES = set()


def note_reroute(nsample: int, widths: Sequence[int]) -> None:
    """Count a chain that `fused_route` sent to the unfused branch in
    `_build.LAUNCHES["fused_sa_rerouted"]`, and warn once a shape."""
    _build.LAUNCHES["fused_sa_rerouted"] += 1
    key = (nsample, tuple(widths))
    if key not in _REROUTED_SHAPES:
        _REROUTED_SHAPES.add(key)
        warnings.warn(
            f"fused set abstraction: K={nsample} with widths {list(widths)} "
            "is not a shape of the training kernels K5-K9 (K a multiple of "
            "16 up to 128; widths, padded to multiples of 16, up to 256 and "
            "dW up to 32,768 entries); this scale trains on the unfused "
            "branch (K3/K4)", stacklevel=3)


@functools.lru_cache(maxsize=None)
def _sm_count(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _grid(dev, ncent: int, per_sm: int) -> int:
    return max(1, min(ncent, _sm_count(dev) * per_sm))


class FwdPlan(NamedTuple):
    """How K6/K7 tile one shape: `ct` whole centroids (ct * K rows) a
    tile, `stages` ring stages, bf16(W) resident in shared memory or read
    through L2, and the block's dynamic shared memory in bytes."""
    ct: int
    stages: int
    w_smem: bool
    smem: int


def sa_fwd_layout_bytes(k: int, f_in: int, f_out: int, ct: int,
                        stages: int, w_smem: bool, last: bool) -> int:
    """Dynamic shared memory of one K6/K7 block (mirrors `fwd_layout` of
    sa_train_fwd.cu): `stages` z_prev tiles, bf16(W) if it stays, the z'
    staging tile, a | c | b, and K7's per-row-block extrema."""
    rows = ct * k
    return (stages * rows * (f_in + _PAD) * 2
            + (f_in * (f_out + _PAD) * 2 if w_smem else 0)
            + rows * (f_out + _PAD) * 2 + (2 * f_in + f_out) * 4
            + (2 * _FWD_WM * f_out * 4 if last else 0))


@functools.lru_cache(maxsize=None)
def sa_fwd_plan(k: int, f_in: int, f_out: int, last: bool = True
                ) -> FwdPlan:
    """The most centroids a tile can hold (at most 128 rows), and the
    most ring stages (up to three) that fit with W resident; a shape too
    wide for one stage with W reads W through L2 instead."""
    ct = max(1, _FWD_TILE_ROWS // k)
    for w_smem in (True, False):
        for stages in range(_FWD_MAX_STAGES, 0, -1):
            smem = sa_fwd_layout_bytes(k, f_in, f_out, ct, stages, w_smem,
                                       last)
            if smem <= _SMEM_LIMIT:
                return FwdPlan(ct, stages, w_smem, smem)
    raise ValueError(f"K6/K7: no tile plan fits K={k}, {f_in} -> {f_out}")


def sa_fwd_smem_bytes(k: int, f_in: int, f_out: int) -> int:
    """Dynamic shared memory of one K7 block under `sa_fwd_plan` (K6
    needs less: no extrema)."""
    return sa_fwd_plan(k, f_in, f_out, True).smem


class BwdPlan(NamedTuple):
    """How K8/K9 tile one shape: `ct` whole centroids (ct * K rows) a
    tile, `stages` ring stages, bf16(W_j) resident in shared memory or
    read through L2, and the block's dynamic shared memory in bytes."""
    ct: int
    stages: int
    w_smem: bool
    smem: int


def sa_bwd_layout_bytes(k: int, f_j: int, f_j1: int, ct: int, stages: int,
                        w_smem: bool, top: bool) -> int:
    """Dynamic shared memory of one K8/K9 block (mirrors `bwd_layout` of
    sa_train_bwd.cu). A stage: the z_j and z_j1 tiles, and either dy_j1's
    tile or pooled and dpooled. Fixed: the h_j tile, W_j,
    four rows of layer j's pack and the six of layer j+1's, the
    whole-grid column sums, the tie counts, the per-centroid column
    sums' shares, the members, the ball query's scratch."""
    rows = ct * k
    tz, t1 = rows * (f_j + _PAD) * 2, rows * (f_j1 + _PAD) * 2
    stage = tz + t1 + (4 * ct * f_j1 if top else t1)
    return (stages * stage + tz
            + (f_j * (f_j1 + _PAD) * 2 if w_smem else 0) + 4 * f_j * 4
            + 6 * f_j1 * 4 + 2 * _BWD_MAX_WM * f_j * 4 + 4 * ct * f_j1
            + _BWD_THREADS * 4 + rows * 4 + 256)


@functools.lru_cache(maxsize=None)
def sa_bwd_plan(k: int, f_j: int, f_j1: int, top: bool = True) -> BwdPlan:
    """The most centroids a tile can hold (a power of two, at most 128
    rows) with two stages and W_j resident, and a third stage if it fits.
    A shape too wide for that takes the largest tile with one stage (the
    next tile's loads then overlap the epilogue only), without W_j in
    shared memory if it must."""
    ct_max = max(1, _BWD_TILE_ROWS // k)

    def fits(ct, stages, w):
        return sa_bwd_layout_bytes(k, f_j, f_j1, ct, stages, w,
                                   top) <= _SMEM_LIMIT

    ct = ct_max
    while ct > 1 and not fits(ct, 2, True):
        ct //= 2
    if fits(ct, 2, True):
        stages = max(n for n in range(2, _BWD_MAX_STAGES + 1)
                     if fits(ct, n, True))
        w_smem = True
    else:
        ct, stages, w_smem = ct_max, 1, fits(ct_max, 1, True)
    return BwdPlan(ct, stages, w_smem, sa_bwd_layout_bytes(
        k, f_j, f_j1, ct, stages, w_smem, top))


def sa_bwd_tiles(ncent: int, ct: int) -> Tuple[int, int]:
    """(tiles of a launch over `ncent` centroids, centroids of the last
    tile): the last tile is ragged where ct does not divide ncent."""
    tiles = -(-ncent // ct)
    return tiles, ncent - (tiles - 1) * ct


def sa_bwd_smem_bytes(k: int, f_j: int, f_j1: int, top: bool = True) -> int:
    """Dynamic shared memory of one K8/K9 block under `sa_bwd_plan`."""
    return sa_bwd_plan(k, f_j, f_j1, top).smem


def _need_smem(what: str, smem: int) -> None:
    if smem > _SMEM_LIMIT:
        raise ValueError(f"{what}: needs {smem} B of shared memory "
                         f"(> {_SMEM_LIMIT})")


class ExtractPlan(NamedTuple):
    """How K5 runs one shape: `warps` a block (one centroid a warp),
    `vec` channels a lane moves in one access (8: 16 bytes, where F0 is a
    multiple of 8; else 1), `per_sm` blocks an SM, and the block's dynamic
    shared memory in bytes."""
    warps: int
    vec: int
    per_sm: int
    smem: int


# K5 (sa_train_fwd.cu): most warps a block; the shared memory of an SM
# (228 KB, 1 KB of it reserved for each block).
_EXT_MAX_WARPS, _EXT_ACC_PAIRS = 16, 256
_SM_SMEM, _BLOCK_RESERVED = 233472, 1024


def sa_extract_layout_bytes(k: int, f0: int, warps: int) -> int:
    """Dynamic shared memory of one K5 block (mirrors `extract_layout` of
    sa_train_fwd.cu): each warp's f64 sum and sum of squares for 256
    (row group, channel) pairs, whatever F0, and its member list (K ints,
    rounded up to 4)."""
    return warps * (2 * _EXT_ACC_PAIRS * 8 + -(-k // 4) * 4 * 4)


@functools.lru_cache(maxsize=None)
def sa_extract_plan(k: int, f0: int) -> ExtractPlan:
    """Sixteen warps a block where their lists fit (K up to 2,608), fewer
    beyond; two blocks an SM where two fit (K up to 784)."""
    per_warp = sa_extract_layout_bytes(k, f0, 1)
    warps = min(_EXT_MAX_WARPS, _SMEM_LIMIT // per_warp)
    if warps < 1:
        raise ValueError(f"K5: no plan fits K={k}, F0={f0}")
    smem = sa_extract_layout_bytes(k, f0, warps)
    per_sm = 2 if 2 * (smem + _BLOCK_RESERVED) <= _SM_SMEM else 1
    return ExtractPlan(warps, 8 if f0 % 8 == 0 else 1, per_sm, smem)


def sa_extract_cuda(cent, xyz, pf, qc, radius: float, nsample: int):
    """Launch K5 on the current stream. Raises on anything it does not
    take; never falls back to the plain twin."""
    what, dev = "sa_extract_cuda", cent.device
    if cent.dim() != 3 or xyz.dim() != 3 or pf.dim() != 3:
        raise ValueError(f"{what}: cent, xyz and pf must be [B, rows, C]")
    b, s = cent.shape[0], cent.shape[1]
    n, f0 = xyz.shape[1], pf.shape[-1]
    _need(what, dev, (("cent", cent, torch.float32, (b, s, 3)),
                      ("xyz", xyz, torch.float32, (b, n, 3)),
                      ("pf", pf, _BF, (b, n, f0)),
                      ("qc", qc, _BF, (b, s, f0))))
    if (min(b, s, n, nsample) < 1 or nsample > 4096
            or not 1 <= f0 <= _TRAIN_MAX_F):
        raise ValueError(f"{what}: unsupported B={b} S={s} N={n} "
                         f"K={nsample} F0={f0}")
    plan = sa_extract_plan(nsample, f0)
    # 16-byte accesses need pf and qc on 16-byte boundaries (a contiguous
    # view may start anywhere)
    aligned = pf.data_ptr() % 16 == 0 and qc.data_ptr() % 16 == 0
    vec = plan.vec if aligned else 1
    lib = _build.library()
    grid = _grid(dev, -(-b * s // plan.warps), plan.per_sm)
    z1 = torch.empty(b, s, nsample, f0, dtype=_BF, device=dev)
    part = torch.empty(grid, 2, f0, dtype=torch.float64, device=dev)
    sums = torch.empty(2, f0, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        code = lib.t3d_sa_extract(
            cent.data_ptr(), xyz.data_ptr(), pf.data_ptr(), qc.data_ptr(),
            z1.data_ptr(), part.data_ptr(), sums.data_ptr(), b, s, n,
            nsample, f0, radius_sq(radius), plan.warps, vec, grid,
            _build.stream_ptr(dev))
    _build.check(code, "t3d_sa_extract")
    _build.LAUNCHES["sa_extract"] += 1
    return z1, sums[0], sums[1]


def sa_fwd_step_cuda(z_prev, pack, w, b, last: bool = False):
    """Launch K6 or, with `last`, K7 on the current stream. Raises on
    anything it does not take."""
    what, dev = "sa_fwd_step_cuda", z_prev.device
    if z_prev.dim() != 4:
        raise ValueError(f"{what}: z_prev must be [B, S, K, F_in]")
    bb, s, k, f_in = z_prev.shape
    f_out = w.shape[-1]
    _need(what, dev, (("z_prev", z_prev, _BF, (bb, s, k, f_in)),
                      ("pack", pack, torch.float32, (6, f_in)),
                      ("w", w, torch.float32, (f_in, f_out)),
                      ("b", b, torch.float32, (f_out,))))
    _need_tile(what, k, f_in, f_out)
    plan = sa_fwd_plan(k, f_in, f_out, last)
    _need_smem(what, plan.smem)
    if z_prev.data_ptr() % 16:  # the tiles come in as 16-byte copies
        z_prev = z_prev.clone()
    lib = _build.library()
    grid = _grid(dev, sa_bwd_tiles(bb * s, plan.ct)[0], 1)
    # W as it is when it stays in shared memory (the kernel rounds it
    # there), else bf16(W)^T for the reads through L2
    wb = w if plan.w_smem else w.t().to(_BF).contiguous()
    z_next = torch.empty(bb, s, k, f_out, dtype=_BF, device=dev)
    part = torch.empty(grid, 2, f_out, dtype=torch.float32, device=dev)
    sums = torch.empty(2, f_out, dtype=torch.float32, device=dev)
    ext = (torch.empty(2, bb, s, f_out, dtype=torch.float32, device=dev)
           if last else None)
    with torch.cuda.device(dev):
        code = lib.t3d_sa_fwd_step(
            z_prev.data_ptr(), pack.data_ptr(), wb.data_ptr(), b.data_ptr(),
            z_next.data_ptr(), part.data_ptr(), sums.data_ptr(),
            ext[0].data_ptr() if last else None,
            ext[1].data_ptr() if last else None, bb * s, k, f_in, f_out,
            int(last), plan.ct, plan.stages, int(plan.w_smem), grid,
            _build.stream_ptr(dev))
    _build.check(code, "t3d_sa_fwd_step")
    _build.LAUNCHES["sa_fwd_last" if last else "sa_fwd_step"] += 1
    if last:
        return z_next, sums[0], sums[1], ext[0], ext[1]
    return z_next, sums[0], sums[1]


def _bwd_launch(what, step0, train, top, z_j, z_j1, dy_src, pack_j,
                pack_j1, w_j, geo):
    dev = z_j.device
    if z_j.dim() != 4 or z_j1.dim() != 4:
        raise ValueError(f"{what}: z_j and z_j1 must be [B, S, K, F]")
    b, s, k, f_j = z_j.shape
    f_j1 = z_j1.shape[-1]
    specs = [("z_j", z_j, _BF, (b, s, k, f_j)),
             ("z_j1", z_j1, _BF, (b, s, k, f_j1)),
             ("pack_j", pack_j, torch.float32, (6, f_j)),
             ("pack_j1", pack_j1, torch.float32, (6, f_j1)),
             ("w_j", w_j, torch.float32, (f_j, f_j1))]
    if top:
        pooled, dpooled = dy_src
        specs += [("pooled", pooled, _BF, (b, s, f_j1)),
                  ("dpooled", dpooled, _BF, (b, s, f_j1))]
        dy_j1 = None
    else:
        pooled = dpooled = None
        dy_j1 = dy_src
        specs.append(("dy_j1", dy_j1, _BF, (b, s, k, f_j1)))
    n = 0
    if step0:
        cent, xyz, qc, radius = geo
        n = xyz.shape[1]
        specs += [("cent", cent, torch.float32, (b, s, 3)),
                  ("xyz", xyz, torch.float32, (b, n, 3)),
                  ("qc", qc, _BF, (b, s, f_j))]
    _need(what, dev, specs)
    _need_tile(what, k, f_j, f_j1)
    if f_j * f_j1 > _TRAIN_MAX_DW:
        raise ValueError(f"{what}: dW {f_j}x{f_j1} exceeds "
                         f"{_TRAIN_MAX_DW} entries")
    if step0 and n < 1:
        raise ValueError(f"{what}: no points")
    plan = sa_bwd_plan(k, f_j, f_j1, top)
    _need_smem(what, plan.smem)
    # the tiles come in as 16-byte copies: a view at an odd offset is
    # copied to storage of its own
    z_j, z_j1, dy_j1, pooled, dpooled = (
        t if t is None or t.data_ptr() % 16 == 0 else t.clone()
        for t in (z_j, z_j1, dy_j1, pooled, dpooled))
    lib = _build.library()
    grid = _grid(dev, sa_bwd_tiles(b * s, plan.ct)[0], 1)
    wb = w_j.to(_BF)
    f32 = dict(dtype=torch.float32, device=dev)
    nsum = f_j * f_j1 + 2 * f_j + f_j1
    part = torch.empty(grid, nsum, **f32)
    sums = torch.empty(nsum, **f32)
    dy_j = None if step0 else torch.empty(b, s, k, f_j, dtype=_BF,
                                          device=dev)
    members = (None,) * 3
    if step0:
        acc = torch.empty(b * n * (2 * f_j + 1), **f32)  # H | Mq | cnt
        per_cent = torch.empty(2, b, s, f_j, **f32)
        # the members' slot sums, eff, and the zeroed rank table
        members = (torch.empty(b * s * k * f_j, **f32),
                   torch.empty(b * s, dtype=torch.int32, device=dev),
                   torch.zeros(b * n * step0_table_width(s), dtype=torch.uint8,
                               device=dev))
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(dev):
        code = lib.t3d_sa_bwd_step(
            z_j.data_ptr(), z_j1.data_ptr(), ptr(dy_j1), ptr(pooled),
            ptr(dpooled), pack_j.data_ptr(), pack_j1.data_ptr(),
            wb.data_ptr(),
            cent.data_ptr() if step0 else None,
            xyz.data_ptr() if step0 else None,
            qc.data_ptr() if step0 else None, ptr(dy_j), part.data_ptr(),
            sums.data_ptr(), *(ptr(t) for t in members),
            acc.data_ptr() if step0 else None,
            per_cent.data_ptr() if step0 else None, b, s, n, k, f_j, f_j1,
            radius_sq(radius) if step0 else 0.0, int(train), int(top),
            int(step0), plan.ct, plan.stages, int(plan.w_smem), grid,
            _build.stream_ptr(dev))
    _build.check(code, "t3d_sa_bwd_step")
    dw = sums[:f_j * f_j1].reshape(f_j, f_j1)
    sdy, sdyx, db = sums[f_j * f_j1:].split((f_j, f_j, f_j1))
    if not step0:
        return dy_j, sdy, sdyx, dw, db
    h_acc, mq, cnt = acc.split((b * n * f_j, b * n * f_j, b * n))
    return (sdy, sdyx, dw, db, h_acc.view(b, n, f_j), mq.view(b, n, f_j),
            cnt.view(b, 1, n), per_cent[0], per_cent[1])


def sa_bwd_step_cuda(train: bool, top: bool, z_j, z_j1, dy_src, pack_j,
                     pack_j1, w_j):
    """Launch K8 on the current stream. Raises on anything it does not
    take."""
    out = _bwd_launch("sa_bwd_step_cuda", False, train, top, z_j, z_j1,
                      dy_src, pack_j, pack_j1, w_j, None)
    _build.LAUNCHES["sa_bwd_step"] += 1
    return out


def sa_bwd_step0_cuda(train: bool, top: bool, z_j, z_j1, dy_src, cent, xyz,
                      qc, pack_j, pack_j1, w_j, radius: float):
    """Launch K9 on the current stream. Raises on anything it does not
    take."""
    out = _bwd_launch("sa_bwd_step0_cuda", True, train, top, z_j, z_j1,
                      dy_src, pack_j, pack_j1, w_j, (cent, xyz, qc, radius))
    _build.LAUNCHES["sa_bwd_step0"] += 1
    return out


def _on_cpu(t) -> bool:
    return t.device.type == "cpu"


def sa_extract(cent, xyz, pf, qc, radius, nsample):
    """K5 on CUDA tensors, its plain twin on CPU tensors."""
    fn = sa_extract_plain if _on_cpu(cent) else sa_extract_cuda
    return fn(cent, xyz, pf, qc, radius, nsample)


def sa_fwd_step(z_prev, pack, w, b, last=False):
    """K6/K7 on CUDA tensors, the plain twin on CPU tensors."""
    fn = sa_fwd_step_plain if _on_cpu(z_prev) else sa_fwd_step_cuda
    return fn(z_prev, pack, w, b, last)


def sa_bwd_step(train, top, z_j, z_j1, dy_src, pack_j, pack_j1, w_j):
    """K8 on CUDA tensors, its plain twin on CPU tensors."""
    fn = sa_bwd_step_plain if _on_cpu(z_j) else sa_bwd_step_cuda
    return fn(train, top, z_j, z_j1, dy_src, pack_j, pack_j1, w_j)


def sa_bwd_step0(train, top, z_j, z_j1, dy_src, cent, xyz, qc, pack_j,
                 pack_j1, w_j, radius):
    """K9 on CUDA tensors, its plain twin on CPU tensors."""
    fn = sa_bwd_step0_plain if _on_cpu(z_j) else sa_bwd_step0_cuda
    return fn(train, top, z_j, z_j1, dy_src, cent, xyz, qc, pack_j, pack_j1,
              w_j, radius)


# ---------------------------------------------------------------------------
# Host schedule and autograd function.
# ---------------------------------------------------------------------------


def _pool_epilogue(zmax, zmin, pack):
    """pooled from K7's extrema: bf16 rounding and the affine map are
    monotone per channel, so max_k relu(bf16(a z_k + c)) is
    relu(bf16(a zmax + c)) for a > 0 and of zmin otherwise. The same a
    and c as the kernels read, so `h == pooled` in K8 holds bit for bit."""
    a, c = pack[0], pack[1]
    ysel = torch.where(a > 0, a * zmax + c, a * zmin + c)
    return torch.clamp_min(ysel.to(_BF), 0)


def _schedule_forward(new_xyz, xyz, pf, qc, gammas, betas, ws, bs, radius,
                      nsample, eps, train, running):
    """`_fwd_impl` of the JAX package, rows layout, with residuals."""
    depth = len(gammas)
    b, s, _ = new_xyz.shape
    z, sums, sumsq = sa_extract(new_xyz, xyz, pf, qc, radius, nsample)
    zs, packs, means, variances = [z], [], [], []
    zmax = zmin = None
    for d in range(depth):
        if train:
            # K5's (d = 0) or K6/K7's sums over the whole batch: summed
            # over the ranks under data parallelism, with m global.
            tot, totsq, m = mesh_lib.batch_stats_sum(sums, sumsq,
                                                     b * s * nsample)
            mu = tot / m
            var = totsq / m - mu * mu
        else:
            mu, var = running[d]
        means.append(mu)
        variances.append(var)
        packs.append(_make_pack(gammas[d], betas[d], mu, var, eps))
        if d < depth - 1:
            out = sa_fwd_step(zs[d], packs[d], ws[d], bs[d],
                              last=d == depth - 2)
            z, sums, sumsq = out[:3]
            zs.append(z)
            if d == depth - 2:
                zmax, zmin = out[3:]
    pooled = _pool_epilogue(zmax, zmin, packs[-1])
    return pooled, means, variances, zs, packs, zmax, zmin


class _FusedChain(torch.autograd.Function):
    """`fused_grouped_chain` with its custom VJP (`_fgc_fwd`, `_fgc_bwd`).
    Inputs after `depth`: gammas, betas (depth each), ws, bs (depth - 1
    each). Outputs: pooled, then in train mode the batch means and
    variances, marked non-differentiable."""

    @staticmethod
    def forward(ctx, new_xyz, xyz, pf, qc, radius, nsample, eps, train,
                running, depth, *params):
        gammas, betas = params[:depth], params[depth:2 * depth]
        ws = [w.contiguous() for w in params[2 * depth:3 * depth - 1]]
        bs = params[3 * depth - 1:]
        pooled, means, variances, zs, packs, zmax, zmin = _schedule_forward(
            new_xyz, xyz, pf, qc, gammas, betas, ws, bs, radius, nsample,
            eps, train, running)
        ctx.save_for_backward(new_xyz, xyz, pf, qc, pooled, zmax, zmin,
                              *zs, *packs, *ws)
        ctx.radius, ctx.nsample, ctx.train, ctx.depth = (radius, nsample,
                                                         train, depth)
        stats = (*means, *variances) if train else ()
        ctx.mark_non_differentiable(*stats)
        return (pooled, *stats)

    @staticmethod
    def backward(ctx, dpooled, *_stats_cotangents):
        depth, train, k = ctx.depth, ctx.train, ctx.nsample
        new_xyz, xyz, pf, qc, pooled, zmax, zmin = ctx.saved_tensors[:7]
        rest = ctx.saved_tensors[7:]
        zs, packs = rest[:depth], list(rest[depth:2 * depth])
        ws = rest[2 * depth:]
        b, s = pooled.shape[:2]
        dpooled = dpooled.to(_BF).contiguous()
        dgammas, dbetas = [None] * depth, [None] * depth
        dws, dbs = [None] * (depth - 1), [None] * (depth - 1)
        dy_next = step0 = None
        for j in range(depth - 1, -1, -1):
            if j == depth - 1:
                # The top layer's BN sums from the pool extrema: the whole
                # pool cotangent goes to the one extremum row (K8's redo
                # splits it among tied rows; both are subgradients of max).
                a_l, _, mu_l, r_l = packs[j][:4]
                zsel = torch.where(a_l > 0, zmax, zmin)
                dyp = torch.where(pooled.float() > 0, dpooled.float(),
                                  torch.zeros((), device=pooled.device))
                sdy = dyp.sum(dim=(0, 1))
                sdyx = (dyp * ((zsel - mu_l) * r_l)).sum(dim=(0, 1))
            else:
                top = j == depth - 2
                dy_src = (pooled, dpooled) if top else dy_next
                if j == 0:
                    step0 = sa_bwd_step0(
                        train, top, zs[0], zs[1], dy_src, new_xyz, xyz, qc,
                        packs[0], packs[1], ws[0], ctx.radius)
                    sdy, sdyx, dws[0], dbs[0] = step0[:4]
                else:
                    dy_next, sdy, sdyx, dws[j], dbs[j] = sa_bwd_step(
                        train, top, zs[j], zs[j + 1], dy_src, packs[j],
                        packs[j + 1], ws[j])
            # The rank's own sums are its share of dbeta and dgamma: the
            # gradient all-reduce adds the shares once.
            dbetas[j], dgammas[j] = sdy, sdyx
            if train:  # rows 4-5 must be final before step j - 1 runs
                # K8/K9 of step j - 1, d_pf and d_qc read the whole
                # batch's mean dy and dy x-hat.
                sdy, sdyx, m = mesh_lib.batch_stats_sum(sdy, sdyx,
                                                        b * s * k)
                packs[j] = packs[j].clone()
                packs[j][4] = sdy / m
                packs[j][5] = sdyx / m
        # d_pf and d_qc from K9's sums (`_bwd_step0_kernel`'s docstring):
        # onehot^T z1 = cnt * pf - Mq up to z1's stored rounding.
        h_acc, mq, cnt, sdy_s, sz_s = step0[4:]
        a0, _, mu0, r0, mdy0, mdyx0 = packs[0]
        cntv = cnt.transpose(1, 2)  # [B, N, 1]
        if train:
            xoh = r0 * (cntv * pf.float() - mq - cntv * mu0)
            dpf = a0 * (h_acc - cntv * mdy0) - (a0 * mdyx0) * xoh
            sxhat = r0 * (sz_s - k * mu0)
            dqc = -(a0 * (sdy_s - k * mdy0 - mdyx0 * sxhat))
        else:
            dpf = a0 * h_acc
            dqc = -(a0 * sdy_s)
        geo = [torch.zeros_like(t) if need else None for t, need in
               zip((new_xyz, xyz), ctx.needs_input_grad[:2])]
        return (*geo, dpf.to(pf.dtype), dqc.to(qc.dtype), None, None, None,
                None, None, None, *dgammas, *dbetas, *dws, *dbs)


def _padded_chain(new_xyz, xyz, pf, qc, gammas, betas, ws, bs, radius,
                  nsample, eps, train, running, widths):
    """The chain on the card's training kernels with every width padded
    to a multiple of 16: zero channels of pf and qc, zero rows and columns
    of W, zero biases, and gamma = beta = 0 (a running variance of 1) on
    the new channels, so a = c = 0 and h = 0 there in every layer; no real
    channel's value or gradient changes. The padding is differentiable
    (`torch.nn.functional.pad`), so autograd drops its gradients."""
    dims = [_ceil16(f) for f in widths]
    run = None
    if running is not None:
        run = [(_pad_to(m, f), torch.nn.functional.pad(
            v, (0, f - v.shape[-1]), value=1.0))
               for (m, v), f in zip(running, dims)]
    pooled, means, variances = fused_grouped_chain(
        new_xyz, xyz, _pad_to(pf, dims[0]), _pad_to(qc, dims[0]),
        [_pad_to(g, f) for g, f in zip(gammas, dims)],
        [_pad_to(b, f) for b, f in zip(betas, dims)],
        *_pad_dense(dims, ws, bs), radius, nsample, eps, train, run)
    return (pooled[..., :widths[-1]],
            tuple(m[:f] for m, f in zip(means, widths)),
            tuple(v[:f] for v, f in zip(variances, widths)))


def fused_grouped_chain(new_xyz, xyz, pf, qc, gammas, betas, ws, bs,
                        radius: float, nsample: int, eps: float,
                        train: bool, running
                        ) -> Tuple[torch.Tensor, tuple, tuple]:
    """Fused ball query + grouped MLP chain + max-pool (one SA scale).

    Args as `transferable3d_tpu.ops.fused_sa.fused_grouped_chain` minus
    the TPU-only `interpret`/`layout`: new_xyz [B,S,3] f32, xyz [B,N,3]
    f32, pf [B,N,F0] bf16 (dense_0 on all points), qc [B,S,F0] bf16
    (dense_0's kernel on the centroids), BN gammas/betas per layer,
    Dense ws/bs of layers 1..L-1, running ((mean, var), ...) for eval.

    Returns (pooled [B,S,F_last] bf16, means, variances): the batch
    statistics in train mode, for the caller's running averages, else
    the running ones. Train mode, and eval mode when a gradient is
    wanted, take the multi-pass schedule (K5-K9; on the card with widths
    padded to multiples of 16, `_padded_chain`); eval without a gradient
    takes K2. The geometry gets a zero gradient.
    """
    depth = len(gammas)
    if depth < 2:
        raise ValueError("fused_grouped_chain requires chain depth >= 2")
    if pf.dtype != torch.bfloat16 or qc.dtype != torch.bfloat16:
        raise ValueError(f"pf and qc must be bfloat16, got {pf.dtype}, "
                         f"{qc.dtype}")
    new_xyz, xyz = new_xyz.contiguous(), xyz.contiguous()
    pf, qc = pf.contiguous(), qc.contiguous()
    wants_grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (pf, qc, *gammas, *betas, *ws, *bs))
    widths = [g.shape[-1] for g in gammas]
    if (pf.is_cuda and (train or wants_grad)
            and any(f % 16 for f in widths)):
        return _padded_chain(new_xyz, xyz, pf, qc, gammas, betas, ws, bs,
                             radius, nsample, eps, train, running, widths)
    if not train:
        means = tuple(r[0] for r in running)
        variances = tuple(r[1] for r in running)
        if not wants_grad:
            packs = [_make_pack(gammas[d], betas[d], means[d], variances[d],
                                eps) for d in range(depth)]
            pooled = sa_infer(new_xyz, xyz, pf, qc, radius, nsample, packs,
                              [w.contiguous() for w in ws], list(bs))
            return pooled, means, variances
    out = _FusedChain.apply(new_xyz, xyz, pf, qc, radius, nsample, eps,
                            train, running, depth, *gammas, *betas, *ws,
                            *bs)
    if train:
        means, variances = out[1:1 + depth], out[1 + depth:]
    return out[0], tuple(means), tuple(variances)
