"""On-device frustum preprocessing: depth map or point cloud + 2D boxes
-> fixed-size frustum point clouds in the frustum frame.

Port of `transferable3d_tpu/data/frustum_jit.py`, batched over frames
and boxes where the JAX code is vmapped:

  * depth [H, W] lifts to a dense point grid (invalid depths masked);
  * per 2D box: the in-box mask (half-open in u and v), and `npoints`
    sampled among the masked points by a systematic rank-select: slot s
    takes the in-box point of rank 1 + floor((slot_s + u) * count /
    npoints) in index order, with u a random phase in [0, 1) per box.
    Uniform marginal inclusion; without replacement when count >=
    npoints, a cyclic wrap otherwise; an empty frustum gives zeros. The
    slots come out in a shuffled order (`_slot_order`), never in scan
    order;
  * the frustum angle from the box-center ray, and the points rotated
    about +Y so that ray hits +Z.

The fetch is kernel K15 (csrc/fetch_select.cu) with its plain twin
`fetch_select_plain` beside it; CPU tensors take the twin, CUDA tensors
the kernel. Both gather the exact f32 point: the JAX kernel returns the
point's bf16 hi + lo parts summed (its matrix unit rounds operands to
bf16), which is the same index and up to 7.4e-6 relative away. The pass
has no gradient and runs under `torch.no_grad()`.

The random phases come from an explicit `torch.Generator` (drawn on the
generator's device) or are passed in as an array; there is no global
random state. Inputs may be numpy arrays or tensors; the work runs on
`device` (default: the card, `transferable3d_torch.default_device`).
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple, Tuple, Union

import numpy as np
import torch

from transferable3d_torch import resolve_device
from transferable3d_torch.core import geometry
from transferable3d_torch.ops import _build

# K15's launch shape (csrc/fetch_select.cu): a group of up to 8 blocks
# a frustum (the portable thread-block cluster size), each owning a span
# of 32-point words and keeping 8 bytes of shared memory a word.
FETCH_MAX_GROUP = 8
_FETCH_MAX_SPAN = 28_672     # words: 229,376 bytes, the kernel's kMaxSpan
# Below 512 words (16 KB of mask) a second block only adds the latency of
# the group's barrier; some 2 x 132 blocks of 512 threads fill an H100.
_FETCH_MIN_SPAN = 512
_FETCH_FILL = 2 * 132
FETCH_MAX_POINTS = FETCH_MAX_GROUP * _FETCH_MAX_SPAN * 32   # 7,340,032


class FetchPlan(NamedTuple):
    """How K15 covers one shape: `group` blocks a frustum (a cluster
    where more than one), each owning `span` 32-point words (the last one
    at least one), `vec` mask bytes a load, and a block's dynamic shared
    memory in bytes."""
    group: int
    span: int
    vec: int
    smem: int


@lru_cache(maxsize=None)
def fetch_select_plan(n: int, frustums: int) -> FetchPlan:
    """K15's launch shape for `frustums` masks of `n` points: as many
    blocks a frustum as fill the card, at most 8, none with fewer than
    512 words unless the span's shared memory needs more blocks."""
    if n < 1 or frustums < 1:
        raise ValueError(f"fetch_select_plan: N={n}, {frustums} frustums")
    nwords = -(-n // 32)
    need = -(-nwords // _FETCH_MAX_SPAN)
    if need > FETCH_MAX_GROUP:
        raise ValueError(f"fetch_select: N={n} exceeds {FETCH_MAX_POINTS} "
                         f"points per frame")
    fill = min(FETCH_MAX_GROUP, _FETCH_FILL // frustums,
               nwords // _FETCH_MIN_SPAN)
    group = max(1, need, fill)
    span = -(-nwords // group)
    group = -(-nwords // span)   # every block owns at least one word
    vec = 16 if n % 16 == 0 else 4 if n % 4 == 0 else 1
    return FetchPlan(group, span, vec, span * 8)


class FrustumBatch(NamedTuple):
    points: torch.Tensor         # [..., MB, npoints, C] in the frustum frame
    frustum_angle: torch.Tensor  # [..., MB]
    count: torch.Tensor          # [..., MB] int32 in-box points per frustum
    idx: torch.Tensor            # [..., MB, npoints] int32 point taken (-1:
    #                              empty frustum)


def _tensor(x, device, dtype=torch.float32) -> torch.Tensor:
    return torch.as_tensor(x).to(device=device, dtype=dtype)


def depth_to_camera_points(depth: torch.Tensor, K: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depth [..., H, W] (meters; <= 0 invalid) -> (points [..., H*W, 3],
    valid [..., H*W]). Camera frame: X right, Y down, Z forward."""
    h, w = depth.shape[-2:]
    u = torch.arange(w, dtype=torch.float32, device=depth.device)
    v = torch.arange(h, dtype=torch.float32, device=depth.device)[:, None]
    x = (u - K[0, 2]) * depth / K[0, 0]
    y = (v - K[1, 2]) * depth / K[1, 1]
    lead = depth.shape[:-2]
    pts = torch.stack([x, y, depth], dim=-1).reshape(*lead, h * w, 3)
    return pts, (depth > 1e-6).reshape(*lead, h * w)


@lru_cache(maxsize=None)
def _slot_order(npoints: int) -> np.ndarray:
    """Fixed pseudorandom permutation of the output slots.

    Monotone slots would emit points in scan order, and
    `model_util.point_cloud_masking` keeps the first `num_object_point`
    masked points in input order: an object whose mask exceeds that
    budget would feed the box net only its top-of-image slice. The
    permutation is the JAX package's (`RandomState(0x53A1)`); a cyclic
    offset per frustum from the phase u decorrelates the order across
    frustums (`want_ranks`)."""
    return np.random.RandomState(0x53A1).permutation(npoints).astype(
        np.float32)


@lru_cache(maxsize=None)
def _slot_order_on(npoints: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_slot_order(npoints)).to(device)


def want_ranks(u: torch.Tensor, count: torch.Tensor, npoints: int
               ) -> torch.Tensor:
    """The 1-based rank each slot takes: u [...] f32 phases, count [...]
    f32 -> [..., npoints] f32 (integer-valued).

    f32 arithmetic in the JAX code's order, every op rounded on its own
    (`_select_prelude`, frustum_jit.py:121-125): the kernel repeats it
    with `__fmul_rn`/`__fadd_rn`/`__fdiv_rn`, and one different rounding
    would change an index. The divisor is a tensor on the device: PyTorch
    divides a CUDA tensor by a Python number as a product with its
    rounded reciprocal, which is another value when `npoints` is not a
    power of two."""
    npf = u.new_full((), float(npoints))
    u, count = u[..., None], count[..., None]
    slot = _slot_order_on(npoints, u.device) + torch.floor(u * npf)
    slot = torch.where(slot >= npf, slot - npf, slot)
    want = 1.0 + torch.floor((slot + u) * count / npf)
    return torch.minimum(want, count.clamp_min(1.0))


def _check_fetch_args(pts, inside, u, npoints) -> None:
    if (pts.dim() != 3 or inside.dim() != 3 or u.dim() != 2
            or inside.shape[0] != pts.shape[0]
            or inside.shape[2] != pts.shape[1]
            or tuple(u.shape) != tuple(inside.shape[:2])):
        raise ValueError(
            f"fetch_select takes pts [F, N, C], inside [F, MB, N] and u "
            f"[F, MB], got {tuple(pts.shape)}, {tuple(inside.shape)}, "
            f"{tuple(u.shape)}")
    if (pts.dtype != torch.float32 or inside.dtype != torch.bool
            or u.dtype != torch.float32):
        raise ValueError(
            f"fetch_select takes float32 pts and u and a bool mask, got "
            f"{pts.dtype}, {u.dtype}, {inside.dtype}")
    if npoints < 1 or 0 in inside.shape or pts.shape[2] < 1:
        raise ValueError(f"fetch_select: empty shape {tuple(pts.shape)}, "
                         f"{tuple(inside.shape)}, npoints {npoints}")


def fetch_select_plain(pts: torch.Tensor, inside: torch.Tensor,
                       u: torch.Tensor, npoints: int
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch twin of K15: ranks by a cumulative sum of the mask,
    a binary search per slot, a gather. Same contract as `fetch_select`."""
    _check_fetch_args(pts, inside, u, npoints)
    f, n, c = pts.shape
    csum = torch.cumsum(inside, dim=-1, dtype=torch.int32)     # [F, MB, N]
    count = csum[..., -1]
    want = want_ranks(u, count.float(), npoints).to(torch.int32)
    # The first index whose inclusive rank reaches `want`.
    idx = torch.searchsorted(csum, want, out_int32=True)       # [F, MB, np]
    empty = (count == 0)[..., None]
    frame = torch.arange(f, device=pts.device)[:, None, None]
    sampled = pts[frame, idx.clamp(max=n - 1).long()]          # [F,MB,np,C]
    sampled = torch.where(empty[..., None], torch.zeros_like(sampled),
                          sampled)
    idx = torch.where(empty, torch.full_like(idx, -1), idx)
    return sampled, idx, count


def fetch_select_cuda(pts: torch.Tensor, inside: torch.Tensor,
                      u: torch.Tensor, npoints: int
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch K15 on the current stream in the shape `fetch_select_plan`
    gives; contiguous CUDA tensors."""
    _check_fetch_args(pts, inside, u, npoints)
    if not (pts.device.type == "cuda" and inside.device == pts.device
            and u.device == pts.device):
        raise ValueError(
            f"fetch_select_cuda needs CUDA tensors on one device, got "
            f"{pts.device}, {inside.device}, {u.device}")
    if not (pts.is_contiguous() and inside.is_contiguous()
            and u.is_contiguous()):
        raise ValueError("fetch_select_cuda needs contiguous tensors")
    f, n, c = pts.shape
    mb = inside.shape[1]
    plan = fetch_select_plan(n, f * mb)
    # 16- and 4-byte loads need the mask on such a boundary (a contiguous
    # view may start anywhere)
    vec = plan.vec if inside.data_ptr() % plan.vec == 0 else 1
    lib = _build.library()
    dev = pts.device
    perm = _slot_order_on(npoints, dev)
    sampled = torch.empty(f, mb, npoints, c, dtype=torch.float32, device=dev)
    idx = torch.empty(f, mb, npoints, dtype=torch.int32, device=dev)
    count = torch.empty(f, mb, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        code = lib.t3d_fetch_select(
            pts.data_ptr(), inside.data_ptr(), u.data_ptr(),
            perm.data_ptr(), sampled.data_ptr(), idx.data_ptr(),
            count.data_ptr(), f, mb, n, c, npoints, plan.group, plan.span,
            vec, _build.stream_ptr(dev))
    _build.check(code, "t3d_fetch_select")
    _build.LAUNCHES["fetch_select"] += 1
    return sampled, idx, count


def fetch_select(pts: torch.Tensor, inside: torch.Tensor, u: torch.Tensor,
                 npoints: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Systematic rank-select of `npoints` rows per frustum.

    pts [F, N, C] f32 (one point grid per frame, shared by its boxes),
    inside [F, MB, N] bool, u [F, MB] f32 phases in [0, 1) ->
    (sampled [F, MB, npoints, C] f32, idx [F, MB, npoints] int32,
    count [F, MB] int32). A frustum with count 0 gives zero rows and idx
    -1. CPU tensors take the plain twin; CUDA tensors take the kernel."""
    if pts.device.type == "cpu":
        return fetch_select_plain(pts, inside, u, npoints)
    return fetch_select_cuda(pts, inside, u, npoints)


Phases = Union[torch.Generator, torch.Tensor, np.ndarray]


def _phases(rng: Phases, shape, device) -> torch.Tensor:
    """One phase u in [0, 1) per box: drawn from a generator on the
    generator's device, or taken as given."""
    if isinstance(rng, torch.Generator):
        u = torch.rand(shape, generator=rng, device=rng.device)
        return u.to(device)
    u = _tensor(rng, device)
    if tuple(u.shape) != tuple(shape):
        raise ValueError(f"phases of shape {tuple(u.shape)} for boxes of "
                         f"shape {tuple(shape)}")
    return u


def _sample_batch(pts: torch.Tensor, uv: torch.Tensor, valid: torch.Tensor,
                  boxes2d: torch.Tensor, K: torch.Tensor, npoints: int,
                  u: torch.Tensor) -> FrustumBatch:
    """All frustums of all frames: pts [F, N, C], uv [F or 1, N, 2], valid
    [F, N], boxes2d [F, MB, 4], u [F, MB]. Mask the points per 2D box,
    fetch `npoints` of them, rotate to the frustum frame."""
    box = boxes2d[:, :, None, :]                              # [F, MB, 1, 4]
    pu, pv = uv[:, None, :, 0], uv[:, None, :, 1]             # [F|1, 1, N]
    inside = (valid[:, None, :]
              & (pu >= box[..., 0]) & (pu < box[..., 2])
              & (pv >= box[..., 1]) & (pv < box[..., 3]))     # [F, MB, N]
    sampled, idx, count = fetch_select(pts.contiguous(), inside.contiguous(),
                                       u.contiguous(), npoints)

    # Frustum angle from the 2D box center ray (unit depth).
    cu = (boxes2d[..., 0] + boxes2d[..., 2]) / 2.0
    rx = (cu - K[0, 2]) / K[0, 0]
    angle = -torch.atan2(rx, torch.ones_like(rx))
    xyz = geometry.rotate_points_y(sampled[..., :3], angle)
    if sampled.shape[-1] > 3:
        xyz = torch.cat([xyz, sampled[..., 3:]], dim=-1)
    return FrustumBatch(points=xyz, frustum_angle=angle, count=count,
                        idx=idx)


@torch.no_grad()
def lift_depth_frustums(depth, K, boxes2d, npoints: int, rng: Phases,
                        device=None) -> FrustumBatch:
    """Depth map(s) + 2D boxes -> FrustumBatch.

    depth [H, W] with boxes2d [MB, 4] (one frame, as the JAX function
    takes it) or depth [F, H, W] with boxes2d [F, MB, 4]; `rng` a
    `torch.Generator` or the phases themselves ([MB] or [F, MB])."""
    device = resolve_device(device)
    depth, K = _tensor(depth, device), _tensor(K, device)
    boxes2d = _tensor(boxes2d, device)
    single = depth.dim() == 2
    if single:
        depth, boxes2d = depth[None], boxes2d[None]
        if not isinstance(rng, torch.Generator):
            rng = _tensor(rng, device)[None]
    u = _phases(rng, boxes2d.shape[:2], device)
    h, w = depth.shape[-2:]
    pts, valid = depth_to_camera_points(depth, K)
    pu = torch.arange(w, dtype=torch.float32, device=device).expand(h, w)
    pv = torch.arange(h, dtype=torch.float32,
                      device=device)[:, None].expand(h, w)
    uv = torch.stack([pu, pv], dim=-1).reshape(1, h * w, 2)
    out = _sample_batch(pts, uv, valid, boxes2d, K, npoints, u)
    return FrustumBatch(*(x[0] for x in out)) if single else out


@torch.no_grad()
def crop_point_frustums(points, K, boxes2d, npoints: int, rng: Phases,
                        device=None) -> FrustumBatch:
    """Point-cloud variant (a lidar cloud already in the camera frame):
    points [N, 3+C] + boxes2d [MB, 4] -> FrustumBatch by projection and
    crop; the extra channels are carried through."""
    device = resolve_device(device)
    points, K = _tensor(points, device), _tensor(K, device)
    boxes2d = _tensor(boxes2d, device)
    u = _phases(rng, boxes2d.shape[:1], device)
    xyz = points[:, :3]
    z = xyz[:, 2].clamp_min(1e-6)
    pu = K[0, 0] * xyz[:, 0] / z + K[0, 2]
    pv = K[1, 1] * xyz[:, 1] / z + K[1, 2]
    uv = torch.stack([pu, pv], dim=-1)[None]
    valid = (xyz[:, 2] > 1e-6)[None]
    out = _sample_batch(points[None], uv, valid, boxes2d[None], K, npoints,
                        u[None])
    return FrustumBatch(*(x[0] for x in out))
