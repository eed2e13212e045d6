"""Farthest-point sampling: CUDA kernel K1 (csrc/fps.cu) + plain twin.

Port of `transferable3d_tpu/ops/sampling.py`. Selection rule (shared by
the JAX scan `_fps_ref`, the Pallas `_fps_kernel` and both versions
here): seed index 0, running distance starting at 1e10,
dist = min(dist, (dx*dx + dy*dy) + dz*dz) to the last pick, next pick =
argmax with the first index winning ties. Indices are int32 [B, k].
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from transferable3d_torch.ops import _build
from transferable3d_torch.ops.grouping import flat_row_gather

# The kernel keeps a copy of one batch row's points in shared memory (16
# bytes a point), and beyond 4,096 points their running distances too.
FPS_MAX_POINTS = 12288
_FPS_REG_POINTS = 4096


class FpsPlan(NamedTuple):
    """How K1 runs one batch row of n points: `threads` a block and
    `per_thread` points a thread in registers (4 up to 2,048 points, 8 up
    to 4,096), or 0 with the points and distances in shared memory and
    1,024 threads; `smem` bytes of dynamic shared memory."""
    threads: int
    per_thread: int
    smem: int


@functools.lru_cache(maxsize=None)
def fps_plan(n: int) -> FpsPlan:
    """K1's block for n points (mirrored by `t3d_fps`'s checks in
    csrc/fps.cu): as few warps as hold the points in registers."""
    if not 1 <= n <= FPS_MAX_POINTS:
        raise ValueError(f"fps: N={n} not in [1, {FPS_MAX_POINTS}]")
    per = 4 if n <= 2048 else 8 if n <= _FPS_REG_POINTS else 0
    threads = 1024 if per == 0 else (-(-n // per) + 31) // 32 * 32
    return FpsPlan(threads, per, 16 * n)


def fps_plain(xyz: torch.Tensor, k: int) -> torch.Tensor:
    """Plain PyTorch FPS, op for op the JAX `_fps_ref` (no fused
    multiply-add: each product and sum is its own rounded op)."""
    b, n, _ = xyz.shape
    out = torch.zeros(b, k, dtype=torch.int32, device=xyz.device)
    if k == 1:
        return out
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
        last = torch.argmax(dist, dim=1)  # first index wins ties
        out[:, i] = last.to(torch.int32)
    return out


def fps_cuda(xyz: torch.Tensor, k: int) -> torch.Tensor:
    """Launch K1 on the current stream; xyz [B, N, 3] f32 contiguous."""
    if xyz.device.type != "cuda":
        raise ValueError(f"fps_cuda needs a CUDA tensor, got {xyz.device}")
    if xyz.dtype != torch.float32 or xyz.dim() != 3 or xyz.shape[-1] != 3:
        raise ValueError(
            f"fps_cuda takes float32 [B, N, 3], got {xyz.dtype} "
            f"{tuple(xyz.shape)}")
    if not xyz.is_contiguous():
        raise ValueError("fps_cuda needs a contiguous xyz")
    b, n, _ = xyz.shape
    if not (1 <= n <= FPS_MAX_POINTS) or k < 1 or b < 1:
        raise ValueError(f"fps_cuda: unsupported B={b} N={n} k={k}")
    plan = fps_plan(n)
    lib = _build.library()
    out = torch.empty(b, k, dtype=torch.int32, device=xyz.device)
    with torch.cuda.device(xyz.device):
        code = lib.t3d_fps(xyz.data_ptr(), out.data_ptr(), b, n, k,
                           plan.threads, plan.per_thread,
                           _build.stream_ptr(xyz.device))
    _build.check(code, "t3d_fps")
    _build.LAUNCHES["fps"] += 1
    return out


def farthest_point_sample(xyz: torch.Tensor, k: int) -> torch.Tensor:
    """FPS indices [B, k] int32 over xyz [B, N, 3] (first pick = 0).

    CPU tensors take the plain twin; CUDA tensors take the kernel."""
    xyz = xyz.detach()
    if k == 1:
        return torch.zeros(xyz.shape[0], 1, dtype=torch.int32,
                           device=xyz.device)
    if xyz.device.type == "cpu":
        return fps_plain(xyz, k)
    return fps_cuda(xyz, k)


def gather_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """points [B, N, C], idx [B, S] -> [B, S, C]."""
    return flat_row_gather(points, idx)
