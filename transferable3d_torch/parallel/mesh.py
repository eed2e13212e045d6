"""Data parallelism over `torch.distributed`: ranks, sharding, collectives.

Port of `transferable3d_tpu/parallel/mesh.py`. There the batch is
sharded on axis 0 over a 1-D `data` mesh, the state is replicated, and
XLA computes the same global function as on one device: BatchNorm
statistics and loss means over the whole batch, one gradient. Here each
rank is a process with a `Mesh` (its rank, the world size, its device,
the backend and the process group), and the same function is kept by
three explicit sums across the ranks:

  * BatchNorm statistics (`batch_stats_sum`): the per-channel sum and sum
    of squares, forward and backward (`all_reduce_sum`), with the global
    row count, in `ScheduledBatchNorm` and in the fused chain's schedule
    (`ops/fused_sa.py`, K5-K9's sums);
  * loss and metric denominators (`global_count`): every mean over the
    batch is the sum over the rank's rows divided by the global count;
  * one all-reduce of all gradients after the backward
    (`all_reduce_grads`), which with global denominators is the
    whole-batch gradient.

Every rank takes the whole batch's dropout mask from an equally seeded
generator and keeps its own rows (`models/layers.dropout`), so W ranks
compute the 1-rank step mask for mask.

The mesh is made current once, by `use(mesh)` around a rank's work (the
drivers' `run_data_parallel`); the steps, the checkpoint manager and the
collectives read it there (`active()`). With none, or a mesh without a
process group, the collectives are the identity and cost nothing: the
1-rank step runs the ops it ran before data parallelism. A mesh of one
rank with a group (as a 1-rank NCCL group) runs every collective.

Backend rule: NCCL where each rank of the host has a card of its own,
gloo where ranks share a card or run on the CPU. A group that fails to
form raises. `data_points_mesh` (points-axis sharding) is not ported.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os
import sys
from typing import (Any, Callable, Dict, Iterator, List, Optional, Sequence,
                    Tuple)

import numpy as np
import torch
import torch.distributed as dist

# How long a rank waits for the others at the rendezvous and at a
# collective before it raises.
TIMEOUT = datetime.timedelta(seconds=600)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of a 1-D data-parallel mesh."""
    rank: int
    world_size: int
    device: torch.device
    backend: Optional[str]   # "nccl" | "gloo" | None (no process group)
    group: Any = None        # torch.distributed ProcessGroup or None


def choose_backend(device: torch.device, local_world_size: int,
                   cards: int) -> str:
    """NCCL when each of the host's `local_world_size` ranks has a card of
    its own among `cards`; gloo when ranks share a card or run on the
    CPU."""
    if device.type == "cuda" and local_world_size <= cards:
        return "nccl"
    return "gloo"


_LOGGED = set()


def _log_once(msg: str) -> None:
    if msg not in _LOGGED:
        _LOGGED.add(msg)
        print(msg, file=sys.stderr, flush=True)


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, default))


def data_parallel_mesh(devices: Optional[Sequence] = None, *,
                       rank: Optional[int] = None,
                       world_size: Optional[int] = None,
                       local_rank: Optional[int] = None,
                       local_world_size: Optional[int] = None,
                       init_method: Optional[str] = None) -> Mesh:
    """This rank's mesh over all (or the given) devices.

    `devices` are the host's devices (default: every card); local rank r
    runs on `devices[r % len(devices)]`. Rank, world size and local rank
    come from the arguments, else from the launcher's environment (RANK,
    WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE, as torchrun sets them),
    else 0 and 1. An initialised default group is wrapped as it is;
    otherwise a group is formed when `init_method` is given ("env://",
    "file://...", "tcp://...") or the world has more than one rank. With
    one rank and no `init_method` the mesh has no group and every
    collective is the identity. The backend follows `choose_backend`."""
    if dist.is_available() and dist.is_initialized():
        rank, world_size = dist.get_rank(), dist.get_world_size()
    rank = _env_int("RANK", 0) if rank is None else rank
    world_size = (_env_int("WORLD_SIZE", 1) if world_size is None
                  else world_size)
    local_rank = (_env_int("LOCAL_RANK", rank) if local_rank is None
                  else local_rank)
    local_world_size = (_env_int("LOCAL_WORLD_SIZE", world_size)
                        if local_world_size is None else local_world_size)
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "data_parallel_mesh found no NVIDIA GPU; pass "
                "devices=[\"cpu\"] to run the ranks on the CPU")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    device = devices[local_rank % len(devices)]
    if device.type == "cuda":
        torch.cuda.set_device(device)
    cards = len({d for d in devices if d.type == "cuda"})
    backend = choose_backend(device, local_world_size, cards)
    if dist.is_initialized():
        group, backend = dist.group.WORLD, dist.get_backend()
    elif init_method is None and world_size == 1:
        return Mesh(rank=0, world_size=1, device=device, backend=None)
    else:
        dist.init_process_group(
            backend, init_method=init_method or "env://", rank=rank,
            world_size=world_size, timeout=TIMEOUT)
        group = dist.group.WORLD
    if rank == 0:
        why = ("each rank has a card of its own" if backend == "nccl"
               else "ranks share a card" if device.type == "cuda"
               else "ranks run on the CPU")
        _log_once(f"data_parallel_mesh: {world_size} rank(s), backend "
                  f"{backend} ({why})")
    return Mesh(rank=rank, world_size=world_size, device=device,
                backend=backend, group=group)


def destroy(mesh: Optional[Mesh]) -> None:
    """Tear down the mesh's process group (a no-op without one)."""
    if mesh is not None and mesh.group is not None and dist.is_initialized():
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# The current mesh
# ---------------------------------------------------------------------------

_ACTIVE: List[Mesh] = []


def active() -> Optional[Mesh]:
    """The mesh of the innermost `use`, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


@contextlib.contextmanager
def use(mesh: Optional[Mesh]) -> Iterator[Optional[Mesh]]:
    """Make `mesh` current for the collectives inside the block (None
    keeps the current one)."""
    if mesh is None:
        yield active()
        return
    _ACTIVE.append(mesh)
    try:
        yield mesh
    finally:
        _ACTIVE.pop()


def _grouped() -> Optional[Mesh]:
    m = active()
    return m if m is not None and m.group is not None else None


def world_size() -> int:
    m = active()
    return 1 if m is None else m.world_size


def rank() -> int:
    """The current mesh's rank (0 without one): rank 0 writes the logs
    and checkpoints."""
    m = active()
    return 0 if m is None else m.rank


# ---------------------------------------------------------------------------
# Sharding
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BatchSharding:
    """Axis 0 split into `world_size` equal blocks, block r on rank r."""
    rank: int
    world_size: int

    def rows(self, batch_size: int) -> slice:
        if batch_size % self.world_size:
            raise ValueError(f"batch {batch_size} not divisible by "
                             f"{self.world_size} ranks")
        per = batch_size // self.world_size
        return slice(self.rank * per, (self.rank + 1) * per)


@dataclasses.dataclass(frozen=True)
class Replicated:
    """Every rank holds rank `src`'s copy."""
    src: int = 0


def batch_sharding(mesh: Mesh) -> BatchSharding:
    """Shard axis 0 (batch) across the ranks."""
    return BatchSharding(mesh.rank, mesh.world_size)


def replicated(mesh: Mesh) -> Replicated:
    return Replicated(0)


def _map(fn: Callable, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def local_rows(tree):
    """The current mesh's rank's rows of `tree` (`_rows`); `tree` itself
    without a mesh."""
    return _rows(tree, active())


def _rows(tree, mesh: Optional[Mesh]):
    """Rank r's rows [r B/W, (r+1) B/W) of every array or tensor of
    `tree` on axis 0, where they are (numpy stays numpy); 0-d values and
    other leaves are kept whole."""
    if mesh is None or mesh.world_size == 1:
        return tree
    sh = batch_sharding(mesh)

    def rows(x):
        if (isinstance(x, np.ndarray) or torch.is_tensor(x)) and x.ndim:
            return x[sh.rows(x.shape[0])]
        return x
    return _map(rows, tree)


def shard_batch(batch: Any, mesh: Mesh) -> Any:
    """This rank's rows of every array of a global batch on axis 0, as
    tensors on the rank's device (`local_rows`, then placed)."""
    def place(x):
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(x))
        return x.to(mesh.device) if torch.is_tensor(x) else x
    return _map(place, _rows(batch, mesh))


def _state_tensors(state) -> Tuple[List[torch.Tensor], Callable[[], None]]:
    """The tensors that make a module or a `train_loop.TrainState` (the
    model's parameters and buffers; Adam's state, the accumulated
    gradient and the counters; the step; the dropout generator's state)
    in a fixed order, and a function that sets what is not held in place
    (counters, step, generator) from them."""
    if isinstance(state, torch.nn.Module):
        return list(state.state_dict().values()), lambda: None
    opt = state.optimizer
    tensors = list(state.model.state_dict().values())
    for p in opt.params:
        st = opt.adam.state.get(p, {})
        tensors += [st[k] for k in sorted(st) if torch.is_tensor(st[k])]
    tensors += opt.acc or []
    counts = torch.tensor([opt.count, opt.mini_step, state.step])
    gen = state.generator.get_state()

    def set_rest():
        opt.count, opt.mini_step, state.step = (int(c) for c in counts)
        state.generator.set_state(gen)
    return tensors + [counts, gen], set_rest


def _flat_apply(tensors: Sequence[torch.Tensor], device,
                op: Callable[[torch.Tensor], None]) -> None:
    """`op` on one flat buffer a dtype holding `tensors` (in order) on
    `device`, and the result copied back into them."""
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.detach().reshape(-1).to(device) for t in ts])
        op(flat)
        for t, part in zip(ts, flat.split([t.numel() for t in ts])):
            t.detach().copy_(part.view_as(t))


def replicate(state: Any, mesh: Mesh) -> Any:
    """Every rank takes rank 0's copy of a module or a train state: its
    parameters, buffers, optimizer state, step and dropout generator
    state (one broadcast a dtype). Returns `state`, updated in place."""
    if mesh.group is None:
        return state
    tensors, set_rest = _state_tensors(state)
    _flat_apply(tensors, mesh.device, lambda flat: dist.broadcast(
        flat, src=replicated(mesh).src, group=mesh.group))
    set_rest()
    return state


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------

class _AllReduceSum(torch.autograd.Function):
    """y = the sum of x over the ranks, read by every rank. Its VJP is the
    sum of the ranks' cotangents: the objective is the sum of the ranks'
    shares."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.detach().clone().contiguous()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, dy):
        g = dy.detach().clone().contiguous()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of `x` over the current mesh's ranks, differentiable; the
    identity without a process group."""
    m = _grouped()
    return x if m is None else _AllReduceSum.apply(x, m.group)


def batch_stats_sum(s: torch.Tensor, s2: torch.Tensor, rows: int):
    """BatchNorm's per-channel sums over the rank's `rows` rows (the sum
    and the sum of squares, or sum dy and sum dy x-hat) summed over the
    ranks, and the global row count: (s, s2, rows * W), in one
    all-reduce of their stack, differentiable. Without a group, the
    arguments themselves."""
    m = _grouped()
    if m is None:
        return s, s2, rows
    both = all_reduce_sum(torch.stack([s, s2]))
    return both[0], both[1], rows * m.world_size


def batch_moments(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The per-channel means of `x` and `x * x` over every axis but the
    last (the rows) and the whole batch: plain means without a group,
    else the rank's sums through `batch_stats_sum` over the global row
    count."""
    dims = tuple(range(x.dim() - 1))
    if _grouped() is None:
        return x.mean(dim=dims), (x * x).mean(dim=dims)
    s, s2, rows = batch_stats_sum(x.sum(dim=dims), (x * x).sum(dim=dims),
                                  x.numel() // x.shape[-1])
    return s / rows, s2 / rows


def global_count(count):
    """A loss or metric denominator over the whole batch: a Python
    number times W (every rank holds as many rows), a tensor summed over
    the ranks without a gradient (the counts are data)."""
    m = _grouped()
    if m is None:
        return count
    if torch.is_tensor(count):
        c = count.detach().clone().contiguous()
        dist.all_reduce(c, group=m.group)
        return c
    return count * m.world_size


def batch_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of `x` over all its elements and the whole batch:
    `torch.mean(x)` without a group, else the sum over this rank's rows
    over the global element count."""
    if _grouped() is None:
        return torch.mean(x)
    return torch.sum(x) / global_count(x.numel())


def all_reduce_grads(params: Sequence[torch.nn.Parameter]) -> None:
    """Sum every parameter's gradient over the ranks, in place, as one
    buffer in parameter order (a None gradient counts as zeros and is
    set). With global loss denominators the sum is the whole-batch
    gradient; no averaging follows."""
    m = _grouped()
    if m is None:
        return
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    _flat_apply([p.grad for p in params], m.device,
                lambda flat: dist.all_reduce(flat, group=m.group))


def reduce_metrics(metrics: Dict[str, Any]) -> Dict[str, Any]:
    """The tensor metrics (each rank's share of a whole-batch mean) summed
    over the ranks, in one all-reduce; other values are kept."""
    m = _grouped()
    if m is None:
        return metrics
    keys = [k for k, v in metrics.items() if torch.is_tensor(v)]
    if not keys:
        return metrics
    vals = [metrics[k].detach().float().clone() for k in keys]
    _flat_apply(vals, m.device,
                lambda flat: dist.all_reduce(flat, group=m.group))
    return {**metrics, **dict(zip(keys, vals))}


def any_rank(flag: bool) -> bool:
    """True on every rank of the current mesh when `flag` is true on
    any."""
    m = _grouped()
    if m is None:
        return flag
    t = torch.tensor([1.0 if flag else 0.0], device=m.device)
    dist.all_reduce(t, group=m.group)
    return bool(t.item() > 0)


def barrier() -> None:
    """Wait for every rank of the current mesh (a no-op without a
    process group)."""
    m = _grouped()
    if m is None:
        return
    if m.backend == "nccl":
        dist.barrier(group=m.group, device_ids=[m.device.index])
    else:
        dist.barrier(group=m.group)
