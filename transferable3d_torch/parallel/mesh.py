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
form raises.

Points-axis sharding (`data_points_mesh`): D x P ranks, rank r at
(r // P, r % P), the batch's rows split over D and each frustum's points
over P. Each collective sums over the group of its scope: the
**sharded** scope (the default) over every rank, for tensors split over
both axes (the seg net's per-point tensors); the **replicated over
points** scope (`replicated_over_points()`, which the models enter around
their box stages) over the data group, the ranks that share a point
slice, for per-frustum tensors that every rank of a points group holds
whole. Under the sharded scope of a points mesh, `points_max` pools and
`points_gather` gathers across the points group (the ranks that share a
batch slice). On a 1-D mesh both scopes sum over every rank.

A per-frustum tensor that every rank of a points group holds whole has
two cotangent conventions: under the sharded scope each rank holds its
share of the cotangent (the group's shares add up to it, as
`points_max` and `points_gather` sum them), under the replicated scope
each rank holds all of it. Where such a tensor crosses from one scope
to the other, an identity converts its cotangent: `to_replicated` (a
pool handed to a replicated head: the whole cotangent stays on points
index 0, the shares elsewhere are zero) and `from_replicated` (a
replicated box read by per-point work on the rank's slice: the shares
are summed over the points group).
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

from transferable3d_torch.utils import profiling

# How long a rank waits for the others at the rendezvous and at a
# collective before it raises.
TIMEOUT = datetime.timedelta(seconds=600)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of a data-parallel mesh: 1-D, or (data, points)
    with `points` > 1. `data_group` holds the ranks that share this
    rank's point slice (every rank on a 1-D mesh; None when it is this
    rank alone), `points_group` the ranks that share its batch slice
    (None on a 1-D mesh)."""
    rank: int
    world_size: int
    device: torch.device
    backend: Optional[str]   # "nccl" | "gloo" | None (no process group)
    group: Any = None        # torch.distributed ProcessGroup or None
    points: int = 1
    points_group: Any = None
    data_group: Any = None

    @property
    def data(self) -> int:
        return self.world_size // self.points

    @property
    def coords(self) -> Tuple[int, int]:
        """(data index, points index): rank r sits at (r // P, r % P)."""
        return divmod(self.rank, self.points)


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
                backend=backend, group=group, data_group=group)


def data_points_mesh(data: int, points: int,
                     devices: Optional[Sequence] = None, *,
                     rank: Optional[int] = None,
                     world_size: Optional[int] = None,
                     local_rank: Optional[int] = None,
                     local_world_size: Optional[int] = None,
                     init_method: Optional[str] = None) -> Mesh:
    """This rank's view of a (data, points) mesh of `data` x `points`
    ranks: batch data parallelism times points-axis sharding, the
    sequence-parallel analogue (JAX: `data_points_mesh`). Rank r sits at
    (r // points, r % points). The per-point MLPs need nothing across
    ranks; the max-pools over points, the BN statistics, the masking and
    the v2 grouping do (module docstring).

    Devices, rank and the group as `data_parallel_mesh` (the world size
    defaults to data x points and must equal it). Every rank forms the
    points groups (ranks d P ... d P + P - 1), then the data groups
    (ranks p, P + p, ...), in that order."""
    if data < 1 or points < 1:
        raise ValueError(f"a ({data}, {points}) mesh has no ranks")
    if world_size is None:
        world_size = _env_int("WORLD_SIZE", data * points)
    mesh = data_parallel_mesh(
        devices, rank=rank, world_size=world_size, local_rank=local_rank,
        local_world_size=local_world_size, init_method=init_method)
    if mesh.world_size != data * points:
        raise ValueError(f"a ({data}, {points}) mesh needs {data * points} "
                         f"ranks, not {mesh.world_size}")
    if points == 1:
        return mesh
    if data == 1:
        points_group, data_group = mesh.group, None
    else:
        p_groups = [dist.new_group(list(range(d * points, (d + 1) * points)))
                    for d in range(data)]
        d_groups = [dist.new_group(list(range(p, data * points, points)))
                    for p in range(points)]
        d, p = divmod(mesh.rank, points)
        points_group, data_group = p_groups[d], d_groups[p]
    if mesh.rank == 0:
        _log_once(f"data_points_mesh: ({data}, {points})")
    return dataclasses.replace(mesh, points=points,
                               points_group=points_group,
                               data_group=data_group)


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


_REPLICATED: List[bool] = []


@contextlib.contextmanager
def replicated_over_points() -> Iterator[None]:
    """The block works on per-frustum tensors that every rank of a points
    group holds whole (the box stages after the masking): its collectives
    sum over the data group, and nothing pools or gathers across the
    points group. No effect on a 1-D mesh or without one."""
    _REPLICATED.append(True)
    try:
        yield
    finally:
        _REPLICATED.pop()


def _reducing() -> Optional[Tuple[Any, int]]:
    """The group the current scope sums over and its size (module
    docstring), or None for the identity: no process group, or the
    replicated scope on a mesh whose data group is this rank alone."""
    m = _grouped()
    if m is None:
        return None
    if _REPLICATED and m.points > 1:
        return None if m.data_group is None else (m.data_group, m.data)
    return m.group, m.world_size


def _points_group():
    """The points group under the sharded scope of a points mesh, else
    None."""
    m = _grouped()
    if m is None or m.points == 1 or _REPLICATED:
        return None
    return m.points_group


def points_size() -> int:
    """P under the sharded scope of a points mesh (the number of slices of
    each frustum's points), else 1."""
    return 1 if _points_group() is None else active().points


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
    """Axis 0 split into `data` equal blocks, block `data_index` here;
    on a points mesh axis 1 of the arrays that hold points split into
    `points` equal slices, slice `points_index` here."""
    data_index: int
    data: int
    points_index: int = 0
    points: int = 1

    def rows(self, batch_size: int) -> slice:
        return _block(batch_size, self.data_index, self.data, "batch",
                      "ranks")

    def point_slice(self, n: int) -> slice:
        return _block(n, self.points_index, self.points, "points axis",
                      "points ranks")

    def holds_points(self, x) -> bool:
        """JAX's rule: an array is split on axis 1 too when that axis is
        larger than a label vector (16) and divisible by P."""
        return (self.points > 1 and x.ndim >= 2 and x.shape[1] > 16
                and x.shape[1] % self.points == 0)


def _block(n: int, i: int, k: int, what: str, whose: str) -> slice:
    if n % k:
        raise ValueError(f"{what} {n} not divisible by {k} {whose}")
    per = n // k
    return slice(i * per, (i + 1) * per)


@dataclasses.dataclass(frozen=True)
class Replicated:
    """Every rank holds rank `src`'s copy."""
    src: int = 0


def batch_sharding(mesh: Mesh) -> BatchSharding:
    """Shard axis 0 (batch) across the data axis; axis 1 (points) across
    the points axis where the mesh has one."""
    d, p = mesh.coords
    return BatchSharding(d, mesh.data, p, mesh.points)


def replicated(mesh: Mesh) -> Replicated:
    return Replicated(0)


def _map(fn: Callable, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def local_rows(tree):
    """The current mesh's rank's block of `tree` (`_rows`); `tree` itself
    without a mesh."""
    return _rows(tree, active())


def _rows(tree, mesh: Optional[Mesh]):
    """This rank's rows [d B/D, (d+1) B/D) of every array or tensor of
    `tree` on axis 0 and, on a points mesh, its slice of axis 1 where
    `BatchSharding.holds_points` (points, seg labels; label vectors keep
    axis 1 whole), where they are (numpy stays numpy); 0-d values and
    other leaves are kept whole."""
    if mesh is None or mesh.world_size == 1:
        return tree
    sh = batch_sharding(mesh)

    def rows(x):
        if not ((isinstance(x, np.ndarray) or torch.is_tensor(x))
                and x.ndim):
            return x
        x = x[sh.rows(x.shape[0])]
        return x[:, sh.point_slice(x.shape[1])] if sh.holds_points(x) else x
    return _map(rows, tree)


def whole_shape(shape: Sequence[int], per_point: bool) -> Tuple[int, ...]:
    """The whole batch's shape of a tensor of `shape` on this rank: axis 0
    times D and, for a per-point tensor ([B, N, ...]) under the sharded
    scope of a points mesh, axis 1 times P."""
    m = active()
    if m is None:
        return tuple(shape)
    out = [shape[0] * m.data, *shape[1:]]
    if per_point:
        out[1] *= points_size()
    return tuple(out)


def local_block(x: torch.Tensor, per_point: bool) -> torch.Tensor:
    """This rank's block of a tensor of `whole_shape(..., per_point)`:
    its rows and, where that widened axis 1, its point slice."""
    m = active()
    if m is None:
        return x
    x = x[batch_sharding(m).rows(x.shape[0])]
    return points_slice(x) if per_point else x


def points_slice(x: torch.Tensor) -> torch.Tensor:
    """This rank's slice of axis 1 (a points axis held whole) under the
    sharded scope of a points mesh; `x` itself otherwise."""
    if _points_group() is None:
        return x
    return x[:, batch_sharding(active()).point_slice(x.shape[1])]


def shard_batch(batch: Any, mesh: Mesh) -> Any:
    """This rank's block of every array of a global batch (`_rows`: its
    rows and, on a points mesh, the point slice of the arrays that hold
    points), as tensors on the rank's device."""
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
    """The sum of `x` over the current scope's ranks (module docstring),
    differentiable; the identity without a group to sum over."""
    r = _reducing()
    return x if r is None else _AllReduceSum.apply(x, r[0])


def batch_stats_sum(s: torch.Tensor, s2: torch.Tensor, rows: int):
    """BatchNorm's per-channel sums over the rank's `rows` rows (the sum
    and the sum of squares, or sum dy and sum dy x-hat) summed over the
    scope's ranks, and the global row count: (s, s2, rows * their
    number), in one all-reduce of their stack, differentiable. Without a
    group, the arguments themselves."""
    r = _reducing()
    if r is None:
        return s, s2, rows
    both = all_reduce_sum(torch.stack([s, s2]))
    return both[0], both[1], rows * r[1]


def batch_moments(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The per-channel means of `x` and `x * x` over every axis but the
    last (the rows) and the whole batch: plain means without a group,
    else the rank's sums through `batch_stats_sum` over the global row
    count."""
    dims = tuple(range(x.dim() - 1))
    if _reducing() is None:
        return x.mean(dim=dims), (x * x).mean(dim=dims)
    s, s2, rows = batch_stats_sum(x.sum(dim=dims), (x * x).sum(dim=dims),
                                  x.numel() // x.shape[-1])
    return s / rows, s2 / rows


def global_count(count):
    """A loss or metric denominator over the whole batch: a Python
    number times the scope's ranks (each holds as many rows), a tensor
    summed over them without a gradient (the counts are data)."""
    r = _reducing()
    if r is None:
        return count
    if torch.is_tensor(count):
        c = count.detach().clone().contiguous()
        dist.all_reduce(c, group=r[0])
        return c
    return count * r[1]


def batch_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of `x` over all its elements and the whole batch:
    `torch.mean(x)` without a group, else the sum over this rank's block
    over the global element count."""
    if _reducing() is None:
        return torch.mean(x)
    return torch.sum(x) / global_count(x.numel())


def mean_over_points(x: torch.Tensor) -> torch.Tensor:
    """The mean of a per-point tensor [B, N, ...] over every axis but the
    first: `torch.mean` off a points mesh, else the rank's sum over the
    whole frustum's count (its share of the mean; the shares of the
    points group add up to it)."""
    dims = tuple(range(1, x.dim()))
    p = points_size()
    if p == 1:
        return torch.mean(x, dim=dims)
    return torch.sum(x, dim=dims) / (x[0].numel() * p)


class _PointsMax(torch.autograd.Function):
    """y = the max of x over axis `dim` of the whole frustum: the local
    max, then a MAX all-reduce over the points group. Every rank's loss
    share reads y, so its VJP first sums the cotangent over the group,
    then hands it to the local elements equal to y, divided by the
    number of such elements on every rank (`torch.amax`'s and `jnp.max`'s
    rule for ties). The collectives run in float32 (exact for the max)."""

    @staticmethod
    def forward(ctx, x, dim, group):
        y = x.detach().amax(dim=dim).float().contiguous()
        dist.all_reduce(y, op=dist.ReduceOp.MAX, group=group)
        y = y.to(x.dtype)
        ctx.save_for_backward(x, y)
        ctx.dim, ctx.group = dim, group
        return y

    @staticmethod
    def backward(ctx, dy):
        x, y = ctx.saved_tensors
        hit = x == y.unsqueeze(ctx.dim)
        both = torch.stack([dy.float(), hit.sum(dim=ctx.dim).float()])
        dist.all_reduce(both, group=ctx.group)
        share = (both[0] / both[1]).to(x.dtype).unsqueeze(ctx.dim)
        zero = torch.zeros((), dtype=x.dtype, device=x.device)
        return torch.where(hit, share, zero), None, None


def points_max(x: torch.Tensor, dim: int) -> torch.Tensor:
    """`x.amax(dim)` over a points axis: across the points group under
    the sharded scope of a points mesh (differentiable, `_PointsMax`),
    the local `amax` otherwise."""
    g = _points_group()
    return x.amax(dim=dim) if g is None else _PointsMax.apply(x, dim, g)


def points_min(x: torch.Tensor, dim: int) -> torch.Tensor:
    """`x.amin(dim)` over a points axis: `points_max` of -x under the
    sharded scope of a points mesh, the local `amin` otherwise."""
    if _points_group() is None:
        return x.amin(dim=dim)
    return -points_max(-x, dim)


def points_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of a per-point tensor [B, N, ...] over axis 1, the whole
    frustum's on every rank: `torch.mean` off a points mesh, else the
    rank's sum added over the points group over N x P (differentiable,
    `_AllReduceSum`: its cotangent is taken as the sharded scope's
    shares)."""
    g = _points_group()
    if g is None:
        return x.mean(dim=1)
    return (_AllReduceSum.apply(x.sum(dim=1), g)
            / (x.shape[1] * active().points))


class _FromReplicated(torch.autograd.Function):
    """y = x, where x is held whole by every rank of the points group
    (a replicated-scope tensor) and y is read by per-point work on the
    rank's slice: each rank's cotangent of y is its points' share, so
    x's cotangent is their sum over the group (float32)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        g = dy.detach().float().contiguous()
        dist.all_reduce(g, group=ctx.group)
        return g.to(dy.dtype), None


class _ToReplicated(torch.autograd.Function):
    """y = x, where x is held whole by every rank of the points group
    and y is read by the replicated scope, whose cotangent every rank
    holds whole: points index 0 passes it on as its share, the other
    ranks pass zeros, so a sum over the group (`points_max`'s backward)
    counts it once."""

    @staticmethod
    def forward(ctx, x, keep):
        ctx.keep = keep
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        return (dy if ctx.keep else torch.zeros_like(dy)), None


def from_replicated(x: torch.Tensor) -> torch.Tensor:
    """A per-frustum tensor of the replicated scope (every rank of the
    points group holds it and its cotangent whole) read under the sharded
    scope by per-point work on the rank's slice (`_FromReplicated`: the
    backward sums the group's shares); `x` itself off a points mesh or
    inside the replicated scope."""
    g = _points_group()
    return x if g is None else _FromReplicated.apply(x, g)


def to_replicated(x: torch.Tensor) -> torch.Tensor:
    """A tensor that every rank of the points group holds whole (a pool
    across the group) handed from the sharded scope to the replicated
    one (`_ToReplicated`: the whole cotangent becomes points index 0's
    share); `x` itself off a points mesh or inside the replicated
    scope."""
    if _points_group() is None:
        return x
    return _ToReplicated.apply(x, active().coords[1] == 0)


class _PointsGather(torch.autograd.Function):
    """y = the points group's slices of x, in points order, along axis 1
    (a float32 all-gather: exact). Every rank's loss share reads all of
    y, so x's cotangent is the group's summed cotangent of y at this
    rank's slice: a reduce-scatter where the backend has one (NCCL),
    else an all-reduce and a slice (gloo)."""

    @staticmethod
    def forward(ctx, x, group, points, index, backend):
        part = x.detach().float().contiguous()
        parts = [torch.empty_like(part) for _ in range(points)]
        dist.all_gather(parts, part, group=group)
        ctx.group, ctx.points, ctx.index = group, points, index
        ctx.backend, ctx.dtype = backend, x.dtype
        return torch.cat(parts, dim=1).to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        chunks = [c.float().contiguous() for c in dy.chunk(ctx.points, dim=1)]
        if ctx.backend == "nccl":
            g = torch.empty_like(chunks[ctx.index])
            dist.reduce_scatter(g, chunks, group=ctx.group)
        else:
            g = torch.cat(chunks, dim=1)
            dist.all_reduce(g, group=ctx.group)
            g = g.chunk(ctx.points, dim=1)[ctx.index]
        return g.to(ctx.dtype), None, None, None, None


def points_gather(x: torch.Tensor) -> torch.Tensor:
    """The whole frustum's points (axis 1) from the points group's slices
    under the sharded scope of a points mesh, differentiable
    (`_PointsGather`); `x` itself otherwise."""
    g = _points_group()
    if g is None:
        return x
    m = active()
    return _PointsGather.apply(x, g, m.points, m.coords[1], m.backend)


def all_reduce_grads(params: Sequence[torch.nn.Parameter],
                     replicated: Sequence[torch.nn.Parameter] = ()) -> None:
    """Sum every parameter's gradient over the ranks, in place, as one
    buffer in parameter order (a None gradient counts as zeros and is
    set). With global loss denominators the sum is the whole-batch
    gradient; no averaging follows. On a points mesh the parameters in
    `replicated` (those of the stages that ran under
    `replicated_over_points`, whose gradient every rank of a points group
    holds whole) are summed over the data group instead, in a buffer of
    their own."""
    m = _grouped()
    if m is None:
        return
    with profiling.span("t3d.all_reduce"):
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        rep = {id(p) for p in replicated} if m.points > 1 else set()
        for group, ps in ((m.group, [p for p in params
                                     if id(p) not in rep]),
                          (m.data_group, [p for p in params
                                          if id(p) in rep])):
            if ps and group is not None:
                _flat_apply([p.grad for p in ps], m.device,
                            lambda flat: dist.all_reduce(flat, group=group))


def reduce_metrics(metrics: Dict[str, Any]) -> Dict[str, Any]:
    """The tensor metrics (each rank's share of a whole-batch mean) summed
    over the current scope's ranks, in one all-reduce; other values are
    kept."""
    r = _reducing()
    if r is None:
        return metrics
    keys = [k for k, v in metrics.items() if torch.is_tensor(v)]
    if not keys:
        return metrics
    vals = [metrics[k].detach().float().clone() for k in keys]
    _flat_apply(vals, active().device, lambda flat: dist.all_reduce(
        flat, group=r[0]))
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
