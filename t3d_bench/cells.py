"""One run of one cell: set-up, the measured window, the traced stretch,
and the check of what the window's own entry produced.

Training (`mode: train` in the traffic mix): the records are made from
the seed and uploaded once as the program's device-resident dataset;
the model is the registry's, with every parameter and BN buffer made on
the card from the seed in one call; each step draws its batch on the
card (`device_dataset.sample_batch`, flip and shift) and runs the
program's `train_loop.make_train_step`. The set-up drives that one step
object through its first three steps, which the check compares with the
reference, and warms it up; the window then runs it closed-loop for
`--seconds`. On several chips the ranks are the program's own
(`train_sup.run_data_parallel`), each drawing the global batch and
training on its rows.

Serving (`mode: serve`): a pool of batches of frustums in pinned host
memory; each call of the program's `make_predict_step` takes the next
batch and copies its detections to the host before the next call is
issued. Each call is timed on the host's clock from its issue until its
detections are in host memory, for the tail of the window's calls.
"""

from __future__ import annotations

import dataclasses
import functools
import gc
import json
import math
import sys
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from t3d_bench import bench, judge, trace as trace_lib
from t3d_bench.reference import fpointnet as ref_lib
from t3d_bench.traffic import frustums
from t3d_bench.work import counts

# The profiler's schedule in a traced run: steps skipped, warmed, kept.
TRACE_WAIT, TRACE_WARMUP = 2, 2
# The set-up's steps that the check compares with the reference.
CHECKED_STEPS = 3


@dataclasses.dataclass(frozen=True)
class Run:
    cell: str
    chips: int
    seed: int
    seconds: float
    trace: bool
    t0_wall: float            # the process's start, time.time()
    cfg: Dict                 # configs/<config>.json
    mix: Dict                 # traffic/<traffic>.json
    knobs: Dict               # workloads/<cell>.json
    per_layer: Tuple[Tuple[str, str], ...] = ()   # (name, unit)
    faults: Tuple[str, ...] = ()   # planted faults (the fault tests)
    judged: str = "program"   # or "control": the fp8 reference judged
    detail: bool = False      # the worst leaves on stderr (readings.py)


def seeds(seed: int) -> Dict[str, int]:
    """Independent sub-seeds of the run's seed (any whole number)."""
    words = np.random.SeedSequence(seed % 2 ** 64).generate_state(
        6, dtype=np.uint32)
    return dict(zip(("records", "weights", "draws", "dropout", "order",
                     "sample"), (int(w) for w in words)))


def bins_of(cfg: Dict) -> ref_lib.Bins:
    return ref_lib.Bins(cfg["bins"]["mean_sizes"],
                        cfg["bins"]["num_heading_bin"])


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# ---------------------------------------------------------------------------
# Inputs: records and weights, made by the benchmark from the seed
# ---------------------------------------------------------------------------

def make_records(run: Run) -> List[Dict]:
    return frustums.make_records(run.mix, run.cfg["bins"]["mean_sizes"],
                                 run.cfg["num_channels"],
                                 seeds(run.seed)["records"])


def make_weights(shapes: Dict[str, torch.Size], seed: int, device
                 ) -> Dict[str, torch.Tensor]:
    """Every parameter and BN buffer from one normal draw on `device`:
    dense weights at lecun scale (clipped at two sigma), biases, BN
    shifts and running means around 0, BN scales and running variances
    around 1."""
    total = sum(math.prod(s) for s in shapes.values())
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device).clamp_(-2, 2)
    out, off = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        x = flat[off:off + n].view(shape)
        off += n
        if name.endswith(".weight"):
            x = x * (1.0 / math.sqrt(shape[1]) / 0.8796256610342398)
        elif name.endswith(".scale"):
            x = 1.0 + 0.1 * x
        elif name.endswith(".var"):
            x = 1.0 + 0.25 * x.abs()
        else:
            x = 0.1 * x
        out[name] = x.contiguous()
    return out


def build_model(run: Run, device):
    """The program's model through its registry, holding the weights made
    from the seed; (model, weights, bins config)."""
    from transferable3d_torch.core import bins as bins_lib
    from transferable3d_torch.models import registry

    cfg = run.cfg
    bins_cfg = {"sunrgbd": bins_lib.SUNRGBD,
                "kitti": bins_lib.KITTI}[cfg["bins"]["dataset"]]
    dtype = {"bfloat16": torch.bfloat16,
             "float32": torch.float32}[cfg["compute_dtype"]]
    model = registry.get_model(
        cfg["model"], bins_cfg, dtype=dtype, device=device,
        in_channels=cfg["num_channels"],
        generator=torch.Generator().manual_seed(seeds(run.seed)["weights"]))
    sd = model.state_dict()
    # A mix may serve one model: its weights from the mix's own seed, the
    # traffic from the run's (random weights draw a random seg mask, and
    # the mask sets the box net's ball sizes, that is the work).
    weights = make_weights({k: v.shape for k, v in sd.items()},
                           run.mix.get("weights_seed",
                                       seeds(run.seed)["weights"]), device)
    with torch.no_grad():
        for k, v in sd.items():
            v.copy_(weights[k])
    return model, weights, bins_cfg


# ---------------------------------------------------------------------------
# The measured window
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Window:
    steps: int
    seconds: float
    events: Optional[List[trace_lib.Event]] = None
    # Seconds a step after the traced stretch, without the profiler.
    step_seconds: Optional[float] = None


def measure(step: Callable[[int], None], seconds: float, trace_steps: int,
            device, any_rank: Callable[[bool], bool] = lambda f: f
            ) -> Window:
    """`step(i)` closed-loop inside `t3d_bench.step` spans until
    `seconds` have passed (on every rank: `any_rank`), then the device
    synchronised; with `trace_steps`, a profiler schedule keeps that
    many steps after TRACE_WAIT + TRACE_WARMUP, and the steps after it
    give the unprofiled seconds a step. The interpreter's collector is
    frozen for the window: its pauses would land in the steps."""
    import torch.profiler as tp

    prof, got = None, {}
    end_traced = TRACE_WAIT + TRACE_WARMUP + trace_steps
    if trace_steps:
        acts = [tp.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(tp.ProfilerActivity.CUDA)

        def ready(p):
            got["events"] = trace_lib.events_from_profiler(p)

        prof = tp.profile(activities=acts, on_trace_ready=ready,
                          schedule=tp.schedule(wait=TRACE_WAIT,
                                               warmup=TRACE_WARMUP,
                                               active=trace_steps, repeat=1))
        prof.start()
    gc.collect()
    gc.freeze()
    gc.disable()
    n, after = 0, None
    t0 = time.perf_counter()
    end = t0 + seconds
    try:
        while True:
            with tp.record_function(trace_lib.STEP_SPAN):
                step(n)
            n += 1
            if prof is not None:
                prof.step()
                if n == end_traced:
                    after = (n, time.perf_counter())
            if any_rank(time.perf_counter() >= end):
                break
        _sync(device)
        t1 = time.perf_counter()
    finally:
        gc.enable()
        gc.unfreeze()
    if prof is not None:
        prof.stop()
    step_s = ((t1 - after[1]) / (n - after[0])
              if after is not None and n > after[0] else None)
    return Window(n, t1 - t0, got.get("events"), step_s)


def _traced(i: int, trace_steps: int) -> bool:
    lo = TRACE_WAIT + TRACE_WARMUP
    return trace_steps > 0 and lo <= i < lo + trace_steps


class SaCapture:
    """The centroids and support points of every grouped SA call made
    while `on` (forward pre-hooks), for the SA rooflines."""

    def __init__(self, model):
        from transferable3d_torch.models.pointnet2 import GroupedPointMLP

        self.on = False
        self.calls = []
        self.handles = [m.register_forward_pre_hook(self._hook)
                        for m in model.modules()
                        if isinstance(m, GroupedPointMLP)]

    def _hook(self, mod, args):
        if self.on:
            self.calls.append((mod.radius, mod.nsample, mod.features,
                               args[0].detach(), args[1].detach()))

    def close(self) -> List[Dict]:
        """Each captured call's shapes and unique ball members."""
        for h in self.handles:
            h.remove()
        out = []
        for radius, k, widths, cent, xyz in self.calls:
            _, count = ref_lib.ball_slots(cent.float(), xyz.float(), radius,
                                          k)
            out.append({"b": cent.shape[0], "s": cent.shape[1],
                        "n": xyz.shape[1], "widths": list(widths),
                        "unique_rows": float(torch.clamp(count, 1, k).sum())})
        self.calls = []
        return out


@dataclasses.dataclass
class Readings:
    """What the per-layer readers (metrics/<name>.py) read."""
    train: bool
    cfg: Dict
    frustums_per_step: int
    chips: int
    kind: str
    stretches: List[trace_lib.Stretch]
    peak_window_bytes: List[int]
    sa_calls: List[Dict]
    # Each rank's seconds a step after the traced stretch (no profiler).
    step_seconds: List[float] = dataclasses.field(default_factory=list)

    @property
    def peak(self) -> Dict[str, float]:
        return counts.peaks(self.kind)


def per_layer(run: Run, rd: Readings) -> Dict[str, Dict]:
    out = {}
    for name, unit in run.per_layer:
        v = bench.reader(name)(rd)
        if v is not None:
            out[name] = {"value": v, "unit": unit}
    return out


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

def _schedules(run: Run):
    from transferable3d_torch.train import schedules

    o, b = run.cfg["train"], run.mix["batch"]
    lr = schedules.exponential_staircase_lr(
        o["learning_rate"], o["lr_decay_rate"], o["lr_decay_samples"], b,
        o["min_lr"])
    bn = schedules.bn_momentum_schedule(
        o["bn_init_decay"], o["bn_decay_rate"], o["bn_decay_samples"], b,
        o["bn_decay_clip"])
    return lr, bn


def _opt(run: Run) -> Dict:
    return {**run.cfg["train"], "batch_size": run.mix["batch"]}


def train_body(run: Run, device=None) -> Optional[Dict]:
    """The training cell on this process's card (a rank's, under the
    program's mesh); rank 0's result, None on the other ranks."""
    from transferable3d_torch import resolve_device
    from transferable3d_torch.data import device_dataset
    from transferable3d_torch.data.provider import FrustumRecord
    from transferable3d_torch.parallel import mesh as mesh_lib
    from transferable3d_torch.train import train_loop, train_sup

    device = resolve_device(device)
    train_sup.f32_numerics()
    mesh = mesh_lib.active()
    rank = mesh_lib.rank()
    mix, cfg = run.mix, run.cfg
    s = seeds(run.seed)
    clock = _Phases()
    records = make_records(run)
    clock("records")
    model, weights, bins_cfg = build_model(run, device)
    clock("model")
    data = device_dataset.build_device_dataset(
        [FrustumRecord(points=r["points"], seg=r["seg"],
                       class_idx=r["class_idx"],
                       frustum_angle=r["frustum_angle"], center=r["center"],
                       size=r["size"], heading=r["heading"])
         for r in records], bins_cfg, max_points=mix["max_points"],
        device=device)
    clock("dataset")
    lr, bn = _schedules(run)
    step_cfg = train_loop.StepConfig(
        box_loss_weight=cfg["train"]["box_loss_weight"],
        corner_loss_weight=cfg["train"]["corner_loss_weight"],
        use_valid_weights="half_batch" in run.faults)
    state = train_loop.create_train_state(
        model, train_loop.make_optimizer(lr),
        generator=torch.Generator(device=device).manual_seed(s["dropout"]))
    if mesh is not None:
        mesh_lib.replicate(state, mesh)
    step = train_loop.make_train_step(bins_cfg, lr, bn, step_cfg)
    if "no_exchange" in run.faults:
        mesh_lib.all_reduce_grads = lambda params, replicated=(): None
    draws = torch.Generator(device=device).manual_seed(s["draws"])
    order = frustums.step_indices(mix["records"], mix["batch"], s["order"])

    def next_batch():
        idx = torch.as_tensor(next(order), device=device)
        batch = device_dataset.sample_batch(
            data, draws, idx, mix["npoints"], bins_cfg,
            mix["random_flip"], mix["random_shift"])
        if "half_batch" in run.faults:
            # The loss's mean over the first half of the rows alone.
            b = idx.shape[0]
            batch["valid"] = (torch.arange(b, device=device)
                              < b // 2).float()
        return mesh_lib.local_rows(batch), idx

    def run_step(batch):
        nonlocal state
        if "unchanged" in run.faults:
            keep = {k: v.clone() for k, v in model.state_dict().items()}
        state, metrics = step(state, batch)
        if "unchanged" in run.faults:
            with torch.no_grad():
                for k, v in model.state_dict().items():
                    v.copy_(keep[k])
        return metrics

    # Set-up: the first steps, which the check compares, then warm-up.
    seg = {}
    hook = model.seg_net.register_forward_hook(
        lambda m, i, o: seg.__setitem__("logits", o.detach()))
    prog = {"loss": [], "masks": [], "idx": [], "before": weights}
    for t in range(CHECKED_STEPS):
        batch, idx = next_batch()
        metrics = run_step(batch)
        prog["loss"].append(metrics["total_loss"])
        if t == 0:
            prog["terms"] = {k: v for k, v in metrics.items()
                             if k.endswith("_loss") and k != "total_loss"}
        logits = seg["logits"]
        prog["masks"].append((logits[..., 1] > logits[..., 0]).float())
        prog["idx"].append(idx)
        if t == 0:
            adam = state.optimizer.adam
            prog["grad"] = {k: adam.state[p]["exp_avg"] / (1 - 0.9)
                            for k, p in model.named_parameters()}
    hook.remove()
    prog["after"] = {k: v.detach().clone()
                     for k, v in model.state_dict().items()}
    _sync(device)
    clock("checked steps")
    for _ in range(run.knobs["warmup_steps"]):
        run_step(next_batch()[0])
    _sync(device)
    clock("warm-up")
    setup_s = time.time() - run.t0_wall
    clock.report(setup_s)

    peak_setup = _peak(device, reset=True)
    trace_steps = run.knobs["trace_steps"] if run.trace else 0
    capture = SaCapture(model) if run.trace else None

    def window_step(i):
        if capture is not None:
            capture.on = _traced(i, trace_steps)
        run_step(next_batch()[0])

    any_rank = mesh_lib.any_rank if mesh is not None else (lambda f: f)
    win = measure(window_step, run.seconds, trace_steps, device, any_rank)
    peak_window = _peak(device)
    sa_calls = capture.close() if capture is not None else []
    stretch = (trace_lib.stretch_from_events(win.events)
               if win.events else None)

    prog["loss"] = [float(v) for v in prog["loss"]]
    prog["terms"] = {k: float(v) for k, v in prog["terms"].items()}
    if mesh is not None:
        prog["masks"] = [_gather_rows(m, mesh) for m in prog["masks"]]
        gathered = _gather_objects(
            (stretch if rank == 0 or stretch is None else
             dataclasses.replace(stretch, host=[]),
             max(peak_setup, peak_window), peak_window, win.step_seconds),
            mesh)
    else:
        gathered = [(stretch, max(peak_setup, peak_window), peak_window,
                     win.step_seconds)]
    del state, model, data, step, capture
    forbidden = bench.forbidden_modules()
    if forbidden:
        raise RuntimeError(f"loaded forbidden modules: {forbidden}")
    if rank != 0:
        _free(device)
        mesh_lib.barrier()
        return None
    _free(device)
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"
    frames = [frustums.frustum_frame(r, mix["max_points"]) for r in records]
    numbers = judge_train(run, frames, records, prog, device)
    if mesh is not None:
        mesh_lib.barrier()
    stretches = [g[0] for g in gathered]
    rd = Readings(True, cfg, mix["batch"], run.chips, kind,
                  [x for x in stretches if x is not None],
                  [g[2] for g in gathered], sa_calls,
                  [g[3] for g in gathered if g[3] is not None])
    e2e = {"train_frustums_per_s": (win.steps * mix["batch"] / win.seconds,
                                    "frustums/s")}
    return _result(run, setup_s, max(g[1] for g in gathered), win.steps,
                   rd, numbers, e2e, kind)


def judge_train(run: Run, frames, records, prog: Dict, device
                ) -> Dict[str, float]:
    """The reference's steps from the same weights, records, indices and
    seeds, on the program's masks, and the numbers compared."""
    s = seeds(run.seed)
    rec = ref_lib.Records(frames, [r["class_idx"] for r in records],
                          [r["size"] for r in records],
                          run.mix["max_points"], device)
    with _no_tf32():
        ref = ref_lib.train_steps(
            run.cfg, prog["before"], rec, prog["idx"],
            s["draws"], s["dropout"], _opt(run), bins_of(run.cfg),
            run.mix["npoints"], masks=prog["masks"])
    if run.detail:
        print("detail " + json.dumps(judge.worst_leaves(prog, ref)),
              file=sys.stderr)
    return judge.train_numbers(prog, ref)


def control_train(run: Run, device) -> Dict[str, float]:
    """The control: the reference in fp8 put in the program's place on
    the cell's inputs, judged as the program is."""
    s = seeds(run.seed)
    records = make_records(run)
    frames = [frustums.frustum_frame(r, run.mix["max_points"])
              for r in records]
    model, weights, _ = build_model(run, device)
    del model
    rec = ref_lib.Records(frames, [r["class_idx"] for r in records],
                          [r["size"] for r in records],
                          run.mix["max_points"], device)
    order = frustums.step_indices(run.mix["records"], run.mix["batch"],
                                  s["order"])
    idx = [torch.as_tensor(next(order), device=device)
           for _ in range(CHECKED_STEPS)]
    with _no_tf32():
        low = ref_lib.train_steps(
            run.cfg, weights, rec, idx, s["draws"], s["dropout"],
            _opt(run), bins_of(run.cfg), run.mix["npoints"],
            prec=ref_lib.Precision("fp8"))
    prog = {"loss": low["loss"], "grad": low["grad"], "after": low["after"],
            "masks": low["masks"], "before": weights, "idx": idx}
    del low, rec
    _free(device)
    return judge_train(run, frames, records, prog, device)


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

def serve_body(run: Run, device=None) -> Dict:
    from transferable3d_torch import resolve_device
    from transferable3d_torch.train import train_loop, train_sup

    device = resolve_device(device)
    train_sup.f32_numerics()
    mix = run.mix
    s = seeds(run.seed)
    clock = _Phases()
    records = make_records(run)
    pool = frustums.serving_batches(records, mix,
                                    len(run.cfg["bins"]["classes"]),
                                    s["sample"])
    clock("records")
    model, weights, bins_cfg = build_model(run, device)
    clock("model")
    model.eval()
    predict = train_loop.make_predict_step(model, bins_cfg)
    feed = ([frustums.pinned(b) for b in pool] if device.type == "cuda"
            else pool)
    seg = {}
    hook = model.seg_net.register_forward_hook(
        lambda m, i, o: seg.__setitem__("logits", o))

    nh = run.cfg["bins"]["num_heading_bin"]

    def call(i):
        out = predict(feed[i % len(feed)])
        if "answer_altered" in run.faults:  # one frustum's box, moved
            out["center"] = out["center"].clone()
            out["center"][0, 0] += 0.5
        if "wrong_bin" in run.faults:  # one frustum's heading bin, the next
            out["heading_class"] = out["heading_class"].clone()
            out["heading_class"][0] = (out["heading_class"][0] + 1) % nh
            out["heading"] = out["heading"].clone()
            out["heading"][0] += 2 * math.pi / nh
        return {k: v.cpu() for k, v in out.items()}

    for i in range(run.knobs["warmup_calls"]):
        call(i)
    _sync(device)
    clock("warm-up")
    setup_s = time.time() - run.t0_wall
    clock.report(setup_s)
    sampled = _sampled_calls(run)
    kept, latency = {}, []
    peak_setup = _peak(device, reset=True)
    trace_steps = run.knobs["trace_steps"] if run.trace else 0
    capture = SaCapture(model) if run.trace else None

    def window_call(i):
        if capture is not None:
            capture.on = _traced(i, trace_steps)
        t = time.perf_counter()
        out = call(i)
        latency.append(time.perf_counter() - t)
        if i in sampled:
            kept[i] = (out, seg["logits"])

    win = measure(window_call, run.seconds, trace_steps, device)
    peak_window = _peak(device)
    sa_calls = capture.close() if capture is not None else []
    if not kept:  # a window shorter than the sample's range
        kept[win.steps - 1] = (call(win.steps - 1), seg["logits"])
    hook.remove()
    del model, predict, capture, seg
    forbidden = bench.forbidden_modules()
    if forbidden:
        raise RuntimeError(f"loaded forbidden modules: {forbidden}")
    _free(device)
    numbers = judge_serve(run, pool, weights, kept, device)
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"
    stretch = (trace_lib.stretch_from_events(win.events)
               if win.events else None)
    rd = Readings(False, run.cfg, mix["batch"], 1, kind,
                  [stretch] if stretch is not None else [], [peak_window],
                  sa_calls, [win.step_seconds] if win.step_seconds else [])
    e2e = {"infer_frustums_per_s": (win.steps * mix["batch"] / win.seconds,
                                    "frustums/s"),
           "infer_p95_ms": (1e3 * float(np.percentile(latency, 95)), "ms")}
    return _result(run, setup_s, max(peak_setup, peak_window), win.steps,
                   rd, numbers, e2e, kind)


def _sampled_calls(run: Run) -> List[int]:
    """The window's calls whose detections are checked, drawn from the
    seed among the first `sample_range`."""
    rng = np.random.RandomState(seeds(run.seed)["sample"])
    return sorted(rng.choice(run.knobs["sample_range"],
                             run.knobs["sample_calls"], replace=False)
                  .tolist())


def judge_serve(run: Run, pool, weights, kept, device) -> Dict[str, float]:
    """The reference's pass on each kept call's batch with the call's own
    seg mask, and the numbers compared (the worst over the calls)."""
    rows = []
    bins = bins_of(run.cfg)
    with _no_tf32():
        for i, (out, logits) in sorted(kept.items()):
            b = {k: torch.as_tensor(v, device=device)
                 for k, v in pool[i % len(pool)].items()}
            mask = (logits[..., 1] > logits[..., 0]).float().to(device)
            ref = ref_lib.predict(run.cfg, weights, b["points"],
                                  b["one_hot"], b["class_idx"], bins,
                                  mask=mask)
            rows.append(judge.serve_numbers(out, logits, ref, bins.nh))
    return judge.worst(rows)


def control_serve(run: Run, device) -> Dict[str, float]:
    """The control: the reference in fp8 in the program's place on the
    sampled calls' batches, judged as the program is."""
    records = make_records(run)
    pool = frustums.serving_batches(records, run.mix,
                                    len(run.cfg["bins"]["classes"]),
                                    seeds(run.seed)["sample"])
    model, weights, _ = build_model(run, device)
    del model
    bins = bins_of(run.cfg)
    kept = {}
    with _no_tf32():
        for i in _sampled_calls(run):
            b = {k: torch.as_tensor(v, device=device)
                 for k, v in pool[i % len(pool)].items()}
            low = ref_lib.predict(run.cfg, weights, b["points"],
                                  b["one_hot"], b["class_idx"], bins,
                                  prec=ref_lib.Precision("fp8"))
            low["mask_count"] = low["mask"].sum(dim=1)
            mask = low["mask"]
            low["seg_conf"] = (
                (torch.softmax(low["seg_logits"], -1)[..., 1] * mask).sum(1)
                / torch.clamp_min(mask.sum(1), 1.0))
            kept[i] = (low, low["seg_logits"])
    return judge_serve(run, pool, weights, kept, device)


# ---------------------------------------------------------------------------
# Shared
# ---------------------------------------------------------------------------

class _Phases:
    """Seconds of each set-up phase, reported on stderr."""

    def __init__(self):
        self.t = time.perf_counter()
        self.parts = []

    def __call__(self, name: str) -> None:
        now = time.perf_counter()
        self.parts.append(f"{name} {now - self.t:.2f}")
        self.t = now

    def report(self, setup_s: float) -> None:
        print(f"setup {setup_s:.2f} s: " + ", ".join(self.parts),
              file=sys.stderr)


class _no_tf32:
    """Products in full float32 while the reference runs."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.saved


def _peak(device, reset: bool = False) -> int:
    if device.type != "cuda":
        return 0
    v = torch.cuda.max_memory_allocated(device)
    if reset:
        torch.cuda.reset_peak_memory_stats(device)
    return int(v)


def _free(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def _gather_rows(x: torch.Tensor, mesh) -> torch.Tensor:
    import torch.distributed as dist

    parts = [torch.empty_like(x) for _ in range(mesh.world_size)]
    dist.all_gather(parts, x.contiguous(), group=mesh.group)
    return torch.cat(parts)


def _gather_objects(obj, mesh) -> List:
    import torch.distributed as dist

    out = [None] * mesh.world_size
    dist.all_gather_object(out, obj, group=mesh.group)
    return out


def _result(run: Run, setup_s: float, peak: int, steps: int,
            rd: Readings, numbers: Dict[str, float],
            e2e: Dict[str, Tuple[float, str]], kind: str) -> Dict:
    """The run's result: with `run.trace` the per-layer metrics, else
    `e2e` ({name: (value, unit)}) and `setup_s`."""
    limits = run.knobs["limits"]
    correct = judge.within(numbers, limits)
    device = {"platform": "gpu" if kind != "cpu" else "cpu", "kind": kind,
              "count": run.chips, "memory_peak_bytes": peak}
    if run.trace:
        metrics = per_layer(run, rd)
        if rd.stretches:
            device["busy_s"] = float(np.mean(
                [trace_lib.busy_seconds(s) for s in rd.stretches]))
            device["window_s"] = float(np.mean(
                [s.seconds for s in rd.stretches]))
        brk = (trace_lib.breakdown(rd.stretches[0]) if rd.stretches
               else None)
    else:
        metrics = {k: {"value": v, "unit": u} for k, (v, u) in e2e.items()}
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
        brk = None
    return {"correct": correct, "attempted": steps, "failed": 0,
            "metrics": metrics, "device": device, "breakdown": brk,
            "checks": {k: {"value": numbers.get(k), "limit": v}
                       for k, v in limits.items()},
            "numbers": numbers}


def run_cell(run: Run, device=None) -> Dict:
    """The cell's run: in this process on one chip, or over the program's
    data-parallel ranks on `run.chips` chips."""
    mode = run.mix["mode"]
    if run.judged == "control":
        dev = torch.device(device or "cuda")
        fn = control_train if mode == "train" else control_serve
        numbers = fn(run, dev)
        return {"checks": numbers}
    if mode == "serve":
        return serve_body(run, device)
    if run.chips == 1:
        return train_body(run, device)
    from transferable3d_torch.train import config as config_lib
    from transferable3d_torch.train import train_sup

    cfg = config_lib.TrainConfig(batch_size=run.mix["batch"],
                                 num_devices=run.chips)
    return train_sup.run_data_parallel(
        cfg, device, functools.partial(_rank_body, run))


def _rank_body(run: Run, cfg, device):
    return train_body(run, device)
