"""The program's spans (`utils/profiling.span`): off without a profiler,
recorded only in a profiler's recording steps, present and nested in the
trace of a v1 train step and a v2 predict step, their children adding
up to their root, no all-reduce span at one rank, and nothing recorded
under a CUDA graph capture (on the card).

Tiny shapes on the CPU (4 frustums of 128 points, float32); this file
imports no JAX, so the `cuda` case also runs on the card's machine:

    python -m pytest --noconftest -m cuda tests/test_torch_spans.py
"""

import copy

import pytest
import torch
import torch.profiler as tp

from transferable3d_torch.core import bins as bins_lib
from transferable3d_torch.data import device_dataset, synthetic
from transferable3d_torch.models import registry
from transferable3d_torch.parallel import mesh as mesh_lib
from transferable3d_torch.train import schedules, train_loop
from transferable3d_torch.utils import profiling

CFG = bins_lib.SUNRGBD
B, NPOINTS = 4, 128
ROOT = {"train": "t3d.train_step", "predict": "t3d.predict"}
CHILDREN = {"train": ("t3d.forward", "t3d.loss", "t3d.backward",
                      "t3d.optimizer", "t3d.step_metrics"),
            "predict": ("t3d.input", "t3d.seg_net", "t3d.box_stages",
                        "t3d.decode")}
# Inside a child: the model's, in the train step's forward.
NESTED = {"train": ("t3d.seg_net", "t3d.box_stages"), "predict": ()}


@pytest.fixture(autouse=True)
def fresh_spans():
    profiling.reset_spans()
    yield
    profiling.reset_spans()


class _Train:
    """A v1 train step on batches drawn on the CPU by the program's
    device dataset; `run(n)` makes n steps and returns what they left."""

    def __init__(self):
        torch.manual_seed(0)
        records = synthetic.make_dataset(8, CFG, seed=0)
        self.data = device_dataset.build_device_dataset(
            records, CFG, max_points=256, device="cpu")
        model = registry.get_model("frustum_pointnets_v1", CFG,
                                   in_channels=4, device="cpu",
                                   generator=torch.Generator().manual_seed(0))
        lr = schedules.exponential_staircase_lr(batch_size=B)
        self.state = train_loop.create_train_state(
            model, train_loop.make_optimizer(lr), seed=0)
        self.step = train_loop.make_train_step(
            CFG, lr, schedules.bn_momentum_schedule(batch_size=B))
        self.draws = torch.Generator().manual_seed(1)

    def run(self, n=1, after_each=lambda: None):
        out = []
        for i in range(n):
            idx = torch.arange(i, i + B) % self.data.num_records
            batch = device_dataset.sample_batch(self.data, self.draws, idx,
                                                NPOINTS, CFG)
            self.state, metrics = self.step(self.state, batch)
            out.append({k: v for k, v in metrics.items()
                        if torch.is_tensor(v)})
            after_each()
        out.append(dict(self.state.model.state_dict()))
        return out


class _Predict:
    """A v2 predict step on fixed batches."""

    def __init__(self):
        model = registry.get_model("frustum_pointnets_v2", CFG,
                                   in_channels=4, device="cpu",
                                   generator=torch.Generator().manual_seed(0))
        self.step = train_loop.make_predict_step(model, CFG)
        g = torch.Generator().manual_seed(2)
        pts = torch.randn(B, NPOINTS, 4, generator=g)
        pts[..., 2] = pts[..., 2].abs() * 2 + 3
        self.batch = {"points": pts.numpy(),
                      "one_hot": torch.eye(CFG.num_classes)[:B].numpy(),
                      "class_idx": torch.arange(B).numpy()}

    def run(self, n=1, after_each=lambda: None):
        out = []
        for _ in range(n):
            out.append(self.step(self.batch))
            after_each()
        return out


def _make(kind):
    return _Train() if kind == "train" else _Predict()


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for k in x:
            assert torch.equal(x[k], y[k]), k


def _profiled(fn):
    """fn() under a profiler recording every step; (result, events)."""
    with tp.profile(activities=[tp.ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, list(prof.events())


KINDS = ["train", "predict"]


@pytest.mark.parametrize("kind", KINDS)
def test_no_span_is_recorded_without_a_profiler(kind):
    _make(kind).run(2)
    assert profiling.span_ms() == {}


@pytest.mark.parametrize("kind", KINDS)
def test_outputs_are_bitwise_the_same_with_a_profiler(kind):
    plain = _make(kind)
    traced = copy.deepcopy(plain)
    want = plain.run(2)
    got, _ = _profiled(lambda: traced.run(2))
    _same(want, got)
    assert profiling.span_ms()[ROOT[kind]][0] == 2


@pytest.mark.parametrize("kind", KINDS)
def test_spans_record_only_in_a_schedules_recording_steps(kind):
    case = _make(kind)
    prof = tp.profile(activities=[tp.ProfilerActivity.CPU],
                      schedule=tp.schedule(wait=1, warmup=1, active=2,
                                           repeat=1))
    prof.start()
    case.run(5, after_each=prof.step)
    prof.stop()
    spans = profiling.span_ms()
    assert spans[ROOT[kind]][0] == 2
    assert all(count in (2, 4) for count, _ in spans.values()), spans


@pytest.mark.parametrize("kind", KINDS)
def test_the_trace_holds_every_span_inside_its_root(kind):
    _, events = _profiled(lambda: _make(kind).run(2))
    inside = CHILDREN[kind] + NESTED[kind]
    # The draw is the caller's, before each train step.
    outside = ("t3d.draw",) if kind == "train" else ()
    names = {e.name for e in events}
    assert {ROOT[kind], *inside, *outside} <= names, sorted(
        n for n in names if n.startswith("t3d."))
    roots = [e.time_range for e in events if e.name == ROOT[kind]]
    assert len(roots) == 2
    for e in events:
        tr = e.time_range
        if e.name in inside:
            assert any(r.start <= tr.start and tr.end <= r.end
                       for r in roots), e.name
        elif e.name in outside:
            assert not any(r.start <= tr.start <= r.end for r in roots)


@pytest.mark.parametrize("kind", KINDS)
def test_the_childrens_ms_add_up_to_their_root(kind):
    _profiled(lambda: _make(kind).run(2))
    spans = profiling.span_ms()
    root = spans[ROOT[kind]][1]
    children = sum(spans[c][1] for c in CHILDREN[kind])
    assert 0.8 * root <= children <= root, (children, root, spans)


def test_no_all_reduce_span_at_one_rank():
    assert mesh_lib.active() is None
    _, events = _profiled(lambda: _make("train").run(2))
    assert "t3d.all_reduce" not in profiling.span_ms()
    assert "t3d.all_reduce" not in {e.name for e in events}
    assert profiling.span_ms()["t3d.train_step"][0] == 2


def test_span_ms_sums_each_name_and_reset_forgets():
    with tp.profile(activities=[tp.ProfilerActivity.CPU]):
        for _ in range(3):
            with profiling.span("t3d.outer"):
                with profiling.span("t3d.inner"):
                    torch.ones(256).cumsum(0)
    spans = profiling.span_ms()
    assert spans["t3d.outer"][0] == spans["t3d.inner"][0] == 3
    assert 0 < spans["t3d.inner"][1] <= spans["t3d.outer"][1]
    profiling.reset_spans()
    assert profiling.span_ms() == {}


@pytest.mark.cuda
def test_a_span_records_nothing_under_cuda_graph_capture():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA)")
    x = torch.ones(1 << 16, device="cuda")
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):  # warm-up off the default stream
        y = x * 2
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with tp.profile(activities=[tp.ProfilerActivity.CPU,
                                tp.ProfilerActivity.CUDA]):
        with torch.cuda.graph(graph):
            with profiling.span("t3d.captured"):
                y = x * 2
        graph.replay()
        with profiling.span("t3d.replayed"):
            graph.replay()
    torch.cuda.synchronize()
    spans = profiling.span_ms()
    assert "t3d.captured" not in spans
    assert spans["t3d.replayed"][0] == 1
    assert torch.equal(y, x * 2)
