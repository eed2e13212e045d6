"""The port's tools against the JAX package's: `ops/grouping.knn_point`
and `models/pointnet2.sample_and_group` exactly (points on a grid, so
the distances and their ties are exact in both), `utils/viz` (the HTML
viewer and the PNG renders byte for byte, the JAX tests' script-breakout
and subsampling cases), and `utils/profiling`
(`trace`, `device_ms` on the CPU; its spans in test_torch_spans.py)."""

import glob
import json
import os
import sys

import numpy as np
import pytest
import torch

from transferable3d_tpu.models import pointnet2 as jpn2
from transferable3d_tpu.ops import grouping as jgrouping
from transferable3d_tpu.utils import viz as jviz
from transferable3d_torch.models import pointnet2 as tpn2
from transferable3d_torch.ops import grouping as tgrouping
from transferable3d_torch.utils import profiling, viz

sys.path.insert(0, os.path.dirname(__file__))
from torch_parity import one_torch_thread  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _grid(rng, shape, lo, hi, step):
    """Values k * step, k an integer in [lo, hi], as float32."""
    return (rng.randint(lo, hi + 1, size=shape) * step).astype(np.float32)


# -- knn_point, sample_and_group ---------------------------------------------

@pytest.mark.parametrize("k", [1, 8, 40])
def test_knn_point_equals_jax_with_tied_distances(k):
    """Indices and squared distances as JAX's `knn_point` gives them;
    integer coordinates in [-2, 2] tie many distances, and the lower
    index comes first among them, as in `lax.top_k`."""
    rng = np.random.RandomState(k)
    xyz = _grid(rng, (2, 40, 3), -2, 2, 1.0)
    cent = _grid(rng, (2, 6, 3), -2, 2, 1.0)
    j_idx, j_d = jgrouping.knn_point(cent, xyz, 0.0, k)
    t_idx, t_d = tgrouping.knn_point(torch.from_numpy(cent),
                                     torch.from_numpy(xyz), 0.0, k)
    assert t_idx.dtype == torch.int32 and t_idx.shape == (2, 6, k)
    d2 = ((cent[:, :, None] - xyz[:, None]) ** 2).sum(-1)
    assert np.unique(d2[0, 0]).size < 30  # 40 distances, many tied
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(t_d.numpy(), np.asarray(j_d))


@pytest.mark.parametrize("with_features", [True, False])
def test_sample_and_group_equals_jax(with_features):
    """FPS centroids and the centred groups, bit for bit, with balls that
    are short (repeating their first point) and overfull (points on a
    1/256 grid)."""
    rng = np.random.RandomState(3)
    xyz = _grid(rng, (2, 256, 3), -256, 256, 1 / 256)
    feats = _grid(rng, (2, 256, 5), -256, 256, 1 / 256)
    f = feats if with_features else None
    j_xyz, j_grouped = jpn2.sample_and_group(48, 0.6, 16, xyz, f)
    t_xyz, t_grouped = tpn2.sample_and_group(
        48, 0.6, 16, torch.from_numpy(xyz),
        None if f is None else torch.from_numpy(f))
    assert t_grouped.shape == (2, 48, 16, 3 + (5 if with_features else 0))
    np.testing.assert_array_equal(t_xyz.numpy(), np.asarray(j_xyz))
    np.testing.assert_array_equal(t_grouped.numpy(), np.asarray(j_grouped))
    _, count = tgrouping.ball_query(t_xyz, torch.from_numpy(xyz), 0.6, 16)
    assert (count < 16).any() and (count > 16).any()


# -- viz ---------------------------------------------------------------------

def _html_cases(rng):
    pts = rng.uniform(-3, 3, (500, 4)).astype(np.float32)
    boxes = [{"center": [0, 0, 1], "size": [1, 2, 3], "heading": 0.3,
              "label": "gt"},
             {"corners": rng.normal(size=(8, 3)), "color": "#f00"},
             {"center": np.array([0.5, -0.25, 4.0]), "size": [1.5, 1, 2],
              "heading": np.float32(-1.2), "label": "</script>x<b>"}]
    return {
        "seg": dict(points=pts, boxes=boxes,
                    seg=(pts[:, 0] > 0).astype(np.float32), title="t"),
        "depth_shaded": dict(points=pts, boxes=boxes[:1],
                             title="<b>evil</b></title>"),
        "subsampled": dict(points=pts, boxes=boxes,
                           seg=(pts[:, 1] > 0.5).astype(np.float32),
                           title="s", max_points=77),
        "empty_boxes": dict(points=pts[:3], title="three points"),
    }


@pytest.mark.parametrize("case", ["seg", "depth_shaded", "subsampled",
                                  "empty_boxes"])
def test_export_html_bytes_equal_jax(tmp_path, case):
    kw = _html_cases(np.random.RandomState(0))[case]
    got = viz.export_html(path=str(tmp_path / "t.html"), **kw)
    want = jviz.export_html(path=str(tmp_path / "j.html"), **kw)
    assert open(got, "rb").read() == open(want, "rb").read()


def test_export_html_escapes_script_breakout(tmp_path):
    """A '</script>' in a label or title does not escape the script
    element (JAX's test of the same name)."""
    pts = np.zeros((10, 3), np.float32)
    path = viz.export_html(
        pts,
        boxes=[{"center": [0, 0, 1], "size": [1, 1, 1], "heading": 0.0,
                "label": "</script><script>alert(1)</script>"}],
        path=str(tmp_path / "x.html"),
        title="<b>evil</b></title>")
    html = open(path).read()
    body = html.split("<body>")[1]
    payload = body.split("const DATA = ")[1].split(";\n")[0]
    assert "<" not in payload
    data = json.loads(payload)
    assert data["boxes"][0]["label"].startswith("</script>")
    assert "<b>evil</b>" not in html


def test_export_html_subsamples(tmp_path):
    pts = np.arange(3000, dtype=np.float32).reshape(1000, 3)
    path = viz.export_html(pts, seg=np.ones(1000),
                           path=str(tmp_path / "s.html"), max_points=100)
    data = json.loads(open(path).read().split("const DATA = ")[1]
                      .split(";\n")[0])
    assert len(data["points"]) == len(data["colors"]) == 100
    assert data["points"][0] == [0.0, 1.0, 2.0]
    assert data["points"][-1] == [2997.0, 2998.0, 2999.0]


def _png_size(path):
    from PIL import Image

    with open(path, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"
    with Image.open(path) as img:
        return img.size


@pytest.mark.parametrize("case", ["boxes_and_seg", "gt_only", "bare"])
def test_draw_frustum_writes_a_png(tmp_path, case):
    """A 1650x550 PNG, byte for byte JAX's figure of the same frustum."""
    rng = np.random.RandomState(0)
    pts = rng.normal(size=(500, 3)).astype(np.float32) + [0, 0, 10]
    kw = {"boxes_and_seg": dict(
              gt_box=([0, 0, 10], [2, 1, 1], 0.3),
              pred_box=([0.2, 0, 10.1], [2, 1, 1], 0.4),
              seg=rng.randint(0, 2, 500), title="test"),
          "gt_only": dict(gt_box=([0, 0, 10], [2, 1, 1], 0.3)),
          "bare": {}}[case]
    path = viz.draw_frustum(pts, path=str(tmp_path / "f.png"), **kw)
    want = jviz.draw_frustum(pts, path=str(tmp_path / "j.png"), **kw)
    assert os.path.getsize(path) > 1000
    assert _png_size(path) == (1650, 550)
    assert open(path, "rb").read() == open(want, "rb").read()


@pytest.mark.parametrize("with_boxes", [True, False])
def test_draw_scene_bev_writes_a_png(tmp_path, with_boxes):
    """A 1100x1100 PNG, byte for byte JAX's figure of the same scene."""
    rng = np.random.RandomState(1)
    pts = rng.uniform(-20, 20, (2000, 3)).astype(np.float32)
    kw = dict(gt_boxes=[([0, 0, 10], [4, 2, 1.5], 0.0)],
              pred_boxes=[([0.5, 0, 10], [4, 2, 1.5], 0.1)],
              title="scene") if with_boxes else {}
    path = viz.draw_scene_bev(pts, path=str(tmp_path / "bev.png"), **kw)
    want = jviz.draw_scene_bev(pts, path=str(tmp_path / "j.png"), **kw)
    assert os.path.getsize(path) > 1000
    assert _png_size(path) == (1100, 1100)
    assert open(path, "rb").read() == open(want, "rb").read()


# -- profiling ---------------------------------------------------------------

def test_trace_noop_and_real(tmp_path):
    with profiling.trace(None) as prof:
        assert prof is None
    log_dir = tmp_path / "prof"
    with profiling.trace(str(log_dir)):
        torch.ones(64).mul(3).sum()
    files = glob.glob(str(log_dir / "*.pt.trace.json"))
    assert len(files) == 1
    events = json.load(open(files[0]))["traceEvents"]
    assert any(e.get("name") == "aten::mul" for e in events)


def test_device_ms_on_the_cpu_times_the_host_and_moves_nothing():
    calls = []
    x = torch.arange(1000.0)

    def fn(t):
        calls.append(t.device)
        return t * 2

    ms = profiling.device_ms(fn, x, steps=4)
    assert 0 < ms < 1e4
    assert calls == [torch.device("cpu")] * 5  # one untimed call first
    assert profiling._cuda_device([{"a": (x, 1)}, "s"]) is None
