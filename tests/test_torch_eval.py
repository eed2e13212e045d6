"""The port's evaluation (core/box_np, eval/ap, eval/kitti_offline and
the detection writers of train/test) against the JAX package's on the
CPU: the IoUs within 1e-6 (they are one algorithm in float64: equal in
practice), the APs exactly, the files byte for byte. The golden AP cases
of tests/test_eval.py and the native evaluator's fixtures of
tests/test_kitti_eval_native.py run through both packages.
"""

import os
import sys

import numpy as np
import pytest

from transferable3d_tpu.core import box_np as jbox
from transferable3d_tpu.eval import ap as jap
from transferable3d_tpu.eval import kitti_offline as jko
from transferable3d_tpu.train import test as jtest
from transferable3d_torch.core import box_np as tbox
from transferable3d_torch.core.geometry import box_corners_np
from transferable3d_torch.eval import ap as tap
from transferable3d_torch.eval import kitti_offline as tko
from transferable3d_torch.train import test as ttest

sys.path.insert(0, os.path.dirname(__file__))
from test_kitti_eval_native import (  # noqa: E402
    N_FRAMES, _det_line, _gt_line, _scene, _write)


def _boxes(seed, n):
    """n random boxes and, in order, one touching, one nested inside and
    one disjoint from box 0 (the cases the clip's tolerance decides)."""
    rng = np.random.RandomState(seed)
    c = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    s = rng.uniform(0.3, 3, (n, 3)).astype(np.float32)
    h = rng.uniform(-np.pi, np.pi, n).astype(np.float32)
    l0 = s[0, 0]
    extra_c = np.stack([c[0] + [l0 * np.cos(h[0]), 0, -l0 * np.sin(h[0])],
                        c[0], c[0] + [40.0, 0, 40.0]]).astype(np.float32)
    extra_s = np.stack([s[0], s[0] * 0.5, s[0]]).astype(np.float32)
    extra_h = np.array([h[0], h[0], h[0] + 0.3], np.float32)
    return (np.concatenate([c, extra_c]), np.concatenate([s, extra_s]),
            np.concatenate([h, extra_h]))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_box_iou_functions_equal_jax(seed):
    c, s, h = _boxes(seed, 9)
    corners = box_corners_np(c, s, h)
    m = len(c)
    j3d, jbev = jbox.box3d_iou_pairs_np(corners, corners)
    t3d, tbev = tbox.box3d_iou_pairs_np(corners, corners)
    np.testing.assert_allclose(t3d, j3d, atol=1e-6, rtol=0)
    np.testing.assert_allclose(tbev, jbev, atol=1e-6, rtol=0)
    # Touching boxes share a face (IoU 0), the nested one lies inside.
    assert t3d[0, m - 3] < 1e-6 and t3d[0, m - 1] == 0.0
    assert t3d[0, m - 2] == pytest.approx(1 / 8, abs=1e-5)
    for i in range(m):
        for k in (0, (i + 1) % m, m - 2):
            np.testing.assert_allclose(
                tbox.box3d_iou_np(corners[i], corners[k]),
                jbox.box3d_iou_np(corners[i], corners[k]), atol=1e-6,
                rtol=0)
        np.testing.assert_allclose(
            tbox.box3d_iou_params_np(c[i], s[i], h[i], c[0], s[0], h[0]),
            jbox.box3d_iou_params_np(c[i], s[i], h[i], c[0], s[0], h[0]),
            atol=1e-6, rtol=0)
        p1, p2 = corners[i, :4][:, [0, 2]], corners[0, :4][:, [0, 2]]
        assert tbox.polygon_area(p1) == jbox.polygon_area(p1)
        assert (tbox.convex_hull_intersection(p1, p2)
                == jbox.convex_hull_intersection(p1, p2))
        assert (tbox.polygon_clip([tuple(v) for v in p1],
                                  [tuple(v) for v in p2])
                == jbox.polygon_clip([tuple(v) for v in p1],
                                     [tuple(v) for v in p2]))
    pts = np.random.RandomState(seed).uniform(-4, 4, (200, 3))
    np.testing.assert_array_equal(tbox.in_hull_np(pts, corners[0]),
                                  jbox.in_hull_np(pts, corners[0]))


def _box(lib, frame, cls, center, score=1.0, size=(2.0, 1.0, 1.0),
         heading=0.0):
    return lib.BoxDetection.from_params(frame, cls, center, size, heading,
                                        score)


# The golden cases of tests/test_eval.py: (gts, dets, eval_det kwargs,
# the class checked, its AP), boxes as (frame, class, center, score,
# size).
_GOLDEN = {
    "ap1": ([("f0", "chair", [0, 0, 5]), ("f0", "chair", [3, 0, 5]),
             ("f1", "chair", [0, 0, 8])],
            [("f0", "chair", [0, 0, 5], 0.9), ("f0", "chair", [3, 0, 5], 0.8),
             ("f1", "chair", [0, 0, 8], 0.7)], {}, "chair", 1.0),
    "ap0": ([("f0", "chair", [0, 0, 5])], [], {}, "chair", 0.0),
    "half_recall": ([("f0", "chair", [0, 0, 5]), ("f0", "chair", [30, 0, 5])],
                    [("f0", "chair", [0, 0, 5], 0.9)], {}, "chair", 0.5),
    "fp_before_tp": ([("f0", "chair", [0, 0, 5])],
                     [("f0", "chair", [50, 0, 5], 0.9),
                      ("f0", "chair", [0, 0, 5], 0.8)], {}, "chair", 0.5),
    "duplicate": ([("f0", "chair", [0, 0, 5])],
                  [("f0", "chair", [0, 0, 5], 0.9),
                   ("f0", "chair", [0.05, 0, 5], 0.8)], {}, "chair", 1.0),
    "iou_boundary_pass": ([("f0", "chair", [0, 0, 5], 1.0, (1, 1, 1))],
                          [("f0", "chair", [0.5, 0, 5], 0.9, (1, 1, 1))],
                          {"iou_thresh": 0.25}, "chair", 1.0),
    "iou_boundary_fail": ([("f0", "chair", [0, 0, 5], 1.0, (1, 1, 1))],
                          [("f0", "chair", [0.5, 0, 5], 0.9, (1, 1, 1))],
                          {"iou_thresh": 0.5}, "chair", 0.0),
    "multiclass": ([("f0", "chair", [0, 0, 5]), ("f0", "bed", [5, 0, 5])],
                   [("f0", "chair", [0, 0, 5], 0.9)], {}, "mAP", 0.5),
    "voc07": ([("f0", "chair", [0, 0, 5]), ("f0", "chair", [30, 0, 5])],
              [("f0", "chair", [0, 0, 5], 0.9)], {"use_07_metric": True},
              "chair", 6 / 11),
}


def _make(lib, spec, default_score):
    out = []
    for b in spec:
        frame, cls, center = b[:3]
        score = b[3] if len(b) > 3 else default_score
        size = b[4] if len(b) > 4 else (2.0, 1.0, 1.0)
        out.append(_box(lib, frame, cls, center, score, size))
    return out


@pytest.mark.parametrize("name", sorted(_GOLDEN))
def test_golden_ap_cases_equal_jax(name):
    gt_spec, det_spec, kw, cls, want = _GOLDEN[name]
    jg, jd = _make(jap, gt_spec, 1.0), _make(jap, det_spec, 1.0)
    tg, td = _make(tap, gt_spec, 1.0), _make(tap, det_spec, 1.0)
    got = tap.eval_det(td, tg, **kw)
    assert got == jap.eval_det(jd, jg, **kw)
    assert got[cls] == pytest.approx(want)
    for bev in (False, True):
        cls_kw = dict(iou_thresh=kw.get("iou_thresh", 0.25),
                      use_07_metric=kw.get("use_07_metric", False), bev=bev)
        for port_fn, jax_fn in ((tap.eval_det_cls, jap.eval_det_cls),
                                (tap.eval_det_cls_reference,
                                 jap.eval_det_cls_reference)):
            sel = [d for d in td if d.classname == "chair"]
            jsel = [d for d in jd if d.classname == "chair"]
            r, p, a = port_fn(sel, [g for g in tg if g.classname == "chair"],
                              **cls_kw)
            jr, jp, ja = jax_fn(jsel, [g for g in jg
                                       if g.classname == "chair"], **cls_kw)
            np.testing.assert_array_equal(r, jr)
            np.testing.assert_array_equal(p, jp)
            assert a == ja
        if det_spec:
            assert (tap.voc_ap(r, p, kw.get("use_07_metric", False))
                    == jap.voc_ap(jr, jp, kw.get("use_07_metric", False)))


@pytest.mark.parametrize("seed", [0, 1])
def test_random_eval_equal_jax_and_reference(seed):
    """Frames without GT, duplicates and score ties: the port's
    vectorised matcher, its loop reference and JAX's agree exactly."""
    rng = np.random.RandomState(seed)
    gts, dets = [], []
    for fid in range(10):
        for _ in range(rng.randint(0, 4)):
            c = np.array([rng.uniform(-3, 3), rng.uniform(-1, 1),
                          rng.uniform(2, 8)])
            s, h = rng.uniform(0.5, 2.0, 3), rng.uniform(-np.pi, np.pi)
            gts.append((fid, c, s, h, 1.0))
            for _ in range(rng.randint(0, 3)):
                dets.append((fid, c + rng.normal(0, 0.3, 3),
                             s * rng.uniform(0.8, 1.2, 3),
                             h + rng.normal(0, 0.2),
                             round(rng.uniform(), 1)))
        dets.append((fid, np.array([rng.uniform(-5, 5), 0,
                                    rng.uniform(2, 9)]),
                     rng.uniform(0.3, 2.5, 3), rng.uniform(-np.pi, np.pi),
                     round(rng.uniform(), 1)))

    def boxes(lib, spec):
        return [lib.BoxDetection.from_params(f, "chair", c, s, h, sc)
                for f, c, s, h, sc in spec]

    for bev in (False, True):
        got = tap.eval_det_cls(boxes(tap, dets), boxes(tap, gts), bev=bev)
        ref = tap.eval_det_cls_reference(boxes(tap, dets), boxes(tap, gts),
                                         bev=bev)
        want = jap.eval_det_cls(boxes(jap, dets), boxes(jap, gts), bev=bev)
        for a, b, c in zip(got, ref, want):
            np.testing.assert_array_equal(a, c)
            np.testing.assert_array_equal(b, c)


def _detections(lib):
    rng = np.random.RandomState(7)
    out = []
    for i in range(12):
        out.append(lib.Detection(
            f"{i // 3:06d}", ("Car", "Pedestrian", "Cyclist")[i % 3],
            rng.uniform(-5, 5, 3).astype(np.float32) + [0, 0, 15],
            rng.uniform(0.5, 4, 3).astype(np.float32),
            rng.uniform(-np.pi, np.pi), rng.uniform(),
            box2d=rng.uniform(0, 1000, 4).astype(np.float32)))
    return out


def test_writers_equal_jax_byte_for_byte(tmp_path):
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jpath = jtest.write_sunrgbd_results(_detections(jtest), str(jdir))
    tpath = ttest.write_sunrgbd_results(_detections(ttest), str(tdir))
    assert open(tpath, "rb").read() == open(jpath, "rb").read()
    jk = jtest.write_kitti_results(_detections(jtest), str(jdir))
    tk = ttest.write_kitti_results(_detections(ttest), str(tdir))
    names = sorted(os.listdir(jk))
    assert sorted(os.listdir(tk)) == names and len(names) == 4
    for n in names:
        assert (open(os.path.join(tk, n), "rb").read()
                == open(os.path.join(jk, n), "rb").read())
    back = ttest.read_sunrgbd_results(tpath)
    jback = jtest.read_sunrgbd_results(jpath)
    assert len(back) == 12
    for a, b in zip(back, jback):
        assert (a.frame_id, a.classname, a.score, a.heading) == (
            b.frame_id, b.classname, b.score, b.heading)
        np.testing.assert_array_equal(a.center, b.center)
        np.testing.assert_array_equal(a.size, b.size)
    for a, b in zip(ttest.detections_to_eval_boxes(back),
                    jtest.detections_to_eval_boxes(jback)):
        np.testing.assert_array_equal(a.corners, b.corners)
        assert a.score == b.score


def _native_case(root, kind, rng):
    """Write the GT and result dirs of one native-evaluator fixture."""
    gt_dir, res_dir = str(root / "gt"), str(root / "res")
    for i in range(N_FRAMES if kind != "none" else 5):
        c, ry = _scene(i, rng)
        if kind == "perfect":
            gt, det = [_gt_line(xyz=c, ry=ry)], [
                _det_line(rng.uniform(0.5, 1.0), xyz=c, ry=ry)]
        elif kind == "none":
            gt, det = [_gt_line()], []
        elif kind == "shifted":
            gt = [_gt_line(xyz=c, ry=0.0)]
            det = [_det_line(rng.uniform(0.5, 1.0),
                             xyz=(c[0] + 2.0, c[1], c[2]), ry=0.0)]
        else:  # false positives
            far = (c[0] + 60, c[1], c[2] + 60)
            gt = [_gt_line(xyz=c, ry=ry)]
            det = [_det_line(rng.uniform(0.5, 1.0), xyz=c, ry=ry),
                   _det_line(rng.uniform(0.5, 1.0), xyz=far,
                             box2d=(500, 100, 700, 200), ry=ry)]
        _write(f"{gt_dir}/{i:06d}.txt", gt)
        _write(f"{res_dir}/data/{i:06d}.txt", det)
    return gt_dir, res_dir


@pytest.mark.parametrize("kind", ["perfect", "none", "shifted", "fp"])
def test_kitti_offline_equals_jax_copy(tmp_path, kind):
    gt_dir, res_dir = _native_case(tmp_path, kind,
                                   np.random.RandomState(len(kind)))
    got = tko.evaluate_offline(gt_dir, res_dir)
    assert got == jko.evaluate_offline(gt_dir, res_dir)
    easy3d = got[("Car", "3d", "easy")]
    assert {"perfect": easy3d > 95.0, "none": easy3d == 0.0,
            "shifted": easy3d == 0.0 and got[("Car", "2d", "easy")] > 95.0,
            "fp": 40.0 < easy3d < 62.0}[kind], got
