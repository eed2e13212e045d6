"""The port's data preparation (data/pickle_io, kitti, kitti_prep,
sunrgbd, sunrgbd_prep) against the JAX package's on the fixtures that
tests/test_kitti.py, tests/test_sunrgbd.py, tests/test_pickle_io.py and
tests/test_sunrgbd_end_to_end.py write under tmp_path: the same arrays,
and the same pickle bytes from the preparation scripts. Then the KITTI
pipeline end to end in the port, as tests/test_kitti_end_to_end.py runs
it: fixture -> prep -> train -> detect -> KITTI files -> native AP.
"""

import os
import pickle
import sys

import numpy as np
import pytest
import torch

from transferable3d_tpu.core import bins as jbins
from transferable3d_tpu.data import kitti as jkitti
from transferable3d_tpu.data import kitti_prep as jkitti_prep
from transferable3d_tpu.data import pickle_io as jpio
from transferable3d_tpu.data import sunrgbd as jsun
from transferable3d_tpu.data import synthetic as jsyn
from transferable3d_torch.core import bins as tbins
from transferable3d_torch.core.geometry import box_corners_np
from transferable3d_torch.data import kitti as tkitti
from transferable3d_torch.data import kitti_prep as tkitti_prep
from transferable3d_torch.data import pickle_io as tpio
from transferable3d_torch.data import sunrgbd as tsun

sys.path.insert(0, os.path.dirname(__file__))
from test_kitti import _make_fixture  # noqa: E402
from test_sunrgbd import K, _write_fixture_mat  # noqa: E402
from torch_parity import one_torch_thread  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

FIELDS = ("points", "seg", "class_idx", "frustum_angle", "center", "size",
          "heading", "box2d", "score", "frame_id", "calib_p")


def assert_records_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        for f in FIELDS:
            va, vb = getattr(a, f), getattr(b, f)
            assert (va is None) == (vb is None), f
            if va is not None:
                assert np.asarray(va).dtype == np.asarray(vb).dtype, f
                np.testing.assert_array_equal(va, vb, err_msg=f)


# ---------------------------------------------------------------------------
# pickle_io
# ---------------------------------------------------------------------------

def test_native_format_loads_across_packages(tmp_path):
    recs = jsyn.make_dataset(6, jbins.SUNRGBD, seed=0, n_object=50,
                             n_clutter=20)
    jpio.save_records(recs, str(tmp_path / "j" / "train.pkl"))
    tpio.save_records(recs, str(tmp_path / "t" / "train.pkl"))
    assert ((tmp_path / "t" / "train.pkl").read_bytes()
            == (tmp_path / "j" / "train.pkl").read_bytes())
    got = tpio.load_records(str(tmp_path / "j"), split="train")
    assert_records_equal(got, jpio.load_records(str(tmp_path / "t")))
    name = jbins.SUNRGBD.classes[recs[0].class_idx]
    assert_records_equal(
        tpio.load_records(str(tmp_path / "j"), classes=[name]),
        jpio.load_records(str(tmp_path / "j"), classes=[name]))


def test_corners_to_box_equals_jax():
    rng = np.random.RandomState(0)
    for _ in range(20):
        corners = box_corners_np(
            rng.uniform(-5, 5, 3).astype(np.float32),
            rng.uniform(0.5, 4, 3).astype(np.float32),
            np.float32(rng.uniform(-np.pi, np.pi)))
        for a, b in zip(tpio.corners_to_box(corners),
                        jpio.corners_to_box(corners)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("layout", [9, 6])
def test_reference_format_import_equals_jax(tmp_path, layout):
    recs = jsyn.make_dataset(6, jbins.SUNRGBD, seed=layout)
    names = [jbins.SUNRGBD.classes[r.class_idx] for r in recs]
    if layout == 9:
        lists = [[r.frame_id for r in recs], [r.box2d for r in recs],
                 [box_corners_np(r.center, r.size, r.heading) for r in recs],
                 [r.points for r in recs], [r.seg for r in recs], names,
                 [float(r.heading) for r in recs], [r.size for r in recs],
                 [r.frustum_angle for r in recs]]
    else:
        lists = [[r.frame_id for r in recs], [r.box2d for r in recs],
                 [r.points for r in recs], names,
                 [r.frustum_angle for r in recs], [0.9] * len(recs)]
    path = str(tmp_path / "ref.pkl")
    with open(path, "wb") as f:
        for lst in lists:
            pickle.dump(lst, f, protocol=2)
    got = tpio.load_records(path, cfg=tbins.SUNRGBD)
    assert len(got) == 6
    assert_records_equal(got, jpio.load_records(path, cfg=jbins.SUNRGBD))


# ---------------------------------------------------------------------------
# kitti, kitti_prep
# ---------------------------------------------------------------------------

def test_kitti_reader_and_extraction_equal_jax(tmp_path):
    frames = _make_fixture(str(tmp_path), np.random.RandomState(2),
                           n_frames=2)
    jds = jkitti.KittiObjectDataset(str(tmp_path))
    tds = tkitti.KittiObjectDataset(str(tmp_path))
    assert tds.ids() == jds.ids() == ["000000", "000001"]
    for idx, _, _, _, box2d in frames:
        tc, jc = tds.get_calibration(idx), jds.get_calibration(idx)
        for f in ("P", "R0", "V2C", "C2V", "c_u", "c_v", "f_u", "f_v",
                  "b_x", "b_y"):
            np.testing.assert_array_equal(getattr(tc, f), getattr(jc, f))
        velo = tds.get_lidar(idx)[:, :3]
        np.testing.assert_array_equal(tc.project_velo_to_rect(velo),
                                      jc.project_velo_to_rect(velo))
        rect = tc.project_velo_to_rect(velo)
        np.testing.assert_array_equal(tc.project_rect_to_velo(rect),
                                      jc.project_rect_to_velo(rect))
        np.testing.assert_array_equal(tc.project_rect_to_image(rect),
                                      jc.project_rect_to_image(rect))
        (to,), (jo,) = tds.get_label_objects(idx), jds.get_label_objects(idx)
        for a, b in zip(to.center_size_heading(), jo.center_size_heading()):
            np.testing.assert_array_equal(a, b)
        assert (tkitti.frustum_angle_for_box(box2d, tc)
                == jkitti.frustum_angle_for_box(box2d, jc))
        np.testing.assert_array_equal(
            tkitti.random_shift_box2d(box2d, np.random.RandomState(1)),
            jkitti.random_shift_box2d(box2d, np.random.RandomState(1)))
        for kw in (dict(), dict(perturb_box2d=True, augment_x=3)):
            assert_records_equal(
                tkitti.extract_frustum_records(
                    tds, idx, rng=np.random.RandomState(0), **kw),
                jkitti.extract_frustum_records(
                    jds, idx, rng=np.random.RandomState(0), **kw))
        dets = [("Car", 0.93, box2d), ("Car", 0.5, box2d * 0.9)]
        assert_records_equal(
            tkitti.extract_frustum_records_from_detections(tds, idx, dets),
            jkitti.extract_frustum_records_from_detections(jds, idx, dets))


def _run_main(module, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["prep"] + argv)
    module.main()


def test_kitti_prep_writes_the_jax_pickles(tmp_path, monkeypatch, capsys):
    frames = _make_fixture(str(tmp_path / "kitti"),
                           np.random.RandomState(4), n_frames=2)
    det_file = tmp_path / "dets.txt"
    det_file.write_text("".join(
        f"{idx} Car 0.93 {b[0]:.1f} {b[1]:.1f} {b[2]:.1f} {b[3]:.1f}\n"
        f"{idx} Van 0.40 {b[0]:.1f} {b[1]:.1f} {b[2]:.1f} {b[3]:.1f}\n"
        for idx, _, _, _, b in frames))
    got = tkitti.read_det_file(str(det_file))
    want = jkitti.read_det_file(str(det_file))
    assert sorted(got) == sorted(want)
    for k in got:
        for a, b in zip(got[k], want[k]):
            assert a[:2] == b[:2]
            np.testing.assert_array_equal(a[2], b[2])
    argv = ["--kitti_root", str(tmp_path / "kitti"), "--gen_train",
            "--gen_val", "--gen_val_rgb_detection", "--det_file",
            str(det_file), "--augment_x", "2"]
    _run_main(jkitti_prep, argv + ["--out_dir", str(tmp_path / "j")],
              monkeypatch)
    _run_main(tkitti_prep, argv + ["--out_dir", str(tmp_path / "t")],
              monkeypatch)
    for name in ("train.pkl", "val.pkl", "val_rgb_detection.pkl"):
        assert ((tmp_path / "t" / name).read_bytes()
                == (tmp_path / "j" / name).read_bytes()), name
    assert len(tpio.load_records(str(tmp_path / "t" / "train.pkl"),
                                 cfg=tbins.KITTI)) == 4
    # --demo draws the first frustum of the first frame, as JAX's does
    for side, module in (("j", jkitti_prep), ("t", tkitti_prep)):
        monkeypatch.chdir(tmp_path / side)
        _run_main(module, ["--kitti_root", str(tmp_path / "kitti"),
                           "--demo"], monkeypatch)
        assert (tmp_path / side / "demo_frustum.png").stat().st_size > 1000
        assert capsys.readouterr().out.endswith(
            "demo: wrote demo_frustum.png\n")


# ---------------------------------------------------------------------------
# sunrgbd, sunrgbd_prep
# ---------------------------------------------------------------------------

def _chair_meta(tmp_path):
    box = {"centroid": np.array([0.5, 3.0, 0.4]),
           "size": np.array([0.6, 0.55, 0.8]), "heading": 0.4,
           "classname": "chair",
           "box2d": np.array([300.0, 200.0, 420.0, 330.0])}
    bed = {"centroid": np.array([-0.6, 3.5, 0.2]),
           "size": np.array([2.0, 1.6, 0.9]), "heading": -0.7,
           "classname": "bed",
           "box2d": np.array([60.0, 150.0, 330.0, 400.0])}
    path = str(tmp_path / "meta.mat")
    _write_fixture_mat(path, [{"id": "scene0", "depthpath": "unused",
                               "boxes": [box, bed]}])
    return path, (box, bed)


def test_sunrgbd_reader_and_extraction_equal_jax(tmp_path):
    path, boxes = _chair_meta(tmp_path)
    (tf,), (jf,) = tsun.load_meta(path), jsun.load_meta(path)
    assert (tf.frame_id, tf.depth_path, tf.image_path) == (
        jf.frame_id, jf.depth_path, jf.image_path)
    np.testing.assert_array_equal(tf.K, jf.K)
    np.testing.assert_array_equal(tf.Rtilt, jf.Rtilt)
    assert len(tf.boxes) == len(jf.boxes) == 2
    for a, b in zip(tf.boxes, jf.boxes):
        assert (a.classname, a.heading) == (b.classname, b.heading)
        for f in ("centroid", "size", "box2d"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        for x, y in zip(a.to_camera(), b.to_camera()):
            np.testing.assert_array_equal(x, y)

    rng = np.random.RandomState(0)
    raw = rng.randint(0, 2 ** 16, (48, 64)).astype(np.uint16)
    np.testing.assert_array_equal(tsun.decode_depth(raw),
                                  jsun.decode_depth(raw))
    depth = rng.uniform(0.5, 6.0, (48, 64)).astype(np.float32)
    depth[rng.rand(48, 64) < 0.1] = 0.0
    rgb = rng.randint(0, 255, (48, 64, 3)).astype(np.uint8)
    for a, b in zip(tsun.depth_to_upright_points(depth, K, np.eye(3), rgb),
                    jsun.depth_to_upright_points(depth, K, np.eye(3), rgb)):
        np.testing.assert_array_equal(a, b)
    pts = rng.normal(size=(20, 3)).astype(np.float32)
    np.testing.assert_array_equal(tsun.upright_to_camera(pts),
                                  jsun.upright_to_camera(pts))
    np.testing.assert_array_equal(tsun.camera_to_upright(pts),
                                  jsun.camera_to_upright(pts))

    # A cloud of the two objects and a wall, each point with its pixel.
    parts = []
    for b in boxes:
        local = rng.uniform(-0.5, 0.5, (300, 3)) * b["size"]
        t = b["heading"]
        rot = np.array([[np.cos(t), np.sin(t), 0],
                        [-np.sin(t), np.cos(t), 0], [0, 0, 1.0]])
        parts.append(local @ rot + b["centroid"])
    parts.append(np.stack([rng.uniform(-3, 3, 400), np.full(400, 6.0),
                           rng.uniform(-1, 2, 400)], axis=1))
    pts_up = np.concatenate(parts).astype(np.float32)
    cam = tsun.upright_to_camera(pts_up)
    uv = np.stack([K[0, 0] * cam[:, 0] / cam[:, 2] + K[0, 2],
                   K[1, 1] * cam[:, 1] / cam[:, 2] + K[1, 2]], axis=1)
    for kw in (dict(), dict(perturb_box2d=True, augment_x=3),
               dict(type_whitelist=["bed"])):
        got = tsun.extract_frustum_records(
            tf, pts_up, uv, tbins.SUNRGBD, rng=np.random.RandomState(3), **kw)
        assert got
        assert_records_equal(got, jsun.extract_frustum_records(
            jf, pts_up, uv, jbins.SUNRGBD, rng=np.random.RandomState(3),
            **kw))


def test_sunrgbd_prep_writes_the_jax_pickles(tmp_path, monkeypatch):
    cv2 = pytest.importorskip("cv2")
    from test_sunrgbd_end_to_end import H, W, _make_scene

    from transferable3d_tpu.data import sunrgbd_prep as jprep
    from transferable3d_tpu.data.depth_pipeline import render_box_depth
    from transferable3d_torch.data import sunrgbd_prep as tprep

    rng = np.random.RandomState(0)
    frames = []
    for fi, cls in enumerate(("chair", "bed")):
        box, (c, s, h) = _make_scene(rng, cls)
        depth = render_box_depth(H, W, K, c, s * 0.96, h,
                                 background_depth=6.0)
        raw = (np.clip(depth, 0, 7.9) * 1000).astype(np.uint16) << 3
        path = str(tmp_path / f"depth_{fi}.png")
        assert cv2.imwrite(path, raw)
        frames.append({"id": f"scene{fi}", "depthpath": path,
                       "boxes": [box]})
    meta = str(tmp_path / "SUNRGBDMeta.mat")
    _write_fixture_mat(meta, frames)
    argv = ["--meta", meta, "--augment_x", "2", "--no_rgb"]
    _run_main(jprep, argv + ["--out_dir", str(tmp_path / "j")], monkeypatch)
    _run_main(tprep, argv + ["--out_dir", str(tmp_path / "t")], monkeypatch)
    for name in ("train.pkl", "val.pkl"):
        assert ((tmp_path / "t" / name).read_bytes()
                == (tmp_path / "j" / name).read_bytes()), name
    assert len(tpio.load_records(str(tmp_path / "t" / "val.pkl"))) == 2


# ---------------------------------------------------------------------------
# KITTI end to end in the port
# ---------------------------------------------------------------------------

def test_kitti_pipeline_end_to_end(tmp_path, monkeypatch):
    from transferable3d_torch.eval import kitti_offline
    from transferable3d_torch.train import config as config_lib
    from transferable3d_torch.train import test as test_lib
    from transferable3d_torch.train import train_sup

    kitti_root = str(tmp_path / "kitti")
    _make_fixture(kitti_root, np.random.RandomState(0), n_frames=3)
    frustum_dir = str(tmp_path / "frustum")
    n = tkitti_prep.prepare_split(kitti_root, f"{frustum_dir}/train.pkl",
                                  None, perturb=True, augment_x=2)
    tkitti_prep.prepare_split(kitti_root, f"{frustum_dir}/val.pkl", None,
                              perturb=False, augment_x=1)
    assert n >= 3
    cfg = config_lib.TrainConfig(
        model="frustum_pointnets_v1", dataset="kitti",
        data_path=frustum_dir, num_point=128, num_channels=4,
        batch_size=4, max_epoch=2, max_steps=4, num_devices=1,
        log_dir=str(tmp_path / "log"), eval_every_epochs=100,
        ckpt_every_epochs=1, random_shift=False)
    cpu = torch.device("cpu")
    train_sup.train(cfg, device=cpu)

    result_dir = str(tmp_path / "result")
    gt_dir = os.path.join(kitti_root, "training", "label_2")
    monkeypatch.setenv("T3D_KITTI_GT_DIR", gt_dir)
    aps = test_lib.evaluate(cfg, result_dir, device=cpu)
    assert np.isfinite(aps["mAP"])
    data_dir = os.path.join(result_dir, "data")
    files = sorted(os.listdir(data_dir))
    assert len(files) == 3
    for f in files:
        lines = open(os.path.join(data_dir, f)).read().strip().splitlines()
        assert lines and lines[0].split()[0] == "Car"
        assert len(lines[0].split()) == 16
    assert os.path.exists(os.path.join(result_dir, "stats_car_ap.txt"))
    log = open(os.path.join(result_dir, "log_test.txt")).read()
    assert "kitti_eval Car 3d moderate" in log
    offline = kitti_offline.evaluate_offline(gt_dir, result_dir)
    assert ("Car", "3d", "moderate") in offline
    assert all(0.0 <= v <= 100.0 for v in offline.values())
