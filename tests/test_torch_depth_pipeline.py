"""Port of data/depth_pipeline.py against the JAX package on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_frustum_jit import jax_phases
from transferable3d_tpu.core import bins as jbins
from transferable3d_tpu.data import depth_pipeline as jdp
from transferable3d_torch.core import bins as tbins
from transferable3d_torch.core import box_np, geometry
from transferable3d_torch.data import depth_pipeline as tdp


def _scenes(seed, frames=2, boxes=2, pad=1):
    """The same scene from both generators, plus `pad` zero-area padding
    boxes per frame."""
    jscene, jk = jdp.make_depth_scene(np.random.RandomState(seed),
                                      jbins.SUNRGBD, frames, boxes)
    tscene, tk = tdp.make_depth_scene(np.random.RandomState(seed),
                                      tbins.SUNRGBD, frames, boxes)

    def padded(x, fill):
        x = np.asarray(x)
        tail = np.full((x.shape[0], pad) + x.shape[2:], fill, x.dtype)
        return np.concatenate([x, tail], axis=1)

    fills = {"boxes2d": 0, "box_valid": False, "center": 0, "size": 1,
             "heading": 0, "class_idx": 0}
    jpad = jscene._replace(**{k: jnp.asarray(padded(getattr(jscene, k), v))
                              for k, v in fills.items()})
    tpad = tscene._replace(**{k: padded(getattr(tscene, k), v)
                              for k, v in fills.items()})
    return (jscene, jk, jpad), (tscene, tk, tpad)


def test_make_depth_scene_equals_jax():
    (jscene, jk, _), (tscene, tk, _) = _scenes(0)
    np.testing.assert_array_equal(tk, jk)
    for name in jscene._fields:
        got, want = getattr(tscene, name), np.asarray(getattr(jscene, name))
        # (JAX without x64 holds class_idx as int32; the port keeps int64.)
        assert isinstance(got, np.ndarray), name
        assert got.dtype.kind == want.dtype.kind, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    np.testing.assert_array_equal(
        tdp.render_box_depth(30, 40, tk, tscene.center[0, 0],
                             tscene.size[0, 0], tscene.heading[0, 0]),
        jdp.render_box_depth(30, 40, jk, tscene.center[0, 0],
                             tscene.size[0, 0], tscene.heading[0, 0]))


def test_scene_to_train_batch_matches_jax():
    """2 frames x (2 boxes + 1 padding box) at 120x160, with the phases
    JAX drew. Integers, `valid` and `count` equal; points within 1.6e-5 of
    their norm (JAX's fetch returns the bf16 hi + lo split of each
    coordinate, 2^-17 relative); center, residuals and angle 1e-5; `seg`
    equal except at points within 1e-4 m of a face of the box. A depth
    pixel on the object lies ON a face of its box, so many points are
    that near (41% here) and their labels follow the coordinates' last
    bits on either side (JAX's move by up to 4e-5 m in the hi + lo
    split): the label logic itself is held exactly, on JAX's own
    points."""
    (_, _, jscene), (_, _, tscene) = _scenes(0)
    f, mb, npoints = 2, 3, 256
    key = jax.random.PRNGKey(0)
    jb = jdp.scene_to_train_batch(jscene, key, npoints, jbins.SUNRGBD)
    u = np.stack([jax_phases(r, mb) for r in jax.random.split(key, f)])
    tb = tdp.scene_to_train_batch(tscene, u, npoints, tbins.SUNRGBD,
                                  device="cpu")
    assert set(tb) == set(jb) | {"idx"}
    for k in ("heading_class", "size_class", "class_idx", "valid", "count",
              "one_hot"):
        np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]),
                                      err_msg=k)
    assert tb["valid"].tolist() == [True, True, False] * 2
    assert (tb["count"].reshape(f, mb)[:, 2] == 0).all()
    for k in ("center", "heading_residual", "size_residual",
              "frustum_angle"):
        np.testing.assert_allclose(tb[k].numpy(), np.asarray(jb[k]),
                                   atol=1e-5, rtol=0, err_msg=k)
    pts, jpts = tb["points"].numpy(), np.asarray(jb["points"])
    norm = np.linalg.norm(pts, axis=-1, keepdims=True)
    assert (np.abs(pts - jpts) <= 1.6e-5 * norm + 1e-6).all()
    assert (pts[2] == 0).all() and (tb["idx"][2] == -1).all()
    for k in ("points", "center", "heading_residual", "size_residual"):
        assert tb[k].dtype == torch.float32, k
    for k in ("seg", "heading_class", "size_class"):
        assert tb[k].dtype == torch.int32, k

    # seg: equal away from the faces of the rotated ground-truth box.
    seg, jseg = tb["seg"].numpy(), np.asarray(jb["seg"])
    rel = geometry.rotate_points_y_np(
        pts - tb["center"].numpy()[:, None],
        -(np.asarray(jscene.heading).reshape(-1)
          + tb["frustum_angle"].numpy()))
    half = np.asarray(jscene.size).reshape(-1, 1, 3)[..., [0, 2, 1]] / 2
    near_face = (np.abs(np.abs(rel) - half) < 1e-4).any(-1)
    assert (seg == jseg)[~near_face].all()
    assert (~near_face).mean() > 0.5
    on_jax_points = tdp.points_in_box(
        torch.from_numpy(jpts.copy()), tb["center"],
        torch.from_numpy(np.array(jscene.size).reshape(-1, 3)),
        torch.from_numpy(np.array(jscene.heading).reshape(-1))
        + tb["frustum_angle"]).numpy()
    np.testing.assert_array_equal(on_jax_points, jseg.astype(bool))
    assert 0.1 < seg[[0, 1, 3, 4]].mean() < 0.9


def test_seg_labels_consistent_with_host_hull():
    """Every seg=1 point lies in the ground-truth box by the host test."""
    scene, _ = tdp.make_depth_scene(np.random.RandomState(1), tbins.SUNRGBD,
                                    n_frames=1, boxes_per_frame=1)
    b = tdp.scene_to_train_batch(scene, torch.Generator().manual_seed(1),
                                 128, tbins.SUNRGBD, device="cpu")
    size = tbins.class_to_size_np(b["size_class"].numpy(),
                                  b["size_residual"].numpy(), tbins.SUNRGBD)
    heading = tbins.class_to_angle_np(b["heading_class"].numpy(),
                                      b["heading_residual"].numpy())
    corners = geometry.box_corners_np(b["center"].numpy()[0], size[0] + 1e-3,
                                      heading[0])
    inside = box_np.in_hull_np(b["points"].numpy()[0], corners)
    seg = b["seg"].numpy()[0].astype(bool)
    assert seg.sum() > 10 and inside[seg].all()


def test_points_in_box_batched_equals_jax():
    rng = np.random.RandomState(2)
    pts = rng.uniform(-2, 2, (3, 200, 3)).astype(np.float32)
    center = rng.uniform(-0.5, 0.5, (3, 3)).astype(np.float32)
    size = rng.uniform(1.0, 3.0, (3, 3)).astype(np.float32)
    heading = rng.uniform(-3, 3, 3).astype(np.float32)
    want = np.asarray(jax.vmap(jdp.points_in_box)(
        jnp.asarray(pts), jnp.asarray(center), jnp.asarray(size),
        jnp.asarray(heading)))
    got = tdp.points_in_box(*map(torch.from_numpy,
                                 (pts, center, size, heading))).numpy()
    # Random points lie within 1e-4 m of a face with probability ~1e-4.
    assert (got == want).mean() >= 0.998 and 0.05 < got.mean() < 0.95


def test_scene_to_device_and_default_device(monkeypatch):
    scene, _ = tdp.make_depth_scene(np.random.RandomState(0), tbins.SUNRGBD,
                                    n_frames=1, boxes_per_frame=1, h=24,
                                    w=32)
    on_cpu = tdp.scene_to_device(scene, "cpu")
    assert on_cpu.box_valid.dtype == torch.bool
    assert on_cpu.class_idx.dtype == torch.long
    assert on_cpu.depth.dtype == torch.float32
    # Tensors that are already there stay where they are.
    again = tdp.scene_to_device(on_cpu, "cpu")
    assert again.depth.data_ptr() == on_cpu.depth.data_ptr()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tdp.scene_to_train_batch(scene, torch.Generator(), 16,
                                 tbins.SUNRGBD)
