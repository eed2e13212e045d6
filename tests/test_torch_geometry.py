"""Box geometry and the bin codecs: the port against the JAX package.

`box_corners`, `bev_intersection_area` and `box3d_iou` on disjoint,
nested, rotated and touching box pairs to rtol 1e-5 (atol 1e-6 for the
zero areas); the numpy copies (`box_corners_np`, the `*_np` codecs) and
the torch codecs against the originals.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import n
from transferable3d_tpu.core import bins as jbins
from transferable3d_tpu.core import box_np as jbox_np
from transferable3d_tpu.core import geometry as jgeo
from transferable3d_torch.core import bins as tbins
from transferable3d_torch.core import box_np as tbox_np
from transferable3d_torch.core import geometry as tgeo

TOL = dict(rtol=1e-5, atol=1e-6)

# (center_a, size_a, heading_a, center_b, size_b, heading_b); size (l, w, h)
PAIRS = {
    "disjoint": ([0, 0, 5], [1, 1, 1], 0.3, [4, 0, 9], [1, 2, 1], -0.2),
    "nested": ([0, 0, 5], [4, 3, 2], 0.0, [0.2, 0.1, 5.1], [1, 1, 1], 0.0),
    "rotated": ([0, 0, 5], [2, 1, 1.5], 0.7, [0.3, 0.2, 5.2], [1.5, 1.2, 1],
                -1.1),
    "touching": ([0, 0, 5], [2, 2, 2], 0.0, [2, 0, 5], [2, 2, 2], 0.0),
    "same": ([1, 0.5, 6], [1.2, 0.8, 1.0], 2.0, [1, 0.5, 6],
             [1.2, 0.8, 1.0], 2.0),
    "half_y": ([0, 0, 5], [2, 2, 2], 0.4, [0.5, 1.0, 5.3], [2, 1.5, 2], 1.9),
}


def _pairs():
    cols = list(zip(*PAIRS.values()))
    return [np.asarray(c, np.float32) for c in cols]


def test_box_corners_and_numpy_copy():
    rng = np.random.RandomState(0)
    c = rng.normal(0, 3, (5, 3)).astype(np.float32)
    s = rng.uniform(0.3, 3, (5, 3)).astype(np.float32)
    h = rng.uniform(-np.pi, np.pi, 5).astype(np.float32)
    ref = np.asarray(jgeo.box_corners(jnp.asarray(c), jnp.asarray(s),
                                      jnp.asarray(h)))
    got = n(tgeo.box_corners(torch.from_numpy(c), torch.from_numpy(s),
                             torch.from_numpy(h)))
    np.testing.assert_allclose(got, ref, **TOL)
    np.testing.assert_array_equal(tgeo.box_corners_np(c, s, h),
                                  jgeo.box_corners_np(c, s, h))
    pts = rng.normal(0, 3, (200, 3)).astype(np.float32)
    corners = jgeo.box_corners_np(c[0], s[0], h[0])
    np.testing.assert_array_equal(tbox_np.in_hull_np(pts, corners),
                                  jbox_np.in_hull_np(pts, corners))


def test_rotate_points_y():
    rng = np.random.RandomState(1)
    p = rng.normal(0, 3, (2, 7, 3)).astype(np.float32)
    a = rng.uniform(-3, 3, 2).astype(np.float32)
    ref = np.asarray(jgeo.rotate_points_y(jnp.asarray(p), jnp.asarray(a)))
    got = n(tgeo.rotate_points_y(torch.from_numpy(p), torch.from_numpy(a)))
    np.testing.assert_allclose(got, ref, **TOL)


def test_bev_area_and_iou():
    ca, sa, ha, cb, sb, hb = _pairs()
    jargs = [jnp.asarray(x) for x in (ca, sa, ha, cb, sb, hb)]
    targs = [torch.from_numpy(x) for x in (ca, sa, ha, cb, sb, hb)]
    area_ref = np.asarray(jax.vmap(jgeo.bev_intersection_area)(*jargs))
    area = n(tgeo.bev_intersection_area(*targs))
    np.testing.assert_allclose(area, area_ref, **TOL)
    i3_ref, ib_ref = jgeo.box3d_iou_batched(*jargs)
    i3, ib = tgeo.box3d_iou(*targs)
    np.testing.assert_allclose(n(i3), np.asarray(i3_ref), **TOL)
    np.testing.assert_allclose(n(ib), np.asarray(ib_ref), **TOL)
    names = list(PAIRS)
    assert area[names.index("disjoint")] == 0
    assert n(i3)[names.index("same")] == pytest.approx(1.0, rel=1e-5)
    assert n(i3)[names.index("touching")] == pytest.approx(0.0, abs=1e-6)
    assert 0 < n(i3)[names.index("rotated")] < 1


def test_heading_codecs():
    rng = np.random.RandomState(2)
    ang = rng.uniform(-7, 7, 64).astype(np.float32)
    ang[:4] = [0.0, np.pi, -np.pi, np.pi / 6]
    for nb in (12, 8):
        cls_r, res_r = jbins.angle_to_class_np(ang, nb)
        cls_g, res_g = tbins.angle_to_class_np(ang, nb)
        np.testing.assert_array_equal(cls_g, cls_r)
        np.testing.assert_array_equal(res_g, res_r)
        np.testing.assert_array_equal(tbins.class_to_angle_np(cls_r, res_r,
                                                              nb),
                                      jbins.class_to_angle_np(cls_r, res_r,
                                                              nb))
        jc, jr = jbins.angle_to_class(jnp.asarray(ang), nb)
        tc, tr = tbins.angle_to_class(torch.from_numpy(ang), nb)
        np.testing.assert_array_equal(n(tc), np.asarray(jc))
        np.testing.assert_allclose(n(tr), np.asarray(jr), rtol=1e-5,
                                   atol=1e-6)
        back = jbins.class_to_angle(jc, jr, nb)
        np.testing.assert_allclose(
            n(tbins.class_to_angle(tc, tr, nb)), np.asarray(back),
            rtol=1e-5, atol=1e-6)


def test_size_codecs():
    rng = np.random.RandomState(3)
    for cfg_j, cfg_t in ((jbins.SUNRGBD, tbins.SUNRGBD),
                         (jbins.KITTI, tbins.KITTI)):
        k = rng.randint(0, cfg_j.num_classes, 16)
        size = (cfg_j.mean_size_array()[k]
                * rng.uniform(0.7, 1.3, (16, 3))).astype(np.float32)
        cr, rr = jbins.size_to_class_np(size, k, cfg_j)
        cg, rg = tbins.size_to_class_np(size, k, cfg_t)
        np.testing.assert_array_equal(cg, cr)
        np.testing.assert_array_equal(rg, rr)
        np.testing.assert_array_equal(tbins.class_to_size_np(cr, rr, cfg_t),
                                      jbins.class_to_size_np(cr, rr, cfg_j))
        jc, jr = jbins.size_to_class(jnp.asarray(size), jnp.asarray(k),
                                     cfg_j)
        tc, tr = tbins.size_to_class(torch.from_numpy(size),
                                     torch.from_numpy(k), cfg_t)
        np.testing.assert_array_equal(n(tc), np.asarray(jc))
        np.testing.assert_allclose(n(tr), np.asarray(jr), **TOL)
        np.testing.assert_allclose(
            n(tbins.class_to_size(tc.long(), tr, cfg_t)),
            np.asarray(jbins.class_to_size(jc, jr, cfg_j)), **TOL)
