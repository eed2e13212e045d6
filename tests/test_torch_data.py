"""The port's JAX-free data copies give the JAX package's labelled
batches, array for array, for the same seed."""

import numpy as np
import pytest

from transferable3d_tpu.core import bins as jbins
from transferable3d_tpu.data import provider as jprov
from transferable3d_tpu.data import synthetic as jsyn
from transferable3d_torch.core import bins as tbins
from transferable3d_torch.data import provider as tprov
from transferable3d_torch.data import synthetic as tsyn


@pytest.mark.parametrize("kw", [
    dict(seed=0, n_object=64, n_clutter=40),
    dict(seed=3, n_object=50, n_clutter=30, hard=True),
])
def test_make_dataset_and_get_batch_equal_jax(kw):
    jr = jsyn.make_dataset(6, jbins.SUNRGBD, **kw)
    tr = tsyn.make_dataset(6, tbins.SUNRGBD, **kw)
    assert len(jr) == len(tr)
    for a, b in zip(jr, tr):
        for f in ("points", "seg", "center", "size", "heading", "box2d",
                  "calib_p"):
            va, vb = getattr(a, f), getattr(b, f)
            assert (va is None) == (vb is None), f
            if va is not None:
                np.testing.assert_array_equal(np.asarray(vb), np.asarray(va),
                                              err_msg=f)
        assert (a.class_idx, a.frustum_angle, a.frame_id, a.score) == (
            b.class_idx, b.frustum_angle, b.frame_id, b.score)
    for flags in (dict(), dict(random_flip=True, random_shift=True)):
        jb = jprov.FrustumDataset(jr, jbins.SUNRGBD, npoints=256, seed=1,
                                  **flags).get_batch(range(6))
        tb = tprov.FrustumDataset(tr, tbins.SUNRGBD, npoints=256, seed=1,
                                  **flags).get_batch(range(6))
        assert sorted(jb) == sorted(tb)
        for k in jb:
            assert jb[k].dtype == tb[k].dtype, k
            np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)
