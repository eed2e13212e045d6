"""Whole serving slice in bfloat16: the JAX fused SA path (Pallas
inference kernel in interpret mode, patched on as tests/test_fused_sa.py
does) vs the port's plain twins, with bridged weights and perturbed BN
statistics, at B=2, N=256, num_object_point=64 (tests/test_ops_v2.py).

Tolerances: seg logits within 3% of their max |value| and mask
agreement >= 99%. The two sides round to bf16 at the same documented
sites, but XLA on the CPU may keep excess precision between a dot and
the next bf16 op, and the f32 sums run in another order, so bf16
values can differ by a step and a point near the mask boundary can flip.
"""

import jax.numpy as jnp
import numpy as np
import torch

from torch_parity import bridged, init_flax, n
from transferable3d_tpu.core import bins as jbins
from transferable3d_tpu.models import pointnet2 as jpn2
from transferable3d_tpu.models.frustum_pointnet_v2 import (
    FrustumPointNetV2 as JV2)
from transferable3d_tpu.ops import fused_sa as jfs
from transferable3d_torch.core import bins as tbins
from transferable3d_torch.models.frustum_pointnet_v2 import (
    FrustumPointNetV2 as TV2)
from transferable3d_torch.train import train_loop as tloop


def test_v2_bf16_forward(monkeypatch):
    seed = 7
    rng = np.random.RandomState(seed)
    b, npts, c = 2, 256, 4
    points = rng.normal(size=(b, npts, c)).astype(np.float32)
    points[..., 2] += 10  # frustums look down +Z
    one_hot = np.eye(10, dtype=np.float32)[rng.randint(0, 10, b)]
    jm = JV2(cfg=jbins.SUNRGBD, num_object_point=64, dtype=jnp.bfloat16)
    params, stats = init_flax(jm, seed, jnp.asarray(points),
                              jnp.asarray(one_hot), train=False)
    monkeypatch.setattr(jfs, "INTERPRET", True)
    monkeypatch.setattr(jpn2, "on_tpu", lambda: True)
    ref = jm.apply({"params": params, "batch_stats": stats},
                   jnp.asarray(points), jnp.asarray(one_hot), train=False)
    tm = bridged(TV2(tbins.SUNRGBD, num_object_point=64,
                     dtype=torch.bfloat16, device="cpu"), params, stats)
    with torch.no_grad():
        got = tm(torch.from_numpy(points), torch.from_numpy(one_hot))
    rl, gl = np.asarray(ref["seg_logits"]), n(got["seg_logits"])
    assert np.abs(gl - rl).max() <= 0.03 * np.abs(rl).max()
    assert (n(got["mask"]) == np.asarray(ref["mask"])).mean() >= 0.99
    for k in ("center", "size_scores", "heading_scores"):
        assert np.isfinite(n(got[k])).all()

    out = tloop.make_predict_step(tm, tbins.SUNRGBD)(
        {"points": points, "one_hot": one_hot})
    assert out["center"].shape == (b, 3) and out["size"].shape == (b, 3)
    assert np.isfinite(n(out["center"])).all()
