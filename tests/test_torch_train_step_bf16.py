"""One bfloat16 train step of F-PointNet v2 with T3D_FUSED_SA=0 on both
sides (the JAX CPU path is unfused; the port's CPU path takes the plain
grouping): the port's `make_train_step` against the JAX one, from
bridged weights, with the JAX step's dropout mask injected; see
`torch_parity.run_train_steps`. The foreground bias is raised by 5 so
that bf16 rounding cannot flip a point of the predicted mask.

At this size (4 frustums, 256 points) a bf16 train-step gradient is far
from its float32 value in either package: JAX's own bf16 gradient has
cosine 0.467 with its float32 gradient (seg net 0.773, T-Net 0.520, box
net 0.497). Between the port and JAX the cosines are 0.760 (seg 0.919,
T-Net 0.654, box 0.849), so the issue's per-leaf 0.99 does not hold
between two bf16 implementations here. Measured causes, on the CPU:
* rounding noise: the port's gradient on the same batch in another
  frustum order (only the order of the batch sums changes) has cosine
  0.982-0.985 with itself, T-Net 0.56-0.62. The T-Net's gradient is a
  sum over the box net's input gradients that cancels to about 2e-4 of
  their magnitudes;
* XLA's excess precision on the CPU (bf16 values kept in f32 inside a
  fusion): with `--xla_allow_excess_precision=false` the total-loss gap
  falls from 5.4e-3 to 4.3e-4 and the box-net cosine rises to 0.935.
The limits below are set from these readings. A control fails them: the
port's CPU grouping with its gather's plain autograd backward, which sums
a bf16 cotangent in bf16 (the fault this test was written against), gives
cosines 0.198 (T-Net 0.130, box 0.697) against JAX, and 0.163 (box
0.367) against JAX's float32 gradient. The witness holds the port's bf16
gradient against JAX's float32 one: no further off than JAX's own bf16
gradient is, less 0.1.
"""

import numpy as np

from torch_parity import run_train_steps, split_noise_grads

# Cosine limits against JAX in bf16 (measured 0.760, 0.919, 0.654, 0.849).
COS_LIMITS = {"all": 0.7, "seg_net": 0.9, "tnet": 0.5, "box_net": 0.8}


def _net_cos(a, b, paths, net):
    keys = [p for p in paths if net == "all" or p.startswith(net + "/")]
    x = np.concatenate([a[p].ravel() for p in keys]).astype(np.float64)
    y = np.concatenate([b[p].ravel() for p in keys]).astype(np.float64)
    return x @ y / (np.linalg.norm(x) * np.linalg.norm(y))


def test_train_step_bf16_unfused(monkeypatch):
    """Measured on the CPU: total loss relative error 5.4e-3, seg loss
    7.6e-4; cosines against JAX bf16 as above; against JAX's float32
    gradient the port's bf16 gradient has cosine 0.447 (seg 0.759, T-Net
    0.430, box 0.448) where JAX's bf16 gradient has 0.467 (0.773, 0.520,
    0.497)."""
    res = run_train_steps("bfloat16", monkeypatch, mask_margin=5.0,
                          f32_witness=True)
    jm, tm = res["jax_metrics"], res["port_metrics"]
    for k in ("total_loss", "seg_loss"):
        np.testing.assert_allclose(tm[k], jm[k], rtol=1e-2, err_msg=k)
    assert all(np.isfinite(v) for v in tm.values())
    pairs, _ = split_noise_grads(res, bound=None)
    for p, (a, b) in pairs.items():
        assert np.isfinite(b).all(), p
        assert (np.abs(b).max() > 0) == (np.abs(a).max() > 0), p
    jg, tg, j32 = res["jax_grads"], res["port_grads"], res["jax_f32_grads"]
    for net, limit in COS_LIMITS.items():
        cos = _net_cos(tg, jg, pairs, net)
        assert cos >= limit, (net, cos)
        port_f32, jax_f32 = (_net_cos(g, j32, pairs, net) for g in (tg, jg))
        assert port_f32 >= jax_f32 - 0.1, (net, port_f32, jax_f32)
