"""One bfloat16 train step of F-PointNet v2 on the fused set-abstraction
path, `T3D_FUSED_SA` unset, on both sides: the port's `make_train_step`
(on the CPU, through the plain twins of kernels K5-K9) against the JAX
package's fused step (its Pallas passes in interpret mode), from bridged
weights, with the JAX step's dropout mask injected and the pinning of
test_torch_train_step_bf16.py: frustums on a 1/256 grid
around their mean, and the foreground bias raised by 5 so that bf16
rounding cannot flip a point of the predicted mask.

The JAX side stops after the step's forward and backward
(`run_train_steps(jax_update=False)`): loss, gradients and the updated BN
statistics. Its optimizer update would need a second compilation of the
interpret-mode passes (142 s instead of 50 s for the file); the update
itself is held by the unfused step tests, which the fused path does not
change. Shrinking the model instead does not help: the time is the
compilation, and at 2 frustums a bf16 gradient is noise (box-net cosine
0.14 against JAX, 0.49 between the port's two paths).

Readings on the CPU at this size (4 frustums, 256 points, 64 object
points), gradient cosines whole model / seg net / T-Net / box net:
* port fused vs JAX fused: 0.909 / 0.954 / 0.497 / 0.929, total loss
  1.7% apart (the unfused pair: 0.760 / 0.919 / 0.654 / 0.849);
* witness, the port's fused gradient on the batch in reversed order
  against itself: 0.956 / 0.960 / -0.023 / 1.000. The T-Net's gradient
  is a sum over the box net's input gradients that cancels to about 2e-4
  of their magnitudes: at this size it is rounding noise, so it gets no
  limit here (finite and nonzero only);
* the port's unfused gradient against its fused one: 0.974 / 0.970 /
  0.646 / 0.986, and against JAX fused 0.901 / 0.959 / 0.319 / 0.933: the
  port's fused step is as close to JAX's as its own unfused step is;
* control, the port's backward without the batch-statistic terms (the
  eval forms of K8 and K9): 0.785 / 0.908 / 0.008 / 0.823 against JAX.
The limits below sit between the readings and the control, which fails
each of them.
"""

import numpy as np
import torch

from torch_parity import port_train_step, run_train_steps, split_noise_grads
from transferable3d_torch.ops import fused_sa as tfs

COS_LIMITS = {"all": 0.85, "seg_net": 0.93, "box_net": 0.88}
LOSS_RTOL = 3e-2
NETS = ("all", "seg_net", "tnet", "box_net")


def _net_cos(a, b, paths, net):
    keys = [p for p in paths if net == "all" or p.startswith(net + "/")]
    x = np.concatenate([a[p].ravel() for p in keys]).astype(np.float64)
    y = np.concatenate([b[p].ravel() for p in keys]).astype(np.float64)
    return x @ y / (np.linalg.norm(x) * np.linalg.norm(y))


def test_train_step_bf16_fused(monkeypatch):
    seen = []
    orig = tfs.sa_bwd_step0
    monkeypatch.setattr(tfs, "sa_bwd_step0",
                        lambda *a: seen.append(1) or orig(*a))
    res = run_train_steps("bfloat16", monkeypatch, mask_margin=5.0,
                          fused=True, jax_update=False)
    assert len(seen) == 8, "the port's step did not take the fused path"
    monkeypatch.setattr(tfs, "sa_bwd_step0", orig)
    jm, tm = res["jax_metrics"], res["port_metrics"]
    np.testing.assert_allclose(tm["total_loss"], jm["total_loss"],
                               rtol=LOSS_RTOL)
    assert all(np.isfinite(v) for v in tm.values())
    pairs, _ = split_noise_grads(res, bound=None)
    for p, (a, b) in pairs.items():
        assert np.isfinite(b).all(), p
        assert (np.abs(b).max() > 0) == (np.abs(a).max() > 0), p
    jg, tg = res["jax_grads"], res["port_grads"]
    cos = {net: _net_cos(tg, jg, pairs, net) for net in NETS}
    for net, limit in COS_LIMITS.items():
        assert cos[net] >= limit, (net, cos)

    # The first SA level sees the same points on both sides: its grouped
    # MLPs' running statistics after the step agree within the fused
    # chain's tolerances.
    js, ts = res["jax_stats"], res["port_stats"]
    assert sorted(js) == sorted(ts)
    first = [p for p in js if p.startswith("seg_net/sa1/")]
    assert len(first) == 18
    for p in first:
        np.testing.assert_allclose(
            ts[p], js[p], atol=2e-3 if p.endswith("mean") else 5e-3,
            err_msg=p)

    params0, stats0, batch, keep, nobj = res["inputs"]
    # Witness: the same step on the batch in reversed order.
    order = np.arange(len(batch["points"]))[::-1].copy()
    again = port_train_step(
        "bfloat16", params0, stats0, {k: v[order] for k, v in batch.items()},
        keep[torch.from_numpy(order)], nobj, monkeypatch, fused=True)
    for net in COS_LIMITS:
        assert _net_cos(again["port_grads"], tg, pairs, net) >= cos[net] - 0.05

    # Control: the backward without the batch-statistic terms fails every
    # limit.
    o8, o9 = tfs.sa_bwd_step, tfs.sa_bwd_step0
    monkeypatch.setattr(tfs, "sa_bwd_step", lambda train, *a: o8(False, *a))
    monkeypatch.setattr(tfs, "sa_bwd_step0", lambda train, *a: o9(False, *a))
    bad = port_train_step("bfloat16", params0, stats0, batch, keep, nobj,
                          monkeypatch, fused=True)
    for net, limit in COS_LIMITS.items():
        assert _net_cos(bad["port_grads"], jg, pairs, net) < limit, net
