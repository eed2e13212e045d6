"""The work counts: the FLOP rule by hand on a tiny width, and the SA
roofline's bound, which the kernel list cannot move."""

import pytest

from t3d_bench import bench, cells, trace
from t3d_bench.work import counts

H100 = "NVIDIA H100 80GB HBM3"

TINY_V1 = {
    "version": "v1", "num_point": 2, "num_channels": 4,
    "num_object_point": 3,
    "bins": {"classes": ["a", "b"], "mean_sizes": [[1, 1, 1], [2, 2, 2]],
             "num_heading_bin": 2},
    "seg_net": {"mlp1": [2], "mlp2": [3], "mlp3": [4, 2]},
    "tnet": {"mlp": [2], "head": [2]},
    "box_net": {"mlp": [2], "head": [2]},
}


def test_v1_flops_by_hand():
    # T-Net: 3 object points x 3 x 2, then (2 + 2 classes) x 2 + 2 x 3.
    tnet = 3 * 3 * 2 + (2 + 2) * 2 + 2 * 3
    # Seg net, per point: 4 -> 2; 2 -> 3; concat(2, 3, 2 classes) -> 4 ->
    # 2; 2 -> 2 logits.
    seg = 2 * (4 * 2 + 2 * 3 + 7 * 4 + 4 * 2 + 2 * 2)
    # Box net: 3 x 2 per object point; head (2 + 2) x 2 + 2 x (3 + 2 x 2
    # + 4 x 2).
    box = 3 * 3 * 2 + (2 + 2) * 2 + 2 * 15
    assert counts.forward_macs(TINY_V1) == tnet + seg + box == 196
    assert counts.step_flops(TINY_V1, 5, train=True) == 196 * 2 * 5 * 3
    assert counts.step_flops(TINY_V1, 5, train=False) == 196 * 2 * 5


def test_v2_counts_every_ball_slot():
    spec = bench.load_spec()
    cfg = bench.config(spec, "fpn_v2_sunrgbd")
    base = counts.forward_macs(cfg)
    wider = dict(cfg, seg_net=dict(cfg["seg_net"]))
    sa = [dict(x) for x in cfg["seg_net"]["sa_msg"]]
    r, k, widths = sa[0]["scales"][0]
    sa[0]["scales"] = [[r, 2 * k, widths]] + sa[0]["scales"][1:]
    wider["seg_net"]["sa_msg"] = sa
    # Doubling one scale's K adds S x K more slots through its MLP.
    slots = sa[0]["npoint"] * k
    extra = slots * ((3 + 3) * widths[0] + widths[0] * widths[1]
                     + widths[1] * widths[2])
    assert counts.forward_macs(wider) - base == extra


def test_sa_chain_work_by_hand():
    nbytes, ops = counts.sa_chain_work(1, 2, 4, 2, [2, 3], 5, train=False)
    # centroids 2x3 f32, points 4x3 f32, payload 4x2 bf16, centroid term
    # 2x2 bf16, W 2x3 bf16 + b 3 f32, BN 8 bytes a channel, pooled 2x3
    # bf16.
    assert nbytes == 24 + 48 + 16 + 8 + (12 + 12) + 8 * 5 + 12
    assert ops == 5 * 2 * 2 * 3
    tb, to = counts.sa_chain_work(1, 2, 4, 2, [2, 3], 5, train=True)
    assert to == 3 * ops and tb > nbytes


def _readings(device_events):
    step = trace.Event(trace.STEP_SPAN, False, 0.0, 1000.0)
    st = trace.stretch_from_events([step, *device_events])
    call = {"b": 2, "s": 128, "n": 1024, "widths": [64, 64, 128],
            "unique_rows": 2 * 128 * 20}
    return cells.Readings(False, {}, 2, 1, H100, [st], [0], [call]), call


def _bound(call):
    return counts.least_seconds(*counts.sa_chain_work(
        call["b"], call["s"], call["n"], call["widths"][0], call["widths"],
        call["unique_rows"], False), counts.peaks(H100))


def test_sa_bound_ignores_intermediates_and_caps_at_100():
    read = bench.reader("sa_infer_roofline")
    rd, call = _readings([])
    least_us = _bound(call) * 1e6
    # The chain's kernels take exactly the least time: 100%, not more.
    k2 = trace.Event("sa_infer_mma_kernel", True, 10.0, 10.0 + least_us)
    rd, _ = _readings([k2])
    assert read(rd) == pytest.approx(100.0)
    assert read(rd) <= 100.0 + 1e-9
    # A kernel that writes an intermediate (a plain op between the chain's
    # kernels, or a chain kernel of another design) moves the time, never
    # the bound.
    extra = trace.Event("sa_infer_general_kernel", True, 500.0,
                        500.0 + least_us)
    rd2, _ = _readings([k2, extra])
    assert read(rd2) == pytest.approx(50.0)
    plain = trace.Event("elementwise_kernel", True, 700.0, 710.0)
    rd3, _ = _readings([k2, plain])
    assert read(rd3) == pytest.approx(100.0)


def test_peaks_only_for_a_known_card():
    assert counts.peaks(H100)["bf16_flops"] == 989e12
    assert counts.peaks("cpu") is None
