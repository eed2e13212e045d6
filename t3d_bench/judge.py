"""The numbers that decide `correct`, each held to its cell's limit.

Training (the set-up's first three steps, through the window's own step
on its own draws, the reference on the program's seg masks): the first
step's loss against the reference's, relative (`loss_gap`, read for the
record: the control does not read three times what sound runs do, so it
has no limit); each leaf's first gradient, as the optimizer got it
(Adam's first moment after one step over 1 - beta1), by the gap between
the program's norm and the reference's, relative, the median leaf's
(`grad_gap`); each leaf's
change over the three steps by the same rule (`change_gap`); and the
first step's seg mask judged by the reference's seg logits (`seg_gap`:
the widest margin by which the reference prefers the other class). Both
norms leave out the leaves whose reference gradient is under a
thousandth of the median leaf's: biases ahead of a train-mode
BatchNorm, whose gradient is nought but for round-off.

Serving (a sample of the window's calls, drawn from the seed), against
the reference's pass on the same inputs with the call's own seg mask
(the mask the call computed, tied to the detections by their mask count,
`mask_count_gap`, exact): the seg logits (`seg_logit_gap`, the widest),
the seg confidence over the mask (`seg_conf_gap`), the box's center and
size in metres (`box_gap`), its heading in radians at the program's
heading bin (`heading_gap`), and that bin itself, judged by the
reference's heading scores (`heading_choice_gap`: the widest margin by
which the reference's best bin scores above the program's bin).
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

import torch

from t3d_bench.reference import fpointnet as ref_lib


def _norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double()))
            for k, v in tensors.items()}


def _median(values: Sequence[float]) -> float:
    v = sorted(values)
    return v[len(v) // 2] if len(v) % 2 else 0.5 * (v[len(v) // 2 - 1]
                                                    + v[len(v) // 2])


def worst_norm_gap(prog: Dict[str, float], ref: Dict[str, float]) -> float:
    """max over leaves of |prog - ref| / max(ref, median ref)."""
    if not ref:
        return 0.0
    med = _median(list(ref.values()))
    return max(abs(prog[k] - r) / max(r, med, 1e-30) for k, r in ref.items())


def median_norm_gap(prog: Dict[str, float], ref: Dict[str, float]) -> float:
    """The median over leaves of |prog - ref| / ref."""
    return _median([abs(prog[k] - r) / max(r, 1e-30)
                    for k, r in ref.items()]) if ref else 0.0


def train_numbers(prog: Dict, ref: Dict) -> Dict[str, float]:
    """`prog`: the program's `loss` [steps], `grad` {leaf: tensor},
    `before` and `after` {name: tensor}, `masks` [steps] of [B, N];
    `ref`: `reference.fpointnet.train_steps`'s output on those masks.

    Adam's first update is lr x sign(g) elementwise, so elements whose
    gradient is near zero take steps of full size in a direction that
    rounding decides: two float32 implementations part after the first
    update, so the later steps are held by the median leaf's change. The
    worst leaf's first gradient is a T-Net leaf or a first layer's on
    every seed, whose gradient cancels between the T-Net's two paths to
    the loss, and reads alike in bfloat16 and fp8: the first gradient is
    held by the median leaf too."""
    g_ref = _norms(ref["grad"])
    g_prog = _norms(prog["grad"])
    med = _median(list(g_ref.values()))
    moving = [k for k, v in g_ref.items() if v >= 1e-3 * med]

    def change(side):
        return _norms({k: side["after"][k].double()
                       - prog["before"][k].double() for k in moving})

    return {
        "loss_gap": abs(prog["loss"][0] - ref["loss"][0])
        / max(abs(ref["loss"][0]), 1e-30),
        "grad_gap": median_norm_gap({k: g_prog[k] for k in moving},
                                    {k: g_ref[k] for k in moving}),
        "change_gap": median_norm_gap(change(prog), change(ref)),
        "seg_gap": ref_lib.seg_choice_gap(
            ref["seg_logits"][0].to(prog["masks"][0].device),
            prog["masks"][0]),
    }


def worst_leaves(prog: Dict, ref: Dict, top: int = 3) -> Dict:
    """The leaves that read worst in `grad_gap` and `change_gap`, with
    both norms (what a look at a reading starts from). For the worst
    change, `flip_share`: the share of the squared gap between the two
    sides' changes that lies on elements whose first gradient has
    opposite signs on the two sides (Adam's first update is lr x sign)."""
    g_ref, g_prog = _norms(ref["grad"]), _norms(prog["grad"])
    med = _median(list(g_ref.values()))
    moving = [k for k, v in g_ref.items() if v >= 1e-3 * med]
    worst = sorted(moving, key=lambda k: -abs(g_prog[k] - g_ref[k])
                   / max(g_ref[k], med))[:top]
    stats = [k for k in ref["after"] if k.endswith((".mean", ".var"))]

    def delta(side, k):
        return side["after"][k].double() - prog["before"][k].double()

    def change(side, names):
        return _norms({k: delta(side, k) for k in names})

    c_prog, c_ref = change(prog, moving), change(ref, moving)
    worst_c = sorted(moving, key=lambda k: -abs(c_prog[k] - c_ref[k])
                     / max(c_ref[k], 1e-30))[:top]

    def flip_share(k):
        gp = prog["grad"][k].to(ref["grad"][k].device)
        flip = torch.sign(gp) != torch.sign(ref["grad"][k])
        d2 = (delta(prog, k).to(flip.device) - delta(ref, k)) ** 2
        return float(d2[flip].sum() / d2.sum().clamp_min(1e-300))

    return {"median_grad": med,
            "worst_grad_gap": worst_norm_gap(
                {k: g_prog[k] for k in moving}, {k: g_ref[k] for k in moving}),
            "worst_change_gap": max(abs(c_prog[k] - c_ref[k])
                                    / max(c_ref[k], 1e-30) for k in moving),
            "stats_gap": median_norm_gap(change(prog, stats),
                                         change(ref, stats)),
            "grad": [[k, g_prog[k], g_ref[k]] for k in worst],
            "change": [[k, c_prog[k], c_ref[k], flip_share(k)]
                       for k in worst_c],
            "loss": [list(prog["loss"]), list(ref["loss"])],
            "terms": {k: [prog["terms"][k], v] for k, v in
                      ref["terms"].items() if k in prog.get("terms", {})}}


def _wrap(a: torch.Tensor) -> torch.Tensor:
    return torch.remainder(a + math.pi, 2 * math.pi) - math.pi


def serve_numbers(prog: Dict[str, torch.Tensor], logits: torch.Tensor,
                  ref: Dict[str, torch.Tensor], nh: int
                  ) -> Dict[str, float]:
    """One sampled call: `prog` its detections (host tensors), `logits`
    the seg logits the call computed, `ref` the reference's pass on the
    call's inputs with the call's seg mask."""
    dev = ref["center"].device
    p = {k: v.to(dev) for k, v in prog.items()}
    logits = logits.to(dev).float()
    mask = (logits[..., 1] > logits[..., 0]).float()
    rows = torch.arange(p["center"].shape[0], device=dev)
    hcls = p["heading_class"].long()
    ref_heading = ref_lib.class_to_angle(
        hcls, ref["heading_residuals"][rows, hcls], nh)
    prob = torch.softmax(ref["seg_logits"], dim=-1)[..., 1]
    seg_conf = (prob * mask).sum(1) / torch.clamp_min(mask.sum(1), 1.0)
    return {
        "mask_count_gap": float((mask.sum(1) - p["mask_count"]).abs().max()),
        "seg_logit_gap": float((logits - ref["seg_logits"]).abs().max()),
        "seg_conf_gap": float((p["seg_conf"] - seg_conf).abs().max()),
        "box_gap": float(torch.maximum(
            (p["center"] - ref["center"]).abs().max(),
            (p["size"] - ref["size"]).abs().max())),
        "heading_gap": float(_wrap(p["heading"] - ref_heading).abs().max()),
        "heading_choice_gap": ref_lib.choice_gap(ref["heading_scores"],
                                                 hcls),
    }


def worst(rows: Sequence[Dict[str, float]]) -> Dict[str, float]:
    return {k: max(r[k] for r in rows) for k in rows[0]}


def within(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """True when every limited number is finite and within its limit."""
    return all(math.isfinite(numbers.get(k, math.nan))
               and numbers[k] <= lim for k, lim in limits.items())
