"""Smoke run of the PyTorch port's serving and training paths on one
NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Drives `transferable3d_torch` (no JAX anywhere) at the width of the JAX
package's bench cells. F-PointNet v2: serving as `v2_infer`
(`get_model("frustum_pointnets_v2", SUNRGBD, dtype=bfloat16)` on cuda:0,
B=128 frustums of N=1024 points with C=4 channels, 512 object points
after masking) and training as `v2_train`, on the unfused
set-abstraction path (T3D_FUSED_SA=0) and on the fused one (the default).
F-PointNet v1: the end-to-end step `e2e_train` (32 frames of 96x128
depth with 4 boxes each -> `scene_to_train_batch` on the card -> one
train step on the 128 frustums it emits), the same step at SUN RGB-D's
480x640 depth maps, and `v1_infer`/`v1_train` on the synthetic
frustums. Weights are random from a seeded
torch.Generator; the inputs are seeded synthetic frustums and scenes.

Serving phases, one line each, under torch.no_grad():
  1. card name and `nvidia-smi` name + power limit;
  2. build of the CUDA kernels (csrc/*.cu: one nvcc per source, all in
     parallel, then one link into a single library) and its time;
  3. model (BN running statistics perturbed away from 0/1) and inputs (an
     object box plus clutter, 3-8 m ahead), and the share of empty /
     short / full / overfull balls at each of the 8 SA scales (no ball on
     this path is empty: every centroid is one of the points it groups;
     phase 5 therefore also checks K2 with half the centroids moved
     100 m away);
  4. one `make_predict_step` call with the launch counters zeroed just
     before it: 4 FPS launches (kernel K1) and 8 fused SA launches
     (kernel K2) are required, and their arguments are captured;
  5. each kernel vs its plain PyTorch twin on those arguments: FPS
     indices identical (and at 1 to 12,288 points, k of 1, 2 and every
     point, on random, all-equal and doubled points: `_fps_probes`);
     K2 >= 99% of pooled values bit-identical, max
     |diff| <= 1% of max |pooled|, >= 10% of pooled nonzero; K2 at the
     same limits on the probes of `INFER_PROBES` (ragged widths, K = 24
     and K = 1, every ball one member, a 512-wide last layer, an inner
     layer for the general f32 kernel); and the card's predict step vs
     the plain twins on the CPU for 8 frustums (seg logits within 3% of
     their max, mask agreement >= 99%);
  6. `run_inference` over 4 batches (512 frustums): finite detections;
  7. times with CUDA events, each beside the card's name and power
     limit: every kernel and its plain twin at each main-path shape, and
     predict-step frustums/s.
Training phases (T3D_FUSED_SA=0 set for them and restored after):
  8. a fresh bf16 v2 and the `v2_train` batch (the port's copy of the
     synthetic generator: 32 frustums, n_object 600, n_clutter 300, 1024
     points, tiled to B=128); one `make_train_step` call (Adam on the
     exponential staircase, the BN-momentum staircase, IoU metrics on)
     with the counters zeroed just before it: 4 FPS, 0 fused SA, 8 K3
     and 8 K4 launches are required and the K3/K4 arguments captured;
     every loss term, metric and gradient finite; the all-zero gradient
     leaves listed; the ball shares of the 8 scales;
  9. K3 and K4 vs their plain twins on the captured arguments, again
     with every other centroid moved 100 m away (empty balls), and on the
     probes of `_k3_k4_probes` (eff = 1 and K, N = 1 and 100, K = 4,096,
     700 centroids, C of 20 and 3, unaligned rows): K3 rows and counts
     identical; K4 bit-identical to the twin run on CPU copies of the
     arguments (both add each point's slots in ascending (s, k) in f32
     and round once), the same bits on two runs, and identical to the
     twin on the card on integer-valued cotangents;
 10. one train step on 8 frustums (on a 1/256 grid around their own
     mean) on the card and on the CPU (plain twins) from copies of the
     same model, with one dropout keep mask: in float32, total loss
     within 2% relative and cosine of the concatenated gradients >= 0.99;
     in bf16, with the mask and the box net's balls pinned, total loss
     within 2% and gradient cosines (whole model, seg net, T-Net, box
     net) at the limits of `BF16_COS`, printed beside two noise
     witnesses (each device against itself on the batch reversed) and
     five controls, which between them must fail every limit;
 11. 30 train steps on the fixed batch: losses finite and the mean of
     the last 5 below the first;
then times with CUDA events beside the card's name and power limit: the
train step at B=128 (ms and frustums/s), K3 and K4 vs their plain twins
at each of the 8 shapes and per step, and the peak device memory.
Fused training phases (T3D_FUSED_SA unset, from the same initial model):
 12. one `make_train_step` call with the counters zeroed just before it:
     4 FPS and 8 launches of each of K5-K9 are required, none of K2, K3
     or K4, and the arguments of every K5-K9 launch are captured; every
     loss term, metric and gradient finite;
 13. each of K5-K9 vs its plain twin on the captured arguments, and the
     chain again with every other centroid moved 100 m away, at the
     limits `FusedChecks` states; K6-K9 also on a cut of each scale
     whose last tile is ragged (15 frustums, S - 3 centroids), K8 and K9
     there at the top and below a stored dy, train and eval, and at their
     smallest tile (K = 16, 16 <- 16); K6 and K7 at the corners of their
     plan (K = 16; 128 rows of 128 -> 128, 128 -> 256 and 256 -> 256);
     K5 on the probes of `_extract_probes` (eff = 1 and K, N = 1, F0 of
     16 to 256 and not a multiple of 8, unaligned rows);
     each kernel's sums bit-identical when it runs twice, and K9's H, Mq
     and cnt the same bits on two launches and equal, bit for bit, to the
     twin's order of summation over K9's own dy_0 (`step0_scatter_plain`
     on CPU copies); the grouped MLPs' BN running statistics bit-identical
     after one step from two copies of the model;
 14. phase 10's bf16 check with the fused path on the card (kernels) and
     on the CPU (plain twins), at the limits of `FUSED_COS`, with two
     witnesses and five controls; as a reading, the card's fused step
     against its unfused one; and at the batch that is trained (B = 128,
     pinned the same way) the card's fused gradient against its unfused
     one at the limits of `FULL_BATCH_COS`, beside two witnesses (each
     path on the batch reversed) and five controls; then, as readings, the
     box net's gap taken apart (`_box_net_readings`): its largest leaves,
     its cosine without the biases that are zero in exact arithmetic, each
     such bias beside the f64 sum of its terms on both paths, a third step
     (unfused, rounded where the fused kernels round) against both, and
     each path against the card's float32 step;
 15. 30 fused train steps: losses finite, the mean of the last 5 below
     the first; then the fused step's time and peak memory beside the
     unfused step's from this run, and K5-K9 vs their twins at each of
     the 8 shapes and per step.
End-to-end phases (F-PointNet v1 in bf16, 3 channels; the scene, the
model and the batch are built without `device` and must lie on the card):
 16. one `scene_to_train_batch` + `make_train_step(StepConfig(
     compute_iou_metrics=False, use_valid_weights=True))` with the
     counters zeroed just before it: 1 K15 launch (the fetch is batched
     over frames and boxes) and none of K1-K9 are required, and K15's
     arguments are captured; all 128 frustums non-empty and valid; every
     batch entry, loss term and gradient finite; the foreground share of
     `seg` strictly between 0 and 1;
 17. K15 vs its plain twin, `sampled`, `idx` and `count` identical (a
     gather: exact), on the captured arguments and on probes: an empty
     and a 37-point frustum (zeros and idx -1; every point, cyclically);
     480x640 depth maps (F=4, MB=4) at 1,024 and 2,048 points; a
     20,000-point cloud with C=4 through `crop_point_frustums`; 1,000
     points; 530x730 depth maps (F=4, MB=4; a ragged last word) at 1,024
     points; each with a host check in numpy that shares no code with the
     port (`idx == flatnonzero(inside)[want - 1]`); phase 16 also checks
     every sampled pixel of the main path inside its 2D box;
 18. `scene_to_train_batch` on the card and on the CPU from one scene and
     one set of phases: idx, count, valid and the classes identical;
     points and center within 4e-6 (a few ulps at 8 m: sin, cos, atan2
     and fused multiply-adds), angle 1e-6; `seg` equal except within
     1e-4 m of a box face, where their number is printed (a depth pixel
     on the object lies on a face). Then one v1 train step on 8 frustums
     of that batch, card vs CPU as in phase 10: float32 loss within 2%
     and cosine >= 0.99; bf16 with the mask pinned at the limits of
     `V1_COS`, beside two witnesses and three controls;
 19. 30 end-to-end steps, each on a fresh draw of the frustums: losses
     finite, the mean of the last 5 below the first; then the step's
     time, frustums/s and peak memory, and the share of it that is
     `scene_to_train_batch`;
 20. v1 with C=4 on the synthetic frustums: one train step with the IoU
     metrics, one predict step and `run_inference` over 4 batches, all
     finite, no kernel launched; their times;
 21. the end-to-end step at SUN RGB-D's depth resolution: phase 16 with
     32 synthetic 480x640 depth maps (`make_depth_scene(h=480, w=640)`,
     4 boxes each: 128 frustums of 307,200 points, K15 spreading each
     frustum over the blocks of its `fetch_select_plan`) and a fresh v1,
     at phase 16's gates; K15 against its twin and the numpy host check
     on the captured arguments, as in phase 17; then K15's time with its
     bound and the twin's, the step's time, and `scene_to_train_batch`'s
     time and share of the step.
The driver and the evaluation (v2 bf16 at the full widths of the preset
`config2_fpointnet_v1_sunrgbd`: N=1024, C=6, B=32; 512 train and 128 val
synthetic frustums; through the functions a user runs, without `device`):
 22. `train_sup.train` with the records resident on the card, 48 steps (3
     epochs, an eval pass and a checkpoint after each) with the counters
     zeroed just before it: K1 4 times a step, each of K5-K9 8 times a
     train step and K2 8 times an eval step (a scale that `fused_route`
     reroutes is printed and must take K3/K4 instead); every logged loss
     and metric finite, the val metrics logged each epoch, the newest
     checkpoint at step 48; a second `train` resumes at 48 and ends at
     56, then 8 steps on the host provider (`prefetch`), each at the same
     launch gates; the checkpoint round trip: the state at step 56 saved
     and restored into a fresh template, one step on one batch, its
     loss, gradients and parameters against steps from in-memory copies
     of the unsaved state, within the copies' own gap (bit-identical
     where they are);
 23. `test.evaluate` on that checkpoint with the counters zeroed: K1 16
     and K2 32 launches (4 predict calls) and no other kernel, 128 finite
     detections, `detections.txt` read back through `eval_det` giving the
     same APs, each in [0, 1]; then the driver's train frustums/s from
     its log, the checkpoint's save and restore times and `evaluate`'s
     wall time beside the card's name and power limit.
The transfer loop (the preset `config4_transfer` at its widths, N=1024,
C=6, B=32, with a v2 bf16 detector; 640 train and 160 val synthetic
frustums, strong classes bed, table, sofa, chair and the other six weak;
through the functions a user runs, without `device`):
 24. phase A: one `make_boxpc_train_step` on the card and on the CPU
     from copies of one BoxPC, both drawing from CPU generators of one
     seed (the same perturbations, aug and dropout masks): the float32
     loss within 2%, the gradient cosine >= 0.99, no kernel launched;
     the step's time at B=32; then 500 steps at B=64 on one batch, and
     `make_boxpc_refine_step` must raise the mean 3D IoU of freshly
     perturbed boxes by more than 0.02;
 25. phase B: `train_semisup.train` (2 epochs of phase A, then 32 steps
     with the strong and weak splits resident on the card, an eval pass
     on the weak val split and a checkpoint an epoch) with the counters
     zeroed first: every step launches K1 8 times, K5-K7 16 (two passes
     of 8 scales) and K8/K9 10 (the strong pass's 8 scales and the weak
     pass's box net: the weak losses do not reach its seg net), every
     eval step K1 4 and K2 8, nothing else anywhere; every logged loss
     finite and `weak_trust_frac` in [0, 1]; BoxPC bit-identical before
     and after phase B and equal to phase A's checkpoint, holding no
     gradient; the newest checkpoint at step 32; the step's time over
     epoch 1 and the peak memory; then one v1 float32 semi-supervised
     step on 8 + 8 frustums, card vs CPU from copies (CPU generators of
     one seed: the same dropout masks): loss within 2%, cosine >= 0.99;
 26. `test.evaluate(boxpc_dir=<log_dir>/boxpc_ckpt)` with the counters
     zeroed: K1 4 and K2 8 launches a predict call and nothing else, 160
     finite detections that differ from `evaluate`'s without the
     refinement, `detections.txt` read back through `eval_det` giving
     the same APs, each in [0, 1]; then phase A's and phase B's step
     times, phase B's frustums/s and peak memory and `evaluate`'s wall
     time beside the card's name and power limit, and the whole run's
     time.
The training repeats bit for bit on one card:
 27. phase 22's training run twice in this process from one seed: the
     parameters, BN buffers and Adam moments bit-identical after every
     one of the 48 steps, and `evaluate` on each run's checkpoint giving
     equal APs; phase 25's transfer loop run twice: the detector's
     parameters, buffers and Adam moments bit-identical after every
     phase-B step (phase 13 holds K9's H, Mq and cnt to the same bits on
     two launches);
The transfer study (`scripts/torch_transfer_study.py`, study6's widths:
v2 bf16, N=512, B=64, C=4, 4,096 train and 1,024 val hard synthetic
frustums, weak-loss warmup 2,000 steps, per-class diagnostics), cut in
depth to `STUDY_BOXPC_EPOCHS` BoxPC and `STUDY_EPOCHS` phase-B epochs:
 28. its `main` for the transfer and control arms of one seed, with the
     counters zeroed first: every phase-B step launches K1 8, K5-K7 16 and
     K8/K9 10 (a rerouted scale fails it), every logged loss finite, the
     JSON records of the JAX script's keys, `mAP` and `per_class` in [0,
     1]; a second `main` on the same JSON trains nothing and leaves it
     unchanged; on the arguments of one phase-B step (`STUDY_CHECK_STEP`,
     copied to the host as the run goes on), K1 and K5-K9 against their
     plain twins at phases 5 and 13's limits, K9's H, Mq and cnt twice
     the same bits and equal to the twin's order over its own dy_0, and
     on one eval step's K1 and K2; then the runs' time (the copy-out of
     that step's arguments included) and peak memory.
The tools (`ops/grouping.knn_point`, `models/pointnet2.sample_and_group`,
`utils/profiling`, `utils/viz`):
 29. `sample_and_group` at each scale of v2's SA1 (B=128 frustums of
     N=1024 points with one feature channel, 128 centroids, r 0.2 / 0.4 /
     0.8, K 32 / 64 / 128; the points centred on their frustum's mean,
     within 8.9 m and on a 1/256 grid, so that every distance is exact on
     both devices) with the counters zeroed just before each call: one K1
     launch and no other kernel, the centroids and groups equal to the
     same call on CPU copies; `knn_point` (k = 16) on the card equal to
     the CPU's, indices and distances; `profiling.trace` around one
     predict step (K1 4 and K2 8 launches): the written Chrome trace
     names K1's and K2's kernels; `profiling.device_ms` of the predict
     step above 0 and at most the wall time, on the host's clock, of the
     3 calls that its CUDA events bracket (its untimed first call left
     out); `viz.export_html` of phase 6's first detection on its
     frustum's points, and `viz.draw_frustum` of it where matplotlib is
     installed (else a line says it was not run), written under a
     temporary directory. `tf1_import` is not run: it reads checkpoints
     through `tensorflow`.
Data parallelism (`parallel/mesh.py`), two ranks on the one card over
gloo (NCCL takes a card a rank), spawned with a `file://` rendezvous:
 30. (a) `config5_mesh_large_batch` at its widths (v1 bf16, N=1024, C=6,
     B=256, 128 a rank) and (b) v2 bf16 on the fused path at `v2_train`'s
     shape (B=128 distinct frustums, 64 a rank), each on the 1/256 grid
     with the mask pinned (and v2's box-net input snapped) as phase 14
     pins: one train step of the two ranks against the 1-rank step on
     the card on the same batch, weights and dropout mask, at the limits
     `DP_V1_LIMITS` / `DP_V2_LIMITS` (the loss, the gradient cosine per
     net, the BN buffers, on v1 the whole gradient's norm, on v2 the
     fused chains' BN gradient norm),
     beside a witness (the 1-rank step on the batch's halves swapped) and
     controls that must each fail one: BN statistics left per rank, loss
     denominators left per rank and (v2) dgamma and dbeta all-reduced
     twice; the counters zeroed just before each rank's step: 4 K1 and 8
     of each of K5-K9 a rank on v2, nothing on v1; K5-K7's sums: the
     1-rank step's 24 launches split into the ranks' rows add up to the
     whole's within 1e-4 of their terms' magnitudes, and the ranks' own
     sums, added, to the 1-rank step's within 3e-3 (failed with the BN
     statistics left per rank); (d) (a)'s step in a one-rank NCCL group
     bit-identical to the step without a group; the 2-rank step's ms and
     its collectives' ms beside the 1-rank step's; (c) `train_sup.train`
     at config5 with `num_devices=2` (768 synthetic frustums, 12 steps,
     resumed to 24) and `train_semisup.train` at phase 25's configuration
     with `num_devices=2`, each run twice from one seed: every file they
     write the same (checkpoints loaded, the log without its time stamps
     and rates), one config line a call in the log (only rank 0 writes),
     no stray files, the resume logged. `--data_parallel_only` runs
     phases 1, 2 and 30 alone; `--world N` runs N ranks, on a machine
     with N cards a card each over NCCL, and then also prints the
     config5 driver's frustums/s beside one card's.
 31. points-axis sharding (`data_points_mesh`), four rank processes on
     the one card over gloo (a card each over NCCL on a machine with
     four), each with `f32_numerics()` as here, serving two meshes in
     turn: (a) phase 30's (a) step on a (2, 2) mesh and (b) its (b) step
     on (2, 2), then (b) on (1, 2) and (c) a v2 predict step (B=128,
     phase 3's model: half the points masked) on (1, 2). (a) and (b)
     against the 1-rank step at `PP_V1_LIMITS` / `PP_V2_LIMITS` (phase
     30's, v2 with the whole gradient's norm) beside the witness on the
     batch's halves swapped and the controls `local_pool` (each max over
     points on the rank's points), `local_bn`, `local_masking` (the
     masking on the rank's points) and `box_grads_everywhere` (the box
     stages' gradients over every rank, not the data group), which must
     each fail one; every rank the same loss and gradient; 4 K1 and 8 of
     each of K5-K9 a rank on v2, nothing on v1. (c): 4 K1 and 8 K2 a
     rank; the seg logits, the whole frustums' masks and `seg_conf` at
     `PP_PREDICT_LIMITS`, and every other detection of a frustum with the
     1-rank mask bit-identical; the same with every point masked (all
     frustums); the witness one rank in two calls of B / 2, the control
     `local_pool` must fail. The last (1, 2) rank holds K1, K5-K9 of one
     train step and K1, K2 of one predict step, at its own shapes, to
     their plain twins as phase 28 does. Step and collective times
     beside one rank's. `--points_parallel_only` runs phases 1, 2 and 31
     alone.
 32. the rest of the points mesh, four rank processes as in phase 31,
     serving three meshes in turn: (a) the BoxPC step (f32, config 4's
     widths: N=1024, C=6, B=32; the draws from a CPU generator of one
     seed) on (2, 2) and (1, 2); (b) the phase-B step of phase 25's
     detector (v2 bf16 fused, config 4's widths, 32 strong and 32 weak
     frustums on the 1/256 grid, every point masked past a margin, the
     box net's input snapped, both passes' keep masks injected, a frozen
     BoxPC, the trust gate open) on (2, 2) and (1, 2); (c)
     `BoxEstimationOnly` (f32, config 1's widths: N=512, chair, B=32) on
     (2, 2); each against the 1-rank step at `PT_LIMITS` (the loss, the
     gradient cosines per net, the BN buffers, the gradient norm),
     beside a witness (the 1-rank step on each frustum's point halves
     swapped, in (b) on the batch's halves swapped) and the controls
     `local_pool` and `local_bn`, which must each fail one; (b) on (1,
     2) also at `PT_BOX_LIMITS` (`box_cot`: the cotangent of the
     predicted box from the weak losses on the rank's rows) beside a
     witness (the weak losses on each weak frustum's point halves
     swapped) and the control `box_cotangent_unsummed` (BoxPC's
     cotangent of the box left unsummed over the points group), which
     must fail it; every rank the same loss and gradient; K1 8, K5-K7 16
     and K8/K9 10 a rank
     in (b), nothing in (a) and (c); the last (1, 2) rank holds K1, K5-K9
     of one (b) step and K1, K2 of a predict step on its weak block, at
     its own shapes, to their plain twins. Then the large N: a v1 bf16
     step at B=32, N=16,384, C=6 on one rank and on (1, 4) (4,096 points
     a frustum a rank) within `PP_V1_LIMITS` of one rank, each rank's
     step time and peak device memory. `--points_transfer_only` runs
     phases 1, 2 and 32 alone.
Every kernel's time stands beside its bound: the least time the card
could take for the same bytes (each input read once, each output written
once) and operations at the published peaks; K9's member buffer and
rank table, bytes of its design and not of the function, stand beside
its bound with the bound they would give. Then a JSON line with the
ten kernels, and last the JSON ok line. Any failed check exits non-zero
and prints no ok line.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import functools
import importlib.util
import json
import math
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

B, N, C = 128, 1024, 4
CHECK_B = 8  # frustums in the card-vs-CPU end-to-end check
# Phase 10's bf16 limits: a 2% loss gap and a seg-net cosine of 0.99; the
# whole-model, T-Net and box-net cosines do not reach 0.99 between two
# bf16 implementations, and their limits are set from the readings in
# PERF.md (the T-Net's gradient is a sum over the box net's input
# gradients that cancels to about 2e-4 of their magnitudes). Every limit
# is failed by one of phase 10's controls.
BF16_LOSS_REL = 0.02
BF16_COS = {"all": 0.95, "seg_net": 0.99, "tnet": 0.5, "box_net": 0.97}


def _fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def _check(cond: bool, msg: str) -> None:
    if not cond:
        _fail(msg)


def _expect_launches(launches: dict, want: dict) -> None:
    """The kernels named in `want` launched that often, every other kernel
    of the port not at all."""
    full = {k: want.get(k, 0) for k in launches}
    _check(launches == full and set(want) <= set(launches),
           f"expected launches {full}, got {launches}")


# Published peaks of one H100 SXM (NVIDIA's data sheet): device memory
# bytes/s, bf16 tensor-core FLOP/s, f32 FLOP/s outside the tensor cores.
PEAK_BYTES, PEAK_BF16, PEAK_F32 = 3.35e12, 989e12, 67e12


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if torch.is_tensor(t))


def _bound(nbytes: float, flops: float, rate: float):
    """The least time in ms the card could take: the larger of the bytes
    over the memory rate and the operations over their peak rate."""
    by_bytes, by_ops = nbytes / PEAK_BYTES * 1e3, flops / rate * 1e3
    return ((by_bytes, "bytes") if by_bytes >= by_ops
            else (by_ops, "operations"))


def _entry(name, source, replaces, launches, err, ms, plain_ms, bound):
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound[0],
            "bound_by": bound[1], "library_ms": None}


def _script(name: str):
    """scripts/<name>.py as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Record:
    __slots__ = ("frame_id", "class_idx", "frustum_angle", "score", "box2d")

    def __init__(self, frame_id, class_idx, frustum_angle, score):
        self.frame_id = frame_id
        self.class_idx = class_idx
        self.frustum_angle = frustum_angle
        self.score = score
        self.box2d = np.zeros(4, np.float32)


class SyntheticFrustums:
    """Seeded frustums in the rotated-to-center frame: points on the
    surface of one object box (as a depth sensor sees it), plus clutter
    along the frustum ray and a ground plane, with an intensity channel.
    `spread` varies per frustum from a tight crop around the object to a
    frustum reaching meters beyond it. `get_batch` returns the dict
    `make_predict_step` takes."""

    def __init__(self, count: int, cfg, seed: int):
        from transferable3d_torch.core.geometry import rotate_points_y_np

        rng = np.random.RandomState(seed)
        self.records, self.points, self.class_idx = [], [], []
        for i in range(count):
            k = rng.randint(cfg.num_classes)
            size = (cfg.mean_size_array()[k]
                    * rng.uniform(0.8, 1.25, 3)).astype(np.float32)
            depth = rng.uniform(3.0, 8.0)
            center = np.array([rng.uniform(-0.25, 0.25) * depth,
                               rng.uniform(0.2, 1.2), depth], np.float32)
            spread = rng.uniform(0.05, 1.0)
            n_obj = rng.randint(200, N)
            local = rng.uniform(-0.5, 0.5, (n_obj, 3))
            face = rng.randint(0, 3, n_obj)
            local[np.arange(n_obj), face] = np.where(
                rng.rand(n_obj) < 0.5, -0.5, 0.5)
            local = local * size[[0, 2, 1]] + rng.normal(0, 0.01,
                                                         (n_obj, 3))
            obj = rotate_points_y_np(local[None].astype(np.float32),
                                     np.float32(rng.uniform(-np.pi, np.pi)))
            obj = obj[0] + center
            n_gr = rng.randint(0, (N - n_obj) // 2 + 1)
            half = 2.0 * spread
            ground = np.stack([center[0] + rng.uniform(-half, half, n_gr),
                               np.full(n_gr, center[1] + size[2] / 2),
                               center[2] + rng.uniform(-half, half, n_gr)],
                              -1)
            n_cl = N - n_obj - n_gr
            ray = center[None] * rng.uniform(1 - 0.6 * spread,
                                             1 + 0.4 * spread, (n_cl, 1))
            clutter = ray + rng.normal(0, 0.8 * spread, (n_cl, 3))
            pts = np.concatenate([obj, ground, clutter]).astype(np.float32)
            pts = pts[rng.permutation(N)]
            angle = float(-np.arctan2(center[0], center[2]))
            pts = rotate_points_y_np(pts[None], np.float32(angle))[0]
            inten = rng.uniform(0, 1, (N, 1)).astype(np.float32)
            self.points.append(np.concatenate([pts, inten], 1))
            self.class_idx.append(k)
            self.records.append(Record(f"smoke_{i:04d}", k, angle,
                                       float(rng.uniform(0.5, 1.0))))
        self.num_classes = cfg.num_classes

    def __len__(self):
        return len(self.records)

    def get_batch(self, idxs):
        k = np.asarray([self.class_idx[i] for i in idxs])
        return {"points": np.stack([self.points[i] for i in idxs]),
                "one_hot": np.eye(self.num_classes, dtype=np.float32)[k],
                "class_idx": k.astype(np.int64)}


def _perturb_bn(model, gen: torch.Generator) -> None:
    from transferable3d_torch.models.layers import ScheduledBatchNorm

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, ScheduledBatchNorm):
                f = m.mean.numel()
                m.mean.copy_(torch.randn(f, generator=gen) * 0.2)
                m.var.copy_(torch.rand(f, generator=gen) * 1.5 + 0.5)


def _time_ms(fn, warmup: int, iters: int) -> float:
    for _ in range(warmup):
        fn()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


def _check_fps(phase, xyz, k):
    """K1 against its plain twin: the same indices."""
    from transferable3d_torch.ops import sampling

    got, ref = sampling.fps_cuda(xyz, k), sampling.fps_plain(xyz, k)
    torch.cuda.synchronize()
    same = torch.equal(got, ref)
    print(f"{phase} fps [{xyz.shape[0]},{xyz.shape[1]}]->{k}: "
          f"indices identical {same}", flush=True)
    _check(same, "FPS kernel indices differ from the plain twin")
    return float((got - ref).abs().max())


def _check_sa_infer(phase, a):
    """K2 against its plain twin: >= 99% of the pooled values the same
    bits, max |diff| <= 1% of max |pooled|, and >= 10% nonzero (a pooled
    output of zeros would hold nothing)."""
    from transferable3d_torch.ops import fused_sa

    g = fused_sa.sa_infer_cuda(*a).float()
    r = fused_sa.sa_infer_plain(*a).float()
    eq = float((g == r).float().mean())
    err = float((g - r).abs().max())
    top = float(r.abs().max())
    nz = float((r != 0).float().mean())
    print(f"{phase} sa_infer S={a[0].shape[1]} K={a[5]} "
          f"F={[p.shape[-1] for p in a[6]]}: bit-identical {eq:.5f} "
          f"max|diff| {err:.4g} (max|pooled| {top:.4g}) "
          f"nonzero {nz:.3f}", flush=True)
    _check(eq >= 0.99 and err <= 0.01 * top and nz >= 0.10,
           "sa_infer kernel disagrees with its plain twin")
    return err


def serve(args, dev, card: str, keep: dict):
    """Phases 3-7 (serving); runs under torch.no_grad(). Returns the
    kernels' JSON entries for K1 and K2, and leaves in `keep` what phase
    29 reuses: the predict step, its batch, the frustums and the first
    detection."""
    from transferable3d_torch.core import bins
    from transferable3d_torch.models import pointnet2, registry
    from transferable3d_torch.ops import _build, fused_sa, sampling
    from transferable3d_torch.train import test as test_lib
    from transferable3d_torch.train import train_loop

    # 3. model and inputs
    cfg = bins.SUNRGBD
    gen = torch.Generator().manual_seed(args.seed)
    model = registry.get_model("frustum_pointnets_v2", cfg,
                               dtype=torch.bfloat16, device=dev,
                               generator=gen).eval()
    _perturb_bn(model, gen)
    data = SyntheticFrustums(4 * B, cfg, args.seed)
    batch = data.get_batch(list(range(B)))
    predict = train_loop.make_predict_step(model, cfg)
    # Shift the foreground logit so about half the points are masked (a
    # random net masks almost none, and the box net then sees one point).
    logits = model.seg_net(torch.as_tensor(batch["points"], device=dev),
                           torch.as_tensor(batch["one_hot"], device=dev))
    logits = logits.float()
    model.seg_net.seg_out.bias[1] -= (logits[..., 1]
                                      - logits[..., 0]).median()
    print(f"phase 3 model: v2 bf16, "
          f"{sum(p.numel() for p in model.parameters())} params, "
          f"B={B} N={N} C={C}, seed {args.seed}", flush=True)

    # 4. the main path, with the kernels' arguments captured
    calls = {"fps": [], "sa_infer": []}
    orig_fps, orig_sa = pointnet2.farthest_point_sample, fused_sa.sa_infer

    def rec_fps(xyz, k):
        calls["fps"].append((xyz, k))
        return orig_fps(xyz, k)

    def rec_sa(*a):
        calls["sa_infer"].append(a)
        return orig_sa(*a)

    pointnet2.farthest_point_sample, fused_sa.sa_infer = rec_fps, rec_sa
    try:
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        out = predict(batch)
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
    finally:
        pointnet2.farthest_point_sample, fused_sa.sa_infer = orig_fps, orig_sa
    print(f"phase 4 predict: launches {launches}", flush=True)
    _expect_launches(launches, {"fps": 4, "sa_infer": 8})
    _check(len(calls["fps"]) == 4 and len(calls["sa_infer"]) == 8,
           "captured calls do not match the launches")
    for key, shape in (("center", (B, 3)), ("size", (B, 3)),
                       ("heading", (B,)), ("seg_conf", (B,))):
        _check(tuple(out[key].shape) == shape
               and bool(torch.isfinite(out[key]).all()),
               f"predict output {key} not finite of shape {shape}")
    _check(float(out["mask_count"].float().mean()) > 0, "empty masks only")
    for i, a in enumerate(calls["sa_infer"]):
        cent, xyz, r, k = a[0], a[1], a[4], a[5]
        d2 = sum((cent[:, :, None, c] - xyz[:, None, :, c]) ** 2
                 for c in range(3))
        cnt = (d2 <= fused_sa.radius_sq(r)).sum(-1)
        share = {name: float(m.float().mean()) for name, m in (
            ("empty", cnt == 0), ("short", (cnt > 0) & (cnt < k)),
            ("full", cnt == k), ("overfull", cnt > k))}
        print(f"  scale {i}: S={cent.shape[1]} N={xyz.shape[1]} K={k} "
              f"r={r}: " + " ".join(f"{nm} {v:.4f}"
                                    for nm, v in share.items()),
              flush=True)

    # 5. kernels vs plain twins on the captured arguments
    fps_err = max(_check_fps("phase 5", *a) for a in calls["fps"])
    _fps_probes(dev, args.seed)
    sa_err = 0.0
    for a in calls["sa_infer"]:
        sa_err = max(sa_err, _check_sa_infer("phase 5", a))
        # Every centroid is one of the points it groups, so the main path
        # never has an empty ball: move every other centroid 100 m away
        # to hold the kernel's nearest-point branch against the twin.
        far = a[0].clone()
        far[:, ::2] += 100.0
        got = fused_sa.sa_infer_cuda(far, *a[1:]).float()
        ref = fused_sa.sa_infer_plain(far, *a[1:]).float()
        eq_far = float((got == ref).float().mean())
        err_far = float((got - ref).abs().max())
        print(f"  empty-ball probe: bit-identical {eq_far:.5f} max|diff| "
              f"{err_far:.4g}", flush=True)
        _check(eq_far >= 0.99 and err_far <= 0.01 * float(ref.abs().max()),
               "sa_infer kernel disagrees on empty balls")
    _infer_probes(dev, args.seed)
    small = data.get_batch(list(range(CHECK_B)))
    cpu_model = copy.deepcopy(model).to("cpu")
    ep_gpu = model(torch.as_tensor(small["points"], device=dev),
                   torch.as_tensor(small["one_hot"], device=dev))
    ep_cpu = cpu_model(torch.as_tensor(small["points"]),
                       torch.as_tensor(small["one_hot"]))
    lg, lc = ep_gpu["seg_logits"].float().cpu(), ep_cpu["seg_logits"].float()
    seg_rel = float((lg - lc).abs().max() / lc.abs().max())
    mask_agree = float((ep_gpu["mask"].cpu() == ep_cpu["mask"]).float().mean())
    print(f"phase 5 end-to-end card vs CPU plain twins ({CHECK_B} frustums):"
          f" seg logits max|diff|/max {seg_rel:.4g}, mask agreement "
          f"{mask_agree:.4f}", flush=True)
    _check(seg_rel <= 0.03 and mask_agree >= 0.99,
           "card path disagrees with the CPU reference")

    # 6. run_inference over 4 batches
    t0 = time.perf_counter()
    dets = test_lib.run_inference(model, data, cfg, batch_size=B)
    wall = time.perf_counter() - t0
    ok = all(np.isfinite(d.center).all() and np.isfinite(d.size).all()
             and math.isfinite(d.score) and math.isfinite(d.heading)
             for d in dets)
    print(f"phase 6 run_inference: {len(dets)} detections in {wall:.3f} s, "
          f"finite {ok}", flush=True)
    _check(len(dets) == 4 * B and ok, "run_inference output not finite")
    keep.update(predict=predict, batch=batch, data=data, det=dets[0])

    # 7. times, and the least time the card could take for the same work:
    # every input read once and every output written once; FPS does about
    # 10 f32 operations per point and pick; K2's products run over the
    # eff distinct rows of each ball in this run's data.
    def fps_bound(xyz, k):
        b, n, _ = xyz.shape
        return _nbytes(xyz) + b * k * 4, 10.0 * b * n * k

    def sa_bound(cent, xyz, pf, qc, r, k, packs, ws, bs):
        cnt = (fused_sa.direct_sqdist(cent, xyz)
               <= fused_sa.radius_sq(r)).sum(-1)
        rows = float(cnt.clamp(1, k).sum())
        out = cent.shape[0] * cent.shape[1] * packs[-1].shape[-1] * 2
        return (_nbytes(cent, xyz, pf, qc, *packs, *ws, *bs) + out,
                2.0 * rows * sum(w.numel() for w in ws))

    kernels = []
    for name, kern, plain, cl, src, repl, err, cost, rate in (
            ("fps", sampling.fps_cuda, sampling.fps_plain, calls["fps"],
             "transferable3d_torch/csrc/fps.cu",
             "transferable3d_tpu/ops/sampling.py:47", fps_err, fps_bound,
             PEAK_F32),
            ("sa_infer", fused_sa.sa_infer_cuda, fused_sa.sa_infer_plain,
             calls["sa_infer"], "transferable3d_torch/csrc/sa_infer.cu",
             "transferable3d_tpu/ops/fused_sa.py:446", sa_err, sa_bound,
             PEAK_BF16)):
        tot_k = tot_p = 0.0
        nbytes = flops = 0.0
        for a in cl:
            mk = _time_ms(lambda: kern(*a), 2, 10)
            mp = _time_ms(lambda: plain(*a), 1, 5)
            tot_k += mk
            tot_p += mp
            by, fl = cost(*a)
            nbytes += by
            flops += fl
            shape = (f"[{a[0].shape[0]},{a[0].shape[1]}]->{a[1]}"
                     if name == "fps" else
                     f"S={a[0].shape[1]} K={a[5]} "
                     f"F={[p.shape[-1] for p in a[6]]}")
            print(f"phase 7 {name} {shape}: kernel {mk:.4f} ms, plain "
                  f"{mp:.4f} ms, bound {_bound(by, fl, rate)[0]:.4f} ms "
                  f"{card}", flush=True)
        bound = _bound(nbytes, flops, rate)
        kernels.append(_entry(name, src, repl, launches[name], err, tot_k,
                              tot_p, bound))
        print(f"phase 7 {name} per forward ({len(cl)} calls): kernel "
              f"{tot_k:.4f} ms, plain {tot_p:.4f} ms, bound {bound[0]:.4f} "
              f"ms by {bound[1]} {card}", flush=True)
    step_ms = _time_ms(lambda: predict(batch), 2, 10)
    print(f"phase 7 predict step B={B}: {step_ms:.3f} ms, "
          f"{B * 1000.0 / step_ms:.1f} frustums/s {card}", flush=True)

    return kernels


def _fps_probes(dev, seed):
    """K1 against its plain twin at 1 to 12,288 points (both paths of the
    kernel and the corners of its plan), k of 1, 2 and every point, on
    seeded points with repeats, on all-equal points and on every point
    given twice: indices identical."""
    from transferable3d_torch.ops import sampling

    g = torch.Generator(device=dev).manual_seed(seed)
    for n in (1, 31, 32, 33, 128, 512, 1024, 4096, 12288):
        xyz = torch.rand(2, n, 3, generator=g, device=dev) * 8 - 4
        xyz[:, n // 2:n // 2 + 5] = xyz[:, :1]
        sets = {"random": xyz,
                "all equal": torch.full((2, n, 3), 1.5, device=dev),
                "twice": xyz[:, :(n + 1) // 2].repeat(1, 2, 1)[:, :n]
                .contiguous()}
        same = {}
        for k in sorted({1, 2, n}):
            for name, pts in sets.items():
                same[f"k={k} {name}"] = torch.equal(
                    sampling.fps_cuda(pts, k), sampling.fps_plain(pts, k))
        print(f"phase 5 fps probe n={n}: indices identical "
              f"{all(same.values())} ({len(same)} cases, plan "
              f"{tuple(sampling.fps_plan(n))})", flush=True)
        _check(all(same.values()), f"FPS kernel indices differ from the "
               f"plain twin at n={n}: {[k for k, v in same.items() if not v]}")


# K2's probes (phase 5): (name, B, N, S, radius, K, widths). Ragged
# chains that the launcher pads to multiples of 16, K = 24 and K = 1, a
# radius that leaves every ball one member, a last layer of 512 and a
# chain whose inner layer (160) takes the general f32 kernel.
INFER_PROBES = (("K=24, widths 40", 16, 1024, 128, 0.4, 24, (40, 64, 40)),
                ("K=1", 16, 1024, 128, 0.4, 1, (64, 64, 128)),
                ("every ball one member", 16, 1024, 128, 1e-4, 128,
                 (64, 96, 128)),
                ("last layer 512", 8, 1024, 128, 0.4, 64, (64, 64, 512)),
                ("inner layer 160 (f32 kernel)", 8, 512, 64, 0.4, 64,
                 (64, 160, 64)))


def _infer_probes(dev, seed):
    """K2 against its plain twin on the INFER_PROBES chains (seeded
    points, weights and BN statistics; every eighth centroid far away, so
    its ball is empty): >= 99% of pooled values bit-identical and max
    |diff| <= 1% of max |pooled|."""
    from transferable3d_torch.ops import fused_sa

    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=dev) * scale

    for name, b, n, s, r, k, dims in INFER_PROBES:
        xyz = randn(b, n, 3, scale=0.5)
        cent = xyz[:, :s].clone()
        cent[:, ::8] += 100.0
        pf, qc = randn(b, n, dims[0]).bfloat16(), randn(b, s, dims[0]).bfloat16()
        packs = [fused_sa._make_pack(
            torch.rand(f, generator=g, device=dev) + 0.5, randn(f, scale=0.2),
            randn(f, scale=0.2), torch.rand(f, generator=g, device=dev) + 0.5,
            1e-3) for f in dims]
        ws = [randn(dims[i], dims[i + 1], scale=dims[i] ** -0.5)
              for i in range(len(dims) - 1)]
        bs = [randn(f, scale=0.1) for f in dims[1:]]
        a = (cent, xyz, pf, qc, r, k, packs, ws, bs)
        eq, err, top = _bf16_agree(fused_sa.sa_infer_cuda(*a),
                                   fused_sa.sa_infer_plain(*a))
        plan = fused_sa.sa_infer_plan(k, tuple(dims))
        print(f"phase 5 sa_infer probe {name}: S={s} K={k} F={list(dims)} "
              f"({'tensor cores' if plan.mma else 'f32 pipes'}, widths "
              f"{list(plan.dims)}): bit-identical {eq:.5f} max|diff| "
              f"{err:.4g} (max|pooled| {top:.4g})", flush=True)
        _check(eq >= 0.99 and err <= 0.01 * top and top > 0,
               f"sa_infer kernel disagrees with its plain twin ({name})")


def _ball_shares(cent, xyz, r, k):
    from transferable3d_torch.ops.grouping import direct_sqdist, radius_sq

    cnt = (direct_sqdist(cent, xyz) <= radius_sq(r)).sum(-1)
    return {name: float(m.float().mean()) for name, m in (
        ("empty", cnt == 0), ("short", (cnt > 0) & (cnt < k)),
        ("full", cnt == k), ("overfull", cnt > k))}


def _grads(model):
    return {k: (torch.zeros_like(p) if p.grad is None else p.grad).float()
            for k, p in model.named_parameters()}


def _snap_to_grid(mod, args):
    """Forward pre-hook of the box net (phase 10, bf16): moves each
    frustum's object points rigidly to a frame both devices agree on, and
    onto the 1/256 grid. Their offsets from the first point lie on the
    grid up to f32 rounding, which the hook removes; their mean on that
    grid is then exact in any summation order. So both devices feed the
    box net the same exact coordinates, however the T-Net's output
    rounds, and take the same FPS picks and balls. The gradient passes
    straight through."""
    obj = args[0]
    with torch.no_grad():
        snapped = torch.round((obj - obj[:, :1]) * 256) / 256
        snapped -= torch.round(snapped.mean(dim=1, keepdim=True) * 256) / 256
    return (snapped + (obj - obj.detach()), *args[1:])


class _BF16SumGather:
    """Phase 10's control: the CPU path's grouped gather with plain
    autograd, which sums a bf16 cotangent in bf16, rounding at every add
    (the grouping code sums it in f32 and rounds once)."""

    @staticmethod
    def apply(src, idx):
        from transferable3d_torch.ops.grouping import flat_row_gather

        return flat_row_gather(src, idx)


def _cos(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    den = float(a.norm() * b.norm())
    return float((a * b).sum()) / den if den > 0 else float("nan")


class SmallStep:
    """One train step on a few frustums, on the card or on the CPU, from
    copies of one model, with one dropout keep mask (phases 10 and 14).

    The frustums are moved to their own mean and onto a 1/256 grid: far
    from the origin the two devices' expanded-form distances differ by
    ~1e-5, enough to move a point across a 0.2 m ball's boundary, and FPS
    is chaotic (one different pick changes every later one); on the grid
    the squared distances and the mask centroid are exact, so both devices
    take the same discrete decisions in the seg net. With `pin`, two more
    decisions are pinned for bf16: the foreground logit's bias is raised
    past every logit gap (`margin`), so that rounding cannot flip a point
    of the mask on one side only, and the box net's input is snapped to
    the grid (`_snap_to_grid`), so that the T-Net's bf16 rounding cannot
    change the box net's balls on one side only."""

    def __init__(self, cfg, initial, batch, lr, bn, seed, dev,
                 name="frustum_pointnets_v2", model_kw=None, step_cfg=None,
                 adapt=None, count=CHECK_B):
        """`name`, `model_kw` and `step_cfg` select the model and the
        step (default: v2, IoU metrics on); `adapt(model)`, if given,
        changes the layers of every model built as `initial` was; the
        step takes the first `count` frustums of `batch`."""
        from transferable3d_torch.models import layers
        from transferable3d_torch.train import train_loop

        self.cfg, self.initial, self.lr, self.bn = cfg, initial, lr, bn
        self.name, self.model_kw = name, model_kw or {}
        self.adapt = adapt
        self.step_cfg = step_cfg or train_loop.StepConfig()
        small = {k: v[:count].copy() for k, v in batch.items()}
        mean = small["points"][..., :3].mean(axis=1)
        small["points"][..., :3] = np.round(
            (small["points"][..., :3] - mean[:, None]) * 256) / 256
        small["center"] = small["center"] - mean
        self.small = small
        self.keep = layers.dropout_keep_mask(
            (count, N, 128), 0.5, torch.Generator().manual_seed(seed + 2))
        self.other_keep = layers.dropout_keep_mask(
            (count, N, 128), 0.5, torch.Generator().manual_seed(seed + 3))
        self.perm = np.arange(count)[::-1].copy()
        probe = copy.deepcopy(initial).train()
        with self._keep_mask(self.keep), torch.no_grad():
            logits = probe(torch.as_tensor(small["points"], device=dev),
                           torch.as_tensor(small["one_hot"], device=dev),
                           bn(0), torch.Generator())["seg_logits"].float()
        self.margin = 1.0 + 2.0 * float(
            (logits[..., 1] - logits[..., 0]).abs().max())

    @staticmethod
    @contextlib.contextmanager
    def _keep_mask(mask):
        from transferable3d_torch.models import layers

        orig = layers.dropout_keep_mask
        layers.dropout_keep_mask = lambda shape, rate, gen: mask
        try:
            yield
        finally:
            layers.dropout_keep_mask = orig

    def __call__(self, dtype, where, pin=False, order=None, mask_keep=None):
        """One step on the frustums in `order` with the keep mask
        `mask_keep` (default `keep`). Returns the loss, the gradients and
        the predicted mask."""
        from transferable3d_torch.models import pointnet2, registry
        from transferable3d_torch.train import train_loop

        m = registry.get_model(self.name, self.cfg, dtype=dtype,
                               device=where, **self.model_kw)
        if self.adapt is not None:
            self.adapt(m)
        m.load_state_dict(self.initial.state_dict())
        if pin:
            with torch.no_grad():
                m.seg_net.seg_out.bias[1] += self.margin
            # Only a box net with set abstraction (v2) takes FPS picks
            # and balls that the snap has to keep apart.
            if any(isinstance(x, (pointnet2.SetAbstraction,
                                  pointnet2.SetAbstractionMSG))
                   for x in m.box_net.modules()):
                m.box_net.register_forward_pre_hook(_snap_to_grid)
        st = train_loop.create_train_state(
            m, train_loop.make_optimizer(self.lr),
            generator=torch.Generator())
        b_, k_ = self.small, self.keep if mask_keep is None else mask_keep
        if order is not None:
            b_ = {k: v[order] for k, v in b_.items()}
            k_ = k_[torch.from_numpy(order)]
        seen = {}
        hook = m.register_forward_hook(
            lambda mod, a, out: seen.update(mask=out["mask"].cpu()))
        try:
            with self._keep_mask(k_):
                _, met = train_loop.make_train_step(
                    self.cfg, self.lr, self.bn, self.step_cfg)(st, b_)
        finally:
            hook.remove()
        mask = seen["mask"]
        if order is not None:
            mask = mask[torch.from_numpy(np.argsort(order))]
        return (float(met["total_loss"]),
                {k: g.cpu() for k, g in _grads(m).items()}, mask)


def relabelled(one_step, *a, **kw):
    """`one_step(*a, **kw)` with its labels moved: the seg labels
    inverted, every box center 10 m off along x and z, and each frustum
    given its neighbour's heading and size labels. A control that moves
    the loss and the seg and box nets' gradients, whatever the noise of
    the unpinned controls."""
    labels = ("seg", "center", "heading_class", "heading_residual",
              "size_class", "size_residual")
    kept = {k: one_step.small[k] for k in labels}
    one_step.small.update({k: np.roll(v, 1, axis=0) for k, v in kept.items()})
    one_step.small["seg"] = 1 - kept["seg"]
    one_step.small["center"] = kept["center"] + np.float32([10.0, 0, 10.0])
    try:
        return one_step(*a, **kw)
    finally:
        one_step.small.update(kept)


def _bn_without_batch_terms(bn, x, momentum=0.9):
    """`ScheduledBatchNorm.forward` in train mode with the batch mean and
    variance held as constants in the backward: dx = dy * scale / sigma,
    without the terms through the statistics."""
    xf = x.float()
    with torch.no_grad():
        axes = tuple(range(x.dim() - 1))
        mean = xf.mean(dim=axes)
        var = (xf * xf).mean(dim=axes) - mean * mean
        bn.mean.mul_(momentum).add_((1.0 - momentum) * mean)
        bn.var.mul_(momentum).add_((1.0 - momentum) * var)
    inv = torch.reciprocal(torch.sqrt(var + bn.EPSILON)) * bn.scale
    return ((xf - mean) * inv + bn.bias).to(bn.dtype or x.dtype)


def tnet_bn_detached(one_step, *a, **kw):
    """`one_step(*a, **kw)` with the T-Net's batch norms missing the
    batch-statistic terms of their backward (a classic fault of a
    hand-written batch norm): the control of the T-Net's limit. The
    forward is unchanged."""
    from transferable3d_torch.models import layers

    adapt = one_step.adapt

    def detached(model):
        if adapt is not None:
            adapt(model)
        for mod in model.tnet.modules():
            if isinstance(mod, layers.ScheduledBatchNorm):
                mod.forward = functools.partial(_bn_without_batch_terms, mod)

    one_step.adapt = detached
    try:
        return one_step(*a, **kw)
    finally:
        one_step.adapt = adapt


def compare(a, b):
    """Relative loss gap, and gradient cosines: the whole model, each
    net, and the worst leaf."""
    (la, ga, _), (lb, gb, _) = a, b
    cos = {}
    for net in ("all", "seg_net", "tnet", "box_net"):
        ks = [k for k in ga if net == "all" or k.startswith(net + ".")]
        cos[net] = _cos(torch.cat([ga[k].ravel() for k in ks]),
                        torch.cat([gb[k].ravel() for k in ks]))
    leaf = min((_cos(ga[k].ravel(), gb[k].ravel()), k) for k in ga
               if float(gb[k].norm()) > 0)
    return abs(la - lb) / abs(lb), cos, leaf


def show(tag, res):
    rel, cos, leaf = res
    print(f"{tag}: total loss rel {rel:.4g}, gradient cosine "
          + ", ".join(f"{k} {v:.5f}" for k, v in cos.items())
          + f", worst leaf {leaf[1]} {leaf[0]:.4f}", flush=True)


def failed(res, limits):
    """The limits (`BF16_LOSS_REL` and the cosines `limits`) res fails."""
    return ((["loss"] if res[0] > BF16_LOSS_REL else [])
            + [k for k, v in limits.items() if res[1][k] < v])


def judge(phase, what, limits, runs, controls):
    """Print every run and control with the limits it fails; require that
    the first run passes and that every limit is failed by a control."""
    print(f"{phase} {what}; limits: total loss rel <= {BF16_LOSS_REL}, "
          "cosine " + ", ".join(f"{k} >= {v}" for k, v in limits.items()),
          flush=True)
    for tag, r in {**runs, **controls}.items():
        show(f"{phase}   {tag}", r)
        print(f"    fails {failed(r, limits) or 'no limit'}", flush=True)
    first = next(iter(runs))
    _check(not failed(runs[first], limits), f"{phase}: {first} disagree")
    caught = {k for r in controls.values() for k in failed(r, limits)}
    _check(caught >= {"loss", *limits},
           f"{phase}: no control fails the limits "
           f"{sorted({'loss', *limits} - caught)}")


@contextlib.contextmanager
def fused_sa_env(value):
    """T3D_FUSED_SA set to `value` (None: unset, the default) and restored."""
    saved = os.environ.get("T3D_FUSED_SA")
    if value is None:
        os.environ.pop("T3D_FUSED_SA", None)
    else:
        os.environ["T3D_FUSED_SA"] = value
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop("T3D_FUSED_SA", None)
        else:
            os.environ["T3D_FUSED_SA"] = saved


def train_batch(cfg):
    """bench.py's v2_train batch from the port's data copies: 32
    synthetic frustums (n_object 600, n_clutter 300), 1024 points each,
    rotated to center, tiled to B."""
    from transferable3d_torch.data import synthetic
    from transferable3d_torch.data.provider import FrustumDataset

    recs = synthetic.make_dataset(32, cfg, seed=0, n_object=600,
                                  n_clutter=300)
    ds = FrustumDataset(recs, cfg, npoints=N, rotate_to_center=True)
    small = ds.get_batch(list(range(32)))
    return {k: np.concatenate([v] * (B // 32), axis=0)
            for k, v in small.items()}


def _check_k3_k4(tag, cent, xyz, pay, dg, r, k, gen, errs):
    """K3 and K4 against their plain twins on one set of arguments. K3:
    rows and counts identical (a gather is exact). K4: bit-identical to
    `extract_bwd_plain` on CPU copies of the arguments, whose `index_add_`
    adds each point's slots in ascending (s, k) from +0.0 in f32 as K4
    does, the same bits on two runs, and identical to the twin on
    integer-valued cotangents on the card; the share identical to the
    twin run on the card (its `index_add_` adds with atomics, in no fixed
    order) is printed as a reading. `errs` keeps the largest |diff| of
    each kernel against the twin on the card."""
    from transferable3d_torch.ops import grouping

    n = xyz.shape[1]
    got, cnt = grouping.extract_fwd_cuda(cent, xyz, pay, r, k)
    ref, cref = grouping.extract_fwd_plain(cent, xyz, pay, r, k)
    same = torch.equal(got, ref) and torch.equal(cnt, cref)
    errs[0] = max(errs[0], float((got.float() - ref.float()).abs().max()))
    have = grouping.extract_bwd_cuda(cent, xyz, dg, r, k)
    again = grouping.extract_bwd_cuda(cent, xyz, dg, r, k)
    on_cpu = grouping.extract_bwd_plain(cent.cpu(), xyz.cpu(), dg.cpu(), r,
                                        k, n)
    on_card = grouping.extract_bwd_plain(cent, xyz, dg, r, k, n)
    exact = torch.equal(have.cpu(), on_cpu)
    twice = torch.equal(have, again)
    card_eq = float((have == on_card).float().mean())
    errs[1] = max(errs[1], float((have.float() - on_card.float()).abs()
                                 .max()))
    dgi = torch.randint(-4, 5, dg.shape, generator=gen,
                        device=dg.device).to(torch.bfloat16)
    integer = torch.equal(grouping.extract_bwd_cuda(cent, xyz, dgi, r, k),
                          grouping.extract_bwd_plain(cent, xyz, dgi, r, k,
                                                     n))
    print(f"phase 9{tag} B={cent.shape[0]} S={cent.shape[1]} N={n} K={k} "
          f"C={pay.shape[-1]}: K3 identical {same}, empty "
          f"{float((cnt == 0).float().mean()):.3f}, eff 1 "
          f"{float((cnt == 1).float().mean()):.3f}, eff K "
          f"{float((cnt >= k).float().mean()):.3f}; K4 identical to the CPU "
          f"twin {exact}, the same twice {twice}, integer cotangents "
          f"identical {integer}; reading: identical to the twin on the card "
          f"{card_eq:.6f}", flush=True)
    _check(same, "K3 disagrees with its plain twin")
    _check(exact and twice and integer, "K4 disagrees with its plain twin")


def _k3_k4_probes(dev, seed, gen, errs):
    """K3 and K4 on seeded points beyond the main path's balls, at the
    ends of their plans: every ball one member (eff = 1) and every ball
    full (eff = K), N = 1, N not a multiple of 32, K = 4,096 (the largest
    K, 3 warps a block in K3), 700 centroids (K4's gather in passes of
    128), C not a multiple of 8 (one bf16 an access) and payload and
    cotangent 2 bytes past a 16-byte boundary; every other centroid 100 m
    away in each (empty balls)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    for b, n, s, r, k, c, off in (
            (4, 512, 128, 1e-4, 64, 64, 0), (4, 512, 128, 100.0, 128, 128, 0),
            (4, 1, 8, 0.4, 32, 64, 0), (4, 100, 40, 0.4, 64, 32, 0),
            (2, 4500, 4, 100.0, 4096, 16, 0), (2, 1024, 700, 0.3, 16, 8, 0),
            (4, 200, 40, 0.5, 24, 20, 0), (4, 256, 64, 0.4, 32, 3, 0),
            (4, 1024, 128, 0.4, 64, 64, 1)):
        xyz = torch.randn(b, n, 3, generator=g, device=dev) * 0.5
        cent = xyz[:, torch.arange(s, device=dev) % n].clone()
        cent[:, ::2] += 100.0

        def bf16_rows(*shape):
            t = torch.empty(math.prod(shape) + off, device=dev,
                            dtype=torch.bfloat16)[off:]
            t.copy_(torch.randn(math.prod(shape), generator=g, device=dev))
            return t.view(shape)

        _check_k3_k4(f" probe{' (unaligned)' if off else ''}", cent, xyz,
                     bf16_rows(b, n, c), bf16_rows(b, s, k, c), r, k, gen,
                     errs)


def train(args, dev, card: str):
    """Phases 8-11 (training on the unfused path, T3D_FUSED_SA=0) and
    their times. Returns the kernels' JSON entries for K3 and K4, and what
    the fused phases reuse."""
    with fused_sa_env("0"):
        return _train(args, dev, card)


def _train(args, dev, card: str):
    from transferable3d_torch.core import bins
    from transferable3d_torch.models import layers, registry
    from transferable3d_torch.ops import _build, grouping
    from transferable3d_torch.train import schedules, train_loop

    # 8. one train step at the v2_train width, K3/K4 arguments captured
    cfg = bins.SUNRGBD
    batch = train_batch(cfg)
    model = registry.get_model(
        "frustum_pointnets_v2", cfg, dtype=torch.bfloat16, device=dev,
        generator=torch.Generator().manual_seed(args.seed + 1))
    initial = copy.deepcopy(model)
    lr = schedules.exponential_staircase_lr(batch_size=B)
    bn = schedules.bn_momentum_schedule(batch_size=B)
    state = train_loop.create_train_state(
        model, train_loop.make_optimizer(lr), seed=args.seed)
    step = train_loop.make_train_step(
        cfg, lr, bn, train_loop.StepConfig(compute_iou_metrics=True))
    calls = {"extract_fwd": [], "extract_bwd": []}
    orig_fwd, orig_bwd = grouping.extract_fwd_cuda, grouping.extract_bwd_cuda

    def detached(a):
        return tuple(x.detach() if torch.is_tensor(x) else x for x in a)

    def rec_fwd(*a):
        calls["extract_fwd"].append(detached(a))
        return orig_fwd(*a)

    def rec_bwd(*a):
        calls["extract_bwd"].append(detached(a))
        return orig_bwd(*a)

    grouping.extract_fwd_cuda, grouping.extract_bwd_cuda = rec_fwd, rec_bwd
    try:
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
    finally:
        grouping.extract_fwd_cuda = orig_fwd
        grouping.extract_bwd_cuda = orig_bwd
    print(f"phase 8 train step: launches {launches}", flush=True)
    _expect_launches(launches, {"fps": 4, "extract_fwd": 8,
                                "extract_bwd": 8})
    _check(len(calls["extract_fwd"]) == 8 and len(calls["extract_bwd"]) == 8,
           "captured calls do not match the launches")
    vals = {k: float(v) for k, v in metrics.items()}
    print("  metrics: " + " ".join(f"{k} {v:.5g}" for k, v in vals.items()),
          flush=True)
    _check(all(math.isfinite(v) for v in vals.values()),
           "a loss term or metric is not finite")
    grads = _grads(model)
    bad = [k for k, g in grads.items() if not bool(torch.isfinite(g).all())]
    _check(not bad, f"non-finite gradients: {bad}")
    zero = [k for k, g in grads.items() if not bool((g != 0).any())]
    print(f"  gradients: {len(grads)} leaves finite; all-zero leaves "
          f"{zero}", flush=True)
    for i, (cent, xyz, pay, r, k) in enumerate(calls["extract_fwd"]):
        share = _ball_shares(cent, xyz, r, k)
        print(f"  scale {i}: S={cent.shape[1]} N={xyz.shape[1]} K={k} "
              f"C={pay.shape[-1]} r={r}: "
              + " ".join(f"{nm} {v:.4f}" for nm, v in share.items()),
              flush=True)

    # 9. K3 and K4 vs their plain twins on the captured arguments (the
    # backward runs the scales in another order: pair them by inputs), with
    # every other centroid moved 100 m away, and on the probes
    errs = [0.0, 0.0]
    gen = torch.Generator(device=dev).manual_seed(args.seed)

    def key(a):
        return a[0].data_ptr(), a[1].data_ptr(), a[3], a[4]

    cotangents = {key(a): a[2] for a in calls["extract_bwd"]}
    _check(len(cotangents) == 8, "backward calls do not pair with forward")
    for cent, xyz, pay, r, k in calls["extract_fwd"]:
        dg = cotangents[key((cent, xyz, pay, r, k))]
        far = cent.clone()
        far[:, ::2] += 100.0
        for tag, c in (("", cent), (" empty-ball probe", far)):
            _check_k3_k4(tag, c, xyz, pay, dg, r, k, gen, errs)
    _k3_k4_probes(dev, args.seed, gen, errs)
    fwd_err, bwd_err = errs

    # 10. the card against the CPU: one step on 8 frustums (SmallStep)
    one_step = SmallStep(cfg, initial, batch, lr, bn, args.seed, dev)
    on_card, on_cpu = (one_step(torch.float32, w) for w in ("cuda", "cpu"))
    _check(torch.equal(on_card[2], on_cpu[2]), "float32 masks differ")
    res = compare(on_card, on_cpu)
    show(f"phase 10 card vs CPU, float32 ({CHECK_B} frustums)", res)
    _check(res[0] <= 0.02 and res[1]["all"] >= 0.99,
           "the card's float32 train step disagrees with the CPU's")

    bf = torch.bfloat16
    on_card, on_cpu = one_step(bf, "cuda", True), one_step(bf, "cpu", True)
    _check(torch.equal(on_card[2], on_cpu[2]) and bool(on_card[2].all()),
           "bf16 masks differ or are not full")
    runs = {"card vs CPU": compare(on_card, on_cpu),
            "witness: card vs card on the batch reversed":
                compare(on_card, one_step(bf, "cuda", True, one_step.perm)),
            "witness: CPU vs CPU on the batch reversed":
                compare(on_cpu, one_step(bf, "cpu", True, one_step.perm))}
    # Controls: faults the limits must reject. The CPU side summing the
    # grouped cotangent in bf16 (what its backward did before it summed
    # in f32); both sides with the mask and the box net's balls left
    # free to differ; the CPU side with another dropout mask; the CPU side
    # with its labels moved (`relabelled`) and with the T-Net's batch
    # norms missing the batch-statistic terms of their backward
    # (`tnet_bn_detached`).
    orig_gather = grouping._SlotGather
    grouping._SlotGather = _BF16SumGather
    try:
        controls = {"control: CPU summing the grouped cotangent in bf16":
                    compare(on_card, one_step(bf, "cpu", True))}
    finally:
        grouping._SlotGather = orig_gather
    controls["control: both sides unpinned"] = compare(
        one_step(bf, "cuda"), one_step(bf, "cpu"))
    controls["control: CPU with another dropout mask"] = compare(
        on_card, one_step(bf, "cpu", True, mask_keep=one_step.other_keep))
    controls["control: CPU with its labels moved"] = compare(
        on_card, relabelled(one_step, bf, "cpu", True))
    controls["control: CPU with the T-Net's batch norms detached"] = compare(
        on_card, tnet_bn_detached(one_step, bf, "cpu", True))
    judge("phase 10", f"bf16 ({CHECK_B} frustums, foreground margin "
          f"{one_step.margin:.4g})", BF16_COS, runs, controls)

    # 11. 30 steps on the fixed batch
    losses = []
    for _ in range(30):
        state, met = step(state, batch)
        losses.append(float(met["total_loss"]))
    print(f"phase 11 30 steps: first {losses[0]:.5g}, mean of last 5 "
          f"{np.mean(losses[-5:]):.5g}, all finite "
          f"{all(map(math.isfinite, losses))}", flush=True)
    _check(all(map(math.isfinite, losses)), "a training loss is not finite")
    _check(np.mean(losses[-5:]) < losses[0], "the loss did not decrease")

    # times
    torch.cuda.reset_peak_memory_stats(dev)
    step_ms = _time_ms(lambda: step(state, batch), 2, 5)
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"times train step B={B}: {step_ms:.3f} ms, "
          f"{B * 1000.0 / step_ms:.1f} frustums/s, peak device memory "
          f"{peak / 2**30:.2f} GiB {card}", flush=True)
    kernels = []
    for name, kern, plain, cl, repl, err in (
            ("extract_fwd", grouping.extract_fwd_cuda,
             grouping.extract_fwd_plain, calls["extract_fwd"],
             "transferable3d_tpu/ops/grouping.py:365", fwd_err),
            ("extract_bwd", grouping.extract_bwd_cuda,
             lambda c, x, d, r, k: grouping.extract_bwd_plain(
                 c, x, d, r, k, x.shape[1]),
             calls["extract_bwd"],
             "transferable3d_tpu/ops/grouping.py:381", bwd_err)):
        tot_k = tot_p = nbytes = 0.0
        for a in cl:
            mk = _time_ms(lambda: kern(*a), 2, 10)
            mp = _time_ms(lambda: plain(*a), 1, 5)
            tot_k += mk
            tot_p += mp
            cent, xyz, other, _, k = a
            b, s, c = cent.shape[0], cent.shape[1], other.shape[-1]
            # K3: payload in, rows and counts out; K4: the rows (its `other`,
            # dg) in, dpay out; each with the centroids and points in
            by = _nbytes(cent, xyz, other) + (
                b * s * k * c * 2 + b * s * 4 if name == "extract_fwd"
                else b * xyz.shape[1] * c * 2)
            nbytes += by
            print(f"times {name} S={a[0].shape[1]} N={a[1].shape[1]} "
                  f"K={a[4]} C={a[2].shape[-1]}: kernel {mk:.4f} ms, plain "
                  f"{mp:.4f} ms, bound {_bound(by, 0, PEAK_F32)[0]:.4f} ms "
                  f"{card}", flush=True)
        bound = _bound(nbytes, 0, PEAK_F32)
        print(f"times {name} per step ({len(cl)} calls): kernel "
              f"{tot_k:.4f} ms, plain {tot_p:.4f} ms, bound {bound[0]:.4f} "
              f"ms by {bound[1]} {card}", flush=True)
        kernels.append(_entry(
            name, "transferable3d_torch/csrc/ball_extract.cu", repl,
            launches[name], err, tot_k, tot_p, bound))
    return kernels, {"cfg": cfg, "batch": batch, "initial": initial,
                     "lr": lr, "bn": bn, "one_step": one_step,
                     "seed": args.seed,
                     "unfused_ms": step_ms, "unfused_peak": peak}


# Phase 14's bf16 limits (fused set abstraction on the card and on the
# CPU): set from the readings in PERF.md as `BF16_COS` is, each failed by
# one of the phase's controls; the T-Net's above its realistic controls
# (both sides unpinned: up to 0.42; the T-Net's batch norms detached:
# 0.18) and below the least sound reading (the CPU against itself, 0.500).
FUSED_COS = {"all": 0.92, "seg_net": 0.985, "tnet": 0.45, "box_net": 0.95}
# Phase 14 at B = 128 (the card's fused step against its unfused one):
# `FUSED_COS`, with the T-Net's limit set from its own readings: the
# sound runs and the witnesses 0.84-0.90, the T-Net's batch norms
# detached 0.31 (PERF.md section 7).
FULL_BATCH_COS = {**FUSED_COS, "tnet": 0.8}
# The five training kernels: counter, JAX kernel replaced, source file.
FUSED_KERNELS = (
    ("sa_extract", "transferable3d_tpu/ops/fused_sa.py:196",
     "sa_train_fwd.cu"),
    ("sa_fwd_step", "transferable3d_tpu/ops/fused_sa.py:344",
     "sa_train_fwd.cu"),
    ("sa_fwd_last", "transferable3d_tpu/ops/fused_sa.py:359",
     "sa_train_fwd.cu"),
    ("sa_bwd_step", "transferable3d_tpu/ops/fused_sa.py:418",
     "sa_train_bwd.cu"),
    ("sa_bwd_step0", "transferable3d_tpu/ops/fused_sa.py:548",
     "sa_train_bwd.cu"))


def _rel(got, ref) -> float:
    """Norm-wise relative error of an f32 sum against the twin's."""
    return float((got - ref).norm() / ref.norm().clamp_min(1e-30))


def _bf16_agree(got, ref):
    """Share of bit-identical values, max |diff| and max |ref|."""
    g, r = got.float(), ref.float()
    return (float((g == r).float().mean()), float((g - r).abs().max()),
            float(r.abs().max()))


class FusedChecks:
    """K5-K9 against their plain twins (phases 13 and 28). Every method
    takes one
    call's arguments, runs kernel and twin, prints one line, fails on a
    disagreement and returns the max |diff| of the main output.

    Limits, given the same packs on both sides: z1 identical (a gather
    and one subtraction); z' and dy_j >= 99% bit-identical with max |diff|
    <= 1% of max (the products' f32 sums run in another order, which can
    move a bf16 rounding one step); K7's extrema the max and min of its
    own z'; the forward's f32 sums within 1e-4 of the twin's norm; the
    backward's (sum dy_j, sum dy_j xhat_j, dW_j, db_j) within 1e-4 of the
    sums of their terms' magnitudes, since db_j is zero in exact
    arithmetic in train mode and the others cancel in part; cnt exact; H within one bf16 step of every slot's magnitude plus 1e-5 of
    the magnitudes of dh's product terms (the twin's dy_0 may round a
    step away from the kernel's); Mq within 1e-5. Each kernel's sums are
    bit-identical when it runs twice; K9's H, Mq and cnt too, and they
    equal, bit for bit, the twin's order of summation
    (`step0_scatter_plain` on CPU copies) over the kernel's own dy_0.

    The backward's sum dy_j and sum dy_j xhat_j are held to the f64 sums
    over the kernel's own dy_j (K8's output; for K9, which does not
    write dy_0, K8's kernel on the same arguments, its one body), and
    that dy_j to the twin's at the dy limits above. The twin's own sums
    are over its dy_j, whose bf16 roundings may differ a step where the
    kernel's do (allowed above): a ball whose K slots repeat one member
    repeats such a step K times, which alone can move these sums past
    1e-4 of their terms' magnitudes. Their distance from the twin's sums
    is printed beside."""

    def __init__(self, phase=13):
        from transferable3d_torch.ops import fused_sa, grouping

        self.fs, self.grouping, self.phase = fused_sa, grouping, phase

    def _check_sums(self, what, names, got, ref, again, mags=None):
        """Forward sums against the twin's norm; with `mags`, backward
        sums against the sums of their terms' magnitudes."""
        out = []
        for i, (name, a, b, c) in enumerate(zip(names, got, ref, again)):
            if mags is None:
                err = _rel(a, b)
            else:
                err = float(((a - b).abs() / (mags[i] + 1e-30)).max())
            out.append(f"{name} {err:.2e}")
            _check(a.shape == b.shape and err <= 1e-4,
                   f"{what}: {name} off by {err:.3g} (> 1e-4)")
            _check(torch.equal(a, c), f"{what}: {name} differs between two "
                   "runs on the same inputs")
        return (("sums rel " if mags is None else "sums / sum|terms| ")
                + " ".join(out) + ", twice identical")

    def extract(self, tag, cent, xyz, pf, qc, r, k):
        fs = self.fs
        got, ref = (f(cent, xyz, pf, qc, r, k)
                    for f in (fs.sa_extract_cuda, fs.sa_extract_plain))
        again = fs.sa_extract_cuda(cent, xyz, pf, qc, r, k)
        same = (torch.equal(got[0], ref[0])
                and torch.equal(got[0], again[0]))
        sums = self._check_sums("K5", ("sum", "sumsq"), got[1:], ref[1:],
                                again[1:])
        mags = (ref[0].float().abs().sum((0, 1, 2)), ref[2])
        sums += ", " + self._check_sums("K5", ("sum", "sumsq"), got[1:],
                                        ref[1:], again[1:], mags)
        print(f"phase {self.phase}{tag} K5 N={xyz.shape[1]} S={cent.shape[1]} K={k} "
              f"F0={pf.shape[-1]}: z1 identical {same}, {sums}", flush=True)
        _check(same, "K5 disagrees with its plain twin")
        return float((got[0].float() - ref[0].float()).abs().max()), ref

    def fwd_step(self, tag, z_prev, pack, w, b, last):
        fs = self.fs
        got, ref = (f(z_prev, pack, w, b, last)
                    for f in (fs.sa_fwd_step_cuda, fs.sa_fwd_step_plain))
        again = fs.sa_fwd_step_cuda(z_prev, pack, w, b, last)
        eq, err, top = _bf16_agree(got[0], ref[0])
        name = "K7" if last else "K6"
        sums = self._check_sums(name, ("sum", "sumsq"), got[1:3], ref[1:3],
                                again[1:3])
        line = (f"phase {self.phase}{tag} {name} K={z_prev.shape[2]} "
                f"F={z_prev.shape[-1]}->{w.shape[-1]}: z' bit-identical "
                f"{eq:.6f} max|diff| {err:.4g} (max {top:.4g}), {sums}")
        _check(eq >= 0.99 and err <= 0.01 * top,
               f"{name} disagrees with its plain twin")
        if last:
            own = (torch.equal(got[3], got[0].float().amax(dim=2))
                   and torch.equal(got[4], got[0].float().amin(dim=2)))
            eqx = min(float((got[i] == ref[i]).float().mean())
                      for i in (3, 4))
            line += f", extrema of its own z' {own}, same as the twin's {eqx:.6f}"
            _check(own and eqx >= 0.99, "K7's extrema disagree")
        print(line, flush=True)
        return err, ref

    _BWD = ("sdy", "sdyx", "dw", "db")

    @staticmethod
    def _over_own_dy(dy, z_j, pack_j, ref):
        """The twin's four backward sums `ref` with sum dy_j and sum dy_j
        xhat_j taken in f64 over `dy`, with xhat_j as the twin forms it."""
        dyf = dy.double()
        xhat = ((z_j.float() - pack_j[2]) * pack_j[3]).double()
        return (dyf.sum((0, 1, 2)).float(),
                (dyf * xhat).sum((0, 1, 2)).float(), *ref[2:4])

    def _twin_gap(self, own, twin, mags):
        """The twin's sum dy_j and sum dy_j xhat_j against `own`'s, per
        the sums of their terms' magnitudes."""
        return ("; the twin's over its own dy: " + " ".join(
            f"{n} {float(((a - b).abs() / (m + 1e-30)).max()):.2e}"
            for n, a, b, m in zip(self._BWD[:2], twin, own, mags)))

    def bwd_step(self, tag, train, top, z_j, z_j1, dy_src, pack_j, pack_j1,
                 w_j):
        fs = self.fs
        a = (train, top, z_j, z_j1, dy_src, pack_j, pack_j1, w_j)
        got, ref = fs.sa_bwd_step_cuda(*a), fs.sa_bwd_step_plain(*a)
        again = fs.sa_bwd_step_cuda(*a)
        eq, err, mx = _bf16_agree(got[0], ref[0])
        mags = fs.sa_bwd_sum_magnitudes(*a)
        own = self._over_own_dy(got[0], z_j, pack_j, ref[1:])
        sums = self._check_sums("K8", self._BWD, got[1:], own, again[1:],
                                mags)
        print(f"phase {self.phase}{tag} K8 train={train} top={top} K={z_j.shape[2]} "
              f"F={z_j.shape[-1]}<-{z_j1.shape[-1]}: dy bit-identical "
              f"{eq:.6f} max|diff| {err:.4g} (max {mx:.4g}), {sums}"
              + self._twin_gap(own, ref[1:], mags), flush=True)
        _check(eq >= 0.99 and err <= 0.01 * mx,
               "K8 disagrees with its plain twin")
        return err, ref

    def bwd_step0(self, tag, train, top, z_j, z_j1, dy_src, cent, xyz, qc,
                  pack_j, pack_j1, w_j, r):
        fs, grouping = self.fs, self.grouping
        a = (train, top, z_j, z_j1, dy_src, cent, xyz, qc, pack_j, pack_j1,
             w_j, r)
        got, ref = fs.sa_bwd_step0_cuda(*a), fs.sa_bwd_step0_plain(*a)
        again = fs.sa_bwd_step0_cuda(*a)
        a8 = (train, top, z_j, z_j1, dy_src, pack_j, pack_j1, w_j)
        dy0 = fs.sa_bwd_step_plain(*a8)[0]
        dy_own = fs.sa_bwd_step_cuda(*a8)[0]
        eq, dy_err, mx = _bf16_agree(dy_own, dy0)
        _check(eq >= 0.99 and dy_err <= 0.01 * mx,
               "K9's dy_0 (K8's kernel) disagrees with the plain twin's")
        mags = fs.sa_bwd_sum_magnitudes(*a8)
        own = self._over_own_dy(dy_own, z_j, pack_j, ref[:4])
        sums = self._check_sums("K9", self._BWD, got[:4], own, again[:4],
                                mags)
        sums += (f"; dy_0 bit-identical {eq:.6f} max|diff| {dy_err:.4g} "
                 f"(max {mx:.4g})" + self._twin_gap(own, ref[:4], mags))
        k, n = z_j.shape[2], xyz.shape[1]
        dz = fs._step_dz_plain(train, top, z_j1, dy_src, pack_j1)
        mag = torch.matmul(dz.float().abs(),
                           w_j.bfloat16().float().abs().t())
        idx, _ = fs._slots(cent, xyz, r, k)
        bound = (grouping.scatter_rows(idx, dy0.abs(), n, torch.float32)
                 / 128 + 1e-30
                 + 1e-5 * grouping.scatter_rows(idx, mag, n, torch.float32))
        err = float((got[4] - ref[4]).abs().max())
        excess = float(((got[4] - ref[4]).abs() / bound).max())
        cnt_same = torch.equal(got[6], ref[6])
        rels = [_rel(got[i], ref[i]) for i in (4, 5, 7, 8)]
        # H, Mq, cnt: the same bits on two launches, and equal to the
        # twin's order (`step0_scatter_plain`, on CPU copies, where
        # `index_add_` adds in its rows' order) over the kernel's own dy_0
        twice = all(torch.equal(got[i], again[i]) for i in (4, 5, 6))
        idx_c, count_c = fs._slots(cent.cpu(), xyz.cpu(), r, k)
        order = fs.step0_scatter_plain(idx_c, count_c, dy_own.cpu(),
                                       qc.cpu(), n)
        in_order = all(torch.equal(got[4 + i].cpu(), order[i])
                       for i in range(3))
        print(f"phase {self.phase}{tag} K9 train={train} top={top} K={k} "
              f"F={z_j.shape[-1]}<-{z_j1.shape[-1]}: cnt identical "
              f"{cnt_same}, H max|diff| {err:.4g} = {excess:.3f} of its "
              f"bound, rel H {rels[0]:.2e} Mq {rels[1]:.2e} Sdy "
              f"{rels[2]:.2e} Sz {rels[3]:.2e}; H, Mq, cnt twice the same "
              f"bits {twice}, equal to the twin's order over its own dy_0 "
              f"{in_order}; {sums}", flush=True)
        _check(cnt_same and excess <= 1.0 and rels[1] <= 1e-5
               and rels[2] <= 1e-2 and rels[3] <= 1e-5,
               "K9 disagrees with its plain twin")
        _check(twice, "K9's H, Mq or cnt differ between two launches")
        _check(in_order, "K9's H, Mq or cnt differ from the twin's order "
               "over its own dy_0")
        return err, ref


def _extract_probes(check, dev, seed):
    """K5 on seeded points beyond the main path's balls: K = 16 with F0 =
    16, F0 = 256 at K = 64 and 128, every ball one member (eff = 1) and
    every ball full (eff = K), N = 1 and N not a multiple of 32, F0 not a
    multiple of 8 with K = 24, F0 = 48, and pf and qc 2 bytes past a 16-byte
    boundary (one bf16 an access); every other centroid 100 m away in
    each (empty balls)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    for b, n, s, r, k, f0, off in (
            (4, 256, 64, 0.4, 16, 16, 0), (4, 256, 64, 0.4, 64, 256, 0),
            (2, 1024, 128, 0.8, 128, 256, 0),
            (4, 512, 128, 1e-4, 64, 64, 0), (4, 512, 128, 100.0, 128, 128, 0),
            (4, 1, 8, 0.4, 32, 64, 0), (4, 100, 40, 0.4, 64, 32, 0),
            (4, 200, 40, 0.5, 24, 20, 0), (4, 256, 64, 0.4, 32, 48, 0),
            (4, 1024, 128, 0.4, 64, 64, 1)):
        xyz = torch.randn(b, n, 3, generator=g, device=dev) * 0.5
        cent = xyz[:, torch.arange(s, device=dev) % n].clone()
        cent[:, ::2] += 100.0

        def bf16_rows(*shape):
            t = torch.empty(math.prod(shape) + off, device=dev,
                            dtype=torch.bfloat16)[off:]
            t.copy_(torch.randn(math.prod(shape), generator=g, device=dev))
            return t.view(shape)

        check.extract(f" probe{' (pf, qc unaligned)' if off else ''}",
                      cent, xyz, bf16_rows(b, n, f0), bf16_rows(b, s, f0),
                      r, k)


def _fwd_edge_probes(check, a6, a7):
    """K6 and K7 on 15 frustums and S - 3 centroids of one scale's
    captured arguments: an odd centroid count, so the last tile of a
    launch holds fewer centroids than the others wherever a tile holds 2
    or 4."""
    def cut(t):
        return t[:15, :t.shape[1] - 3].contiguous()

    check.fwd_step(" ragged probe", cut(a6[0]), *a6[1:])
    check.fwd_step(" ragged probe", cut(a7[0]), *a7[1:])


def _fwd_corner_probes(check, dev, seed):
    """K6 and K7 at the corners of their plan on seeded rows that repeat
    as a ball's slots do: the smallest tile (K = 16, 16 -> 16, 8
    centroids), 128 rows of 128 -> 128 and 128 -> 256 with a ragged last
    tile, and 256 -> 256 (W read through L2)."""
    fs = check.fs
    g = torch.Generator(device=dev).manual_seed(seed)
    for b, s, k, f_in, f_out in ((5, 313, 16, 16, 16),
                                 (3, 17, 128, 128, 128),
                                 (3, 17, 128, 128, 256),
                                 (3, 17, 128, 256, 256)):
        z = torch.randn(b, s, k, f_in, generator=g, device=dev)
        eff = torch.randint(1, k + 1, (b, s, 1), generator=g, device=dev)
        slot = (torch.arange(k, device=dev) % eff)[..., None]
        z = z.gather(2, slot.expand_as(z)).bfloat16()
        pack = fs._make_pack(
            torch.rand(f_in, generator=g, device=dev) + 0.5,
            torch.randn(f_in, generator=g, device=dev) * 0.2,
            torch.randn(f_in, generator=g, device=dev) * 0.2,
            torch.rand(f_in, generator=g, device=dev) + 0.5, 1e-3)
        w = torch.randn(f_in, f_out, generator=g, device=dev) * f_in ** -0.5
        bias = torch.randn(f_out, generator=g, device=dev) * 0.1
        for last in (False, True):
            check.fwd_step(" corner probe", z, pack, w, bias, last)


def _bwd_edge_probes(check, a8, a9, seed):
    """K8 and K9 on 15 frustums and S - 3 centroids of one scale's captured
    arguments: an odd centroid count, so the last tile of a launch holds
    fewer centroids than the others wherever a tile holds 2, 4 or 8. The
    step runs K8 at the top and K9 below a stored dy only, both in train
    mode: here also K8 below a stored dy, K9 at the top (a depth-2 chain)
    and the eval forms. (Not fewer rows: the four sums are held to 1e-4 of
    their terms' magnitudes, which over a few hundred rows is less than
    one dy_j that the two products round one bf16 step apart.)"""
    def cut(t):
        return t[:15, :t.shape[1] - 3].contiguous()

    g = torch.Generator(device=a8[2].device).manual_seed(seed)
    z1, z2 = cut(a8[2]), cut(a8[3])
    src = (cut(a8[4][0]), cut(a8[4][1]))
    z0, cent, xyz = cut(a9[2]), cut(a9[5]), a9[6][:15].contiguous()
    dy2 = (torch.randn(z2.shape, generator=g, device=z2.device)
           * 1e-2).bfloat16()
    qc1 = torch.randn(z1.shape[:2] + z1.shape[3:], generator=g,
                      device=z1.device).bfloat16()
    tag = " ragged probe"
    check.bwd_step(tag, True, True, z1, z2, src, *a8[5:])
    check.bwd_step(tag, False, True, z1, z2, src, *a8[5:])
    check.bwd_step(tag, True, False, z1, z2, dy2, *a8[5:])
    check.bwd_step(tag, False, False, z1, z2, dy2, *a8[5:])
    check.bwd_step0(tag, True, False, z0, z1, cut(a9[4]), cent, xyz,
                    cut(a9[7]), *a9[8:])
    check.bwd_step0(tag, False, False, z0, z1, cut(a9[4]), cent, xyz,
                    cut(a9[7]), *a9[8:])
    check.bwd_step0(tag, True, True, z1, z2, src, cent, xyz, qc1, *a8[5:],
                    a9[11])
    check.bwd_step0(tag, False, True, z1, z2, src, cent, xyz, qc1, *a8[5:],
                    a9[11])


def _bwd_smallest_tile_probe(check, dev, seed):
    """K8 and K9 at the smallest tile they take (K = 16, 16 <- 16 <- 16, 8
    centroids a tile) on a seeded chain of 5 x 313 centroids, each kernel
    on the twins' outputs of the ones before."""
    fs = check.fs
    g = torch.Generator(device=dev).manual_seed(seed)
    b, n, s, k, f, r = 5, 512, 313, 16, 16, 0.4

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=dev) * scale

    xyz = randn(b, n, 3, scale=0.5)
    cent = xyz[:, :s].clone()
    cent[:, ::7] += 100.0  # empty balls
    pf, qc = randn(b, n, f).bfloat16(), randn(b, s, f).bfloat16()
    ws = [randn(f, f, scale=0.3) for _ in range(2)]
    bs = [randn(f, scale=0.1) for _ in range(2)]
    m = b * s * k

    def pack(sums, sumsq, **kw):
        mu = sums / m
        return fs._make_pack(
            torch.rand(f, generator=g, device=dev) + 0.5, randn(f, scale=0.2),
            mu, sumsq / m - mu * mu, 1e-3, **kw)

    z0, s0, q0 = fs.sa_extract_plain(cent, xyz, pf, qc, r, k)
    p0 = pack(s0, q0)
    z1, s1, q1 = fs.sa_fwd_step_plain(z0, p0, ws[0], bs[0])
    p1 = pack(s1, q1)
    z2, s2, q2, zmax, zmin = fs.sa_fwd_step_plain(z1, p1, ws[1], bs[1], True)
    p2 = pack(s2, q2, mdy=randn(f, scale=1e-3), mdyx=randn(f, scale=1e-3))
    src = (fs._pool_epilogue(zmax, zmin, p2), randn(b, s, f).bfloat16())
    tag = " smallest-tile probe"
    for train in (True, False):
        _, (dy1, sdy, sdyx, *_) = check.bwd_step(tag, train, True, z1, z2,
                                                 src, p1, p2, ws[1])
        p1b = p1.clone()
        p1b[4], p1b[5] = sdy / m, sdyx / m
        check.bwd_step0(tag, train, False, z0, z1, dy1, cent, xyz, qc, p0,
                        p1b, ws[0], r)


def _full_batch_gradient(ctx, dev):
    """Phase 14 at the batch that is trained (B = 128, bench.py's
    `v2_train`), bf16, pinned as phase 10 pins its 8 frustums: one
    gradient from the card's fused step (K5-K9) against the card's unfused
    one (K3/K4) at the limits of `FUSED_COS`, beside two witnesses (each
    path against itself on the batch reversed) and five controls, which
    between them must fail every limit: the fused side's backward without
    the batch-statistic terms (the eval forms of K8 and K9), both sides
    unpinned, the fused side with another dropout mask, with its labels
    moved (`relabelled`) and with the T-Net's batch norms detached
    (`tnet_bn_detached`). The limits are `FULL_BATCH_COS`."""
    from transferable3d_torch.ops import fused_sa

    bf = torch.bfloat16
    full = SmallStep(ctx["cfg"], ctx["initial"], ctx["batch"], ctx["lr"],
                     ctx["bn"], ctx["seed"], dev, count=B)

    def unfused_step(*a, **kw):
        with fused_sa_env("0"):
            return full(*a, **kw)

    terms = {"fused": _BiasTerms(), "unfused": _BiasTerms()}
    with terms["fused"].on(full, fused_sa):
        fused = full(bf, dev, True)
    with terms["unfused"].on(full):
        unfused = unfused_step(bf, dev, True)
    _check(torch.equal(fused[2], unfused[2]) and bool(fused[2].all()),
           "B=128 bf16 masks differ or are not full")
    reversed_ = (full(bf, dev, True, full.perm),
                 unfused_step(bf, dev, True, full.perm))
    runs = {"card fused vs card unfused": compare(fused, unfused),
            "witness: card fused vs itself on the batch reversed":
                compare(fused, reversed_[0]),
            "witness: card unfused vs itself on the batch reversed":
                compare(unfused, reversed_[1])}
    orig_bwd = fused_sa.sa_bwd_step, fused_sa.sa_bwd_step0
    fused_sa.sa_bwd_step = lambda train, *a: orig_bwd[0](False, *a)
    fused_sa.sa_bwd_step0 = lambda train, *a: orig_bwd[1](False, *a)
    try:
        controls = {"control: fused backward without the batch-statistic "
                    "terms": compare(full(bf, dev, True), unfused)}
    finally:
        fused_sa.sa_bwd_step, fused_sa.sa_bwd_step0 = orig_bwd
    controls["control: both sides unpinned"] = compare(
        full(bf, dev), unfused_step(bf, dev))
    controls["control: fused with another dropout mask"] = compare(
        full(bf, dev, True, mask_keep=full.other_keep), unfused)
    controls["control: fused with its labels moved"] = compare(
        relabelled(full, bf, dev, True), unfused)
    controls["control: fused with the T-Net's batch norms detached"] = (
        compare(tnet_bn_detached(full, bf, dev, True), unfused))
    judge("phase 14 B=128", f"fused vs unfused on the card, bf16 ({B} "
          f"frustums, foreground margin {full.margin:.4g})",
          FULL_BATCH_COS, runs, controls)
    rounded = full.adapt
    full.adapt = _fused_rounding
    try:
        like_fused = unfused_step(bf, dev, True)
    finally:
        full.adapt = rounded
    _box_net_readings(fused, unfused, reversed_, terms, like_fused,
                      full(torch.float32, dev, True))


def _dense_one_rounding(dense, x):
    """A Dense as K6/K7 compute it: bf16 operands, f32 sums, the bias
    added in f32, one bf16 rounding (`Dense.forward` rounds the product,
    then adds the bias in bf16)."""
    w = dense.weight.to(dense.dtype).float()
    return (torch.matmul(x.to(dense.dtype).float(), w.t())
            + dense.bias).to(dense.dtype)


def _bn_pack_form(bn, x, momentum=0.9):
    """A train-mode batch norm as K6/K7 apply it: bf16(z a + c) with a and
    c from the batch statistics (`fused_sa._make_pack`), in place of
    `ScheduledBatchNorm`'s bf16((z - mean) inv + beta)."""
    from transferable3d_torch.ops import fused_sa

    xf = x.float()
    axes = tuple(range(x.dim() - 1))
    mean = xf.mean(dim=axes)
    var = (xf * xf).mean(dim=axes) - mean * mean
    with torch.no_grad():
        bn.mean.mul_(momentum).add_((1.0 - momentum) * mean)
        bn.var.mul_(momentum).add_((1.0 - momentum) * var)
    pack = fused_sa._make_pack(bn.scale, bn.bias, mean, var, bn.EPSILON)
    return (xf * pack[0] + pack[1]).to(bn.dtype or x.dtype)


def _fused_rounding(model):
    """`SmallStep.adapt` for a reading of C3: the box net's grouped chains
    on the unfused branch rounded where the fused kernels round
    (`_dense_one_rounding` for every Dense after the first,
    `_bn_pack_form` for every batch norm). In exact arithmetic the same
    function, so it shows how far the two paths' rounding sites alone move
    the gradient."""
    from transferable3d_torch.models import pointnet2

    for mod in model.box_net.modules():
        if isinstance(mod, pointnet2.GroupedPointMLP):
            for i in range(len(mod.features)):
                bn = getattr(mod, f"bn_{i}")
                bn.forward = functools.partial(_bn_pack_form, bn)
                if i:
                    dense = getattr(mod, f"dense_{i}")
                    dense.forward = functools.partial(_dense_one_rounding,
                                                      dense)


def _cancelling(leaf: str) -> bool:
    """A box-net leaf whose gradient is zero in exact arithmetic: the bias
    of a Dense whose output a train-mode batch norm normalises (every
    Dense of the box net but the head's f32 `out`)."""
    parts = leaf.split(".")
    return (parts[0] == "box_net" and parts[-1] == "bias"
            and parts[-2].startswith(("dense_", "fc_")))


class _BiasTerms:
    """The terms of every box-net Dense bias's gradient, summed over rows
    in f64 by channel, with the sum of their magnitudes: the cotangent of
    the Dense's output (a hook on each call), and on the fused branch, for
    the grouped chains' inner layers, which run in K6-K9, the dz that K8
    and K9 sum into db, recomputed by its plain form
    (`fused_sa._step_dz_plain`) from the kernels' own inputs and matched
    to its leaf by the db the kernel returned."""

    def __init__(self):
        self.sums, self.calls = {}, []

    @contextlib.contextmanager
    def on(self, step, fused_sa=None):
        from transferable3d_torch.models import layers

        def adapt(model):
            for name, mod in model.box_net.named_modules():
                if isinstance(mod, layers.Dense) and mod.bias is not None:
                    mod.register_forward_hook(functools.partial(
                        self._hook, f"box_net.{name}.bias"))

        saved = step.adapt
        step.adapt = adapt
        patched = []
        if fused_sa is not None:
            for fn_name, db_at in (("sa_bwd_step", 4), ("sa_bwd_step0", 3)):
                orig = getattr(fused_sa, fn_name)
                patched.append((fn_name, orig))
                setattr(fused_sa, fn_name,
                        functools.partial(self._record, orig, db_at))
        try:
            yield self
        finally:
            step.adapt = saved
            for fn_name, orig in patched:
                setattr(fused_sa, fn_name, orig)

    def _hook(self, leaf, mod, args, out):
        if out.requires_grad:
            out.register_hook(functools.partial(self._add, leaf))

    def _add(self, leaf, g):
        g = g.double().reshape(-1, g.shape[-1])
        s, a = self.sums.get(leaf, (0.0, 0.0))
        self.sums[leaf] = (s + g.sum(0), a + g.abs().sum(0))

    def _record(self, orig, db_at, train, top, z_j, z_j1, dy_src, *rest):
        out = orig(train, top, z_j, z_j1, dy_src, *rest)
        pack_j1 = rest[4] if db_at == 3 else rest[1]
        self.calls.append((out[db_at].detach().cpu().clone(),
                           (train, top, z_j1, dy_src, pack_j1)))
        return out

    def finish(self, grads):
        """Match the recorded K8/K9 calls to their leaves by db, and add
        their dz terms."""
        from transferable3d_torch.ops import fused_sa

        for db, args in self.calls:
            for leaf in filter(_cancelling, grads):
                if torch.equal(grads[leaf], db):
                    dz = fused_sa._step_dz_plain(*args).double()
                    dz = dz.reshape(-1, dz.shape[-1])
                    self.sums[leaf] = (dz.sum(0), dz.abs().sum(0))
        self.calls = []
        return self


def _box_net_readings(fused, unfused, reversed_, terms, like_fused, ref32):
    """C3, taken apart (readings only): where in the box net the fused
    and unfused gradients part; its cosines with the leaves that are zero
    in exact arithmetic (`_cancelling`) left out, on the gated run, the
    witnesses and the unfused step rounded where the fused kernels round
    (`_fused_rounding`); each such leaf's gradient beside the f64 sum of
    its terms and the sum of their magnitudes on both paths; and each bf16
    path against the card's float32 step (unfused) on the same pinned
    batch."""
    def shares(ga, gb):
        ks = [k for k in ga if k.startswith("box_net.")]
        na = math.sqrt(sum(float(ga[k].double().square().sum()) for k in ks))
        nb = math.sqrt(sum(float(gb[k].double().square().sum()) for k in ks))
        return sorted(((0.5 * float((ga[k].double() / na
                                     - gb[k].double() / nb).square().sum()),
                        k) for k in ks), reverse=True)

    def without(ga, gb):
        ks = [k for k in ga if k.startswith("box_net.") and not _cancelling(k)]
        return _cos(torch.cat([ga[k].ravel() for k in ks]),
                    torch.cat([gb[k].ravel() for k in ks]))

    pairs = {"fused vs unfused": (fused, unfused),
             "fused vs itself reversed": (fused, reversed_[0]),
             "unfused vs itself reversed": (unfused, reversed_[1]),
             "unfused vs unfused with the fused rounding": (unfused,
                                                            like_fused),
             "fused vs unfused with the fused rounding": (fused, like_fused)}
    for tag, (a, b) in pairs.items():
        top = shares(a[1], b[1])
        print(f"phase 14 B=128 C3 {tag}: box net 1 - cosine "
              f"{sum(v for v, _ in top):.6f}, without the cancelling biases "
              f"{1 - without(a[1], b[1]):.6f}; largest shares "
              + ", ".join(f"{k} {v:.6f}" for v, k in top[:5]), flush=True)
    grads = {"fused": fused[1], "unfused": unfused[1]}
    terms["fused"].finish(fused[1])
    box = {p: math.sqrt(sum(float(g[k].double().square().sum())
                            for k in g if k.startswith("box_net.")))
           for p, g in grads.items()}
    for leaf in sorted(filter(_cancelling, fused[1])):
        line = [f"phase 14 B=128 C3 leaf {leaf}: cosine "
                f"{_cos(fused[1][leaf], unfused[1][leaf]):.5f}"]
        for p in ("fused", "unfused"):
            g = float(grads[p][leaf].double().norm())
            s64, mag = terms[p].sums.get(leaf, (None, None))
            line.append(
                f"{p} |grad| {g:.4g} ({g / box[p]:.3g} of the box net's)" + (
                    "; terms not seen" if s64 is None else
                    f", |f64 sum of its terms| {float(s64.norm()):.4g}, "
                    f"|sum of |terms|| {float(mag.norm()):.4g}, |grad| / "
                    f"that {g / float(mag.norm()):.3g}"))
        print("; ".join(line), flush=True)
    for tag, run in (("fused", fused), ("unfused", unfused)):
        show(f"phase 14 B=128 C3 bf16 {tag} vs the card's float32 step",
             compare(run, ref32))


def train_fused(args, dev, card: str, ctx):
    """Phases 12-15: training with T3D_FUSED_SA unset (the default), the
    fused set-abstraction path through kernels K5-K9. Returns their JSON
    entries."""
    with fused_sa_env(None):
        return _train_fused(args, dev, card, ctx)


def _train_fused(args, dev, card: str, ctx):
    from transferable3d_torch.models import pointnet2, registry
    from transferable3d_torch.ops import _build, fused_sa
    from transferable3d_torch.train import train_loop

    cfg, batch, lr, bn = ctx["cfg"], ctx["batch"], ctx["lr"], ctx["bn"]

    def fresh():
        m = registry.get_model("frustum_pointnets_v2", cfg,
                               dtype=torch.bfloat16, device=dev)
        m.load_state_dict(ctx["initial"].state_dict())
        return m, train_loop.create_train_state(
            m, train_loop.make_optimizer(lr), seed=args.seed)

    # 12. one train step at the v2_train width, K5-K9 arguments captured
    model, state = fresh()
    step = train_loop.make_train_step(
        cfg, lr, bn, train_loop.StepConfig(compute_iou_metrics=True))
    wrappers = {"sa_extract": "sa_extract_cuda",
                "sa_fwd": "sa_fwd_step_cuda",
                "sa_bwd_step": "sa_bwd_step_cuda",
                "sa_bwd_step0": "sa_bwd_step0_cuda"}
    calls = {k: [] for k in wrappers}
    orig = {k: getattr(fused_sa, fn) for k, fn in wrappers.items()}

    def detached(x):
        if torch.is_tensor(x):
            return x.detach()
        return tuple(map(detached, x)) if isinstance(x, tuple) else x

    def recorder(key):
        def rec(*a):
            calls[key].append(detached(a))
            return orig[key](*a)
        return rec

    for key, fn in wrappers.items():
        setattr(fused_sa, fn, recorder(key))
    try:
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
    finally:
        for key, fn in wrappers.items():
            setattr(fused_sa, fn, orig[key])
    print(f"phase 12 fused train step: launches {launches}", flush=True)
    _expect_launches(launches, {"fps": 4, **{k: 8 for k, _, _ in
                                             FUSED_KERNELS}})
    _check(len(calls["sa_extract"]) == 8 and len(calls["sa_fwd"]) == 16
           and len(calls["sa_bwd_step"]) == 8
           and len(calls["sa_bwd_step0"]) == 8,
           "captured calls do not match the launches")
    vals = {k: float(v) for k, v in metrics.items()}
    print("  metrics: " + " ".join(f"{k} {v:.5g}" for k, v in vals.items()),
          flush=True)
    _check(all(math.isfinite(v) for v in vals.values()),
           "a loss term or metric is not finite")
    grads = _grads(model)
    bad = [k for k, g in grads.items() if not bool(torch.isfinite(g).all())]
    _check(not bad, f"non-finite gradients: {bad}")
    zero = [k for k, g in grads.items() if not bool((g != 0).any())]
    print(f"  gradients: {len(grads)} leaves finite; all-zero leaves "
          f"{zero}", flush=True)

    # 13. every kernel against its twin on the captured arguments, and the
    # chain again with every other centroid moved 100 m away (empty
    # balls), each kernel then on the twin's output of the one before.
    # The backward runs the scales in another order: pair by the z tensors.
    check = FusedChecks()
    errs = {k: 0.0 for k, _, _ in FUSED_KERNELS}
    k6 = [a for a in calls["sa_fwd"] if not a[4]]
    k7 = [a for a in calls["sa_fwd"] if a[4]]
    k8 = {a[2].data_ptr(): a for a in calls["sa_bwd_step"]}
    k9 = {a[2].data_ptr(): a for a in calls["sa_bwd_step0"]}
    for i, (a5, a6, a7) in enumerate(zip(calls["sa_extract"], k6, k7)):
        a8, a9 = k8[a7[0].data_ptr()], k9[a6[0].data_ptr()]
        share = _ball_shares(a5[0], a5[1], a5[4], a5[5])
        print(f"phase 13 scale {i}: S={a5[0].shape[1]} N={a5[1].shape[1]} "
              f"K={a5[5]} r={a5[4]}: "
              + " ".join(f"{nm} {v:.4f}" for nm, v in share.items()),
              flush=True)
        for key, err in (
                ("sa_extract", check.extract("", *a5)[0]),
                ("sa_fwd_step", check.fwd_step("", *a6)[0]),
                ("sa_fwd_last", check.fwd_step("", *a7)[0]),
                ("sa_bwd_step", check.bwd_step("", *a8)[0]),
                ("sa_bwd_step0", check.bwd_step0("", *a9)[0])):
            errs[key] = max(errs[key], err)
        far = a5[0].clone()
        far[:, ::2] += 100.0
        tag = " empty-ball probe"
        _, (z0, _, _) = check.extract(tag, far, *a5[1:])
        _, (z1, _, _) = check.fwd_step(tag, z0, *a6[1:])
        _, (z2, _, _, zmax, zmin) = check.fwd_step(tag, z1, *a7[1:])
        pooled = fused_sa._pool_epilogue(zmax, zmin, a8[6])
        _, (dy1, *_) = check.bwd_step(tag, a8[0], a8[1], z1, z2,
                                      (pooled, a8[4][1]), *a8[5:])
        check.bwd_step0(tag, a9[0], a9[1], z0, z1, dy1, far, *a9[6:])
        _fwd_edge_probes(check, a6, a7)
        _bwd_edge_probes(check, a8, a9, args.seed + i)
    _bwd_smallest_tile_probe(check, dev, args.seed)
    _fwd_corner_probes(check, dev, args.seed)
    _extract_probes(check, dev, args.seed)

    # The forward of one step twice from the same start: the BN running
    # statistics of every grouped MLP, which hold K5-K7's batch means and
    # variances, are the same bits. (The backward's dW and db are held
    # bit-identical per kernel above; across two whole steps their inputs
    # pass through PyTorch's own atomics.)
    stats = []
    for _ in range(2):
        m, st = fresh()
        step(st, batch)
        stats.append({f"{name}.{key}": buf.clone()
                      for name, mod in m.named_modules()
                      if isinstance(mod, pointnet2.GroupedPointMLP)
                      for key, buf in mod.named_buffers()})
    same = all(torch.equal(stats[0][k], stats[1][k]) for k in stats[0])
    print(f"phase 13 two steps from one start: {len(stats[0])} BN running "
          f"statistics of the grouped MLPs bit-identical {same}", flush=True)
    _check(same and len(stats[0]) == 48,
           "the fused step's batch statistics differ between two runs")

    # 14. the card against the CPU, fused on both (the plain twins on the
    # CPU), bf16, pinned as in phase 10; the witnesses; controls that must
    # fail the limits; and the card's fused step against its unfused one.
    one_step = ctx["one_step"]
    bf = torch.bfloat16
    on_card, on_cpu = one_step(bf, "cuda", True), one_step(bf, "cpu", True)
    _check(torch.equal(on_card[2], on_cpu[2]) and bool(on_card[2].all()),
           "bf16 masks differ or are not full")
    runs = {"card vs CPU": compare(on_card, on_cpu),
            "witness: card vs card on the batch reversed":
                compare(on_card, one_step(bf, "cuda", True, one_step.perm)),
            "witness: CPU vs CPU on the batch reversed":
                compare(on_cpu, one_step(bf, "cpu", True, one_step.perm))}
    # Controls: the CPU side's backward without the batch-statistic terms
    # (the eval forms of K8 and K9); both sides unpinned; the CPU side
    # with another dropout mask, with its labels moved and with the
    # T-Net's batch norms missing the batch-statistic terms of their
    # backward.
    orig_bwd = fused_sa.sa_bwd_step, fused_sa.sa_bwd_step0
    fused_sa.sa_bwd_step = lambda train, *a: orig_bwd[0](False, *a)
    fused_sa.sa_bwd_step0 = lambda train, *a: orig_bwd[1](False, *a)
    try:
        controls = {"control: CPU backward without the batch-statistic "
                    "terms": compare(on_card, one_step(bf, "cpu", True))}
    finally:
        fused_sa.sa_bwd_step, fused_sa.sa_bwd_step0 = orig_bwd
    controls["control: both sides unpinned"] = compare(
        one_step(bf, "cuda"), one_step(bf, "cpu"))
    controls["control: CPU with another dropout mask"] = compare(
        on_card, one_step(bf, "cpu", True, mask_keep=one_step.other_keep))
    controls["control: CPU with its labels moved"] = compare(
        on_card, relabelled(one_step, bf, "cpu", True))
    controls["control: CPU with the T-Net's batch norms detached"] = compare(
        on_card, tnet_bn_detached(one_step, bf, "cpu", True))
    judge("phase 14", f"fused, bf16 ({CHECK_B} frustums)", FUSED_COS, runs,
          controls)
    with fused_sa_env("0"):
        unfused = one_step(bf, "cuda", True)
    show("phase 14 reading: card fused vs card unfused",
         compare(on_card, unfused))
    _full_batch_gradient(ctx, dev)

    # 15. 30 steps on the fixed batch, then times
    losses = []
    for _ in range(30):
        state, met = step(state, batch)
        losses.append(float(met["total_loss"]))
    print(f"phase 15 30 fused steps: first {losses[0]:.5g}, mean of last 5 "
          f"{np.mean(losses[-5:]):.5g}, all finite "
          f"{all(map(math.isfinite, losses))}", flush=True)
    _check(all(map(math.isfinite, losses)), "a training loss is not finite")
    _check(np.mean(losses[-5:]) < losses[0], "the loss did not decrease")
    torch.cuda.reset_peak_memory_stats(dev)
    step_ms = _time_ms(lambda: step(state, batch), 2, 5)
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"times fused train step B={B}: {step_ms:.3f} ms, "
          f"{B * 1000.0 / step_ms:.1f} frustums/s, peak device memory "
          f"{peak / 2**30:.2f} GiB; unfused step in this run: "
          f"{ctx['unfused_ms']:.3f} ms, "
          f"{B * 1000.0 / ctx['unfused_ms']:.1f} frustums/s, "
          f"{ctx['unfused_peak'] / 2**30:.2f} GiB {card}", flush=True)

    # Per kernel and shape: time, the twin's time, and the bound (inputs
    # read once, outputs written once; the products' multiply-adds at the
    # bf16 tensor-core rate).
    def cost(key, a):
        if key == "sa_extract":
            cent, xyz, pf, qc, _, k = a
            rows = cent.shape[0] * cent.shape[1] * k
            return _nbytes(cent, xyz, pf, qc) + rows * pf.shape[-1] * 2, 0.0
        if key in ("sa_fwd_step", "sa_fwd_last"):
            z, pack, w, b, last = a
            rows = z.numel() // z.shape[-1]
            out = rows * w.shape[-1] * 2 + (
                2 * z.shape[0] * z.shape[1] * w.shape[-1] * 4 if last else 0)
            return _nbytes(z, pack, w, b) + out, 2.0 * rows * w.numel()
        z_j, z_j1, dy_src = a[2:5]
        w_j = a[-2] if key == "sa_bwd_step0" else a[-1]
        rows = z_j.numel() // z_j.shape[-1]
        by = _nbytes(z_j, z_j1, *a[5:]) + (
            _nbytes(*dy_src) if isinstance(dy_src, tuple)
            else _nbytes(dy_src))
        if key == "sa_bwd_step":
            by += z_j.numel() * 2
        else:  # H, Mq, cnt, Sdy, Sz
            b_, n, f = a[6].shape[0], a[6].shape[1], z_j.shape[-1]
            by += (b_ * n * (2 * f + 1) + 2 * z_j.shape[0] * z_j.shape[1]
                   * f) * 4
        return by, 4.0 * rows * w_j.numel()

    def scratch(key, a):
        """K9's member buffer and rank table: bytes of its design, not of
        the function, so printed beside the bound and not in it."""
        return (fused_sa.step0_scratch_bytes(a[5], a[6], a[11],
                                             a[2].shape[2], a[2].shape[-1])
                if key == "sa_bwd_step0" else 0)

    fs = fused_sa
    per_kernel = {
        "sa_extract": (fs.sa_extract_cuda, fs.sa_extract_plain,
                       calls["sa_extract"]),
        "sa_fwd_step": (fs.sa_fwd_step_cuda, fs.sa_fwd_step_plain, k6),
        "sa_fwd_last": (fs.sa_fwd_step_cuda, fs.sa_fwd_step_plain, k7),
        "sa_bwd_step": (fs.sa_bwd_step_cuda, fs.sa_bwd_step_plain,
                        calls["sa_bwd_step"]),
        "sa_bwd_step0": (fs.sa_bwd_step0_cuda, fs.sa_bwd_step0_plain,
                         calls["sa_bwd_step0"])}
    kernels = []
    for name, repl, src in FUSED_KERNELS:
        kern, plain, cl = per_kernel[name]
        tot_k = tot_p = nbytes = flops = extra = 0.0
        for a in cl:
            mk = _time_ms(lambda: kern(*a), 2, 10)
            mp = _time_ms(lambda: plain(*a), 1, 3)
            by, fl = cost(name, a)
            sb = scratch(name, a)
            tot_k += mk
            tot_p += mp
            nbytes += by
            flops += fl
            extra += sb
            z = a[0] if name.startswith("sa_fwd") else (
                a[2] if name.startswith("sa_bwd") else None)
            shape = (f"S={a[0].shape[1]} K={a[5]} F0={a[2].shape[-1]}"
                     if z is None else
                     f"S={z.shape[1]} K={z.shape[2]} F={z.shape[-1]}")
            print(f"times {name} {shape}: kernel {mk:.4f} ms, plain "
                  f"{mp:.4f} ms, bound "
                  f"{_bound(by, fl, PEAK_BF16)[0]:.4f} ms"
                  + (f" (member buffer and rank table {sb / 1e6:.2f} MB, "
                     f"bound with them "
                     f"{_bound(by + sb, fl, PEAK_BF16)[0]:.4f} ms)"
                     if sb else "") + f" {card}", flush=True)
        bound = _bound(nbytes, flops, PEAK_BF16)
        print(f"times {name} per step ({len(cl)} calls): kernel "
              f"{tot_k:.4f} ms, plain {tot_p:.4f} ms, bound {bound[0]:.4f} "
              f"ms by {bound[1]}"
              + (f"; member buffer and rank table {extra / 1e6:.2f} MB, "
                 f"bound with them "
                 f"{_bound(nbytes + extra, flops, PEAK_BF16)[0]:.4f} ms"
                 if extra else "") + f" {card}", flush=True)
        kernels.append(_entry(name, "transferable3d_torch/csrc/" + src, repl,
                              launches[name], errs[name], tot_k, tot_p,
                              bound))
    return kernels


# Phase 18's bf16 limits for F-PointNet v1 (card against CPU, mask
# pinned): set from the readings in PERF.md as `BF16_COS` is, each failed
# by one of the phase's controls.
V1_COS = {"all": 0.8, "seg_net": 0.998, "tnet": 0.7, "box_net": 0.9}
K15_SOURCE = "transferable3d_torch/csrc/fetch_select.cu"
K15_REPLACES = "transferable3d_tpu/data/frustum_jit.py:161"


def _want_np(u, count, npoints):
    """The slots' 1-based ranks in numpy float32, op for op
    (transferable3d_tpu/data/frustum_jit.py:121-125); written out here so
    that the host check shares no code with the port."""
    f32 = np.float32
    npf = f32(npoints)
    perm = np.random.RandomState(0x53A1).permutation(npoints).astype(f32)
    u = u.astype(f32)[..., None]
    c = count.astype(f32)[..., None]
    slot = perm + np.floor(u * npf)
    slot = np.where(slot >= npf, slot - npf, slot)
    want = f32(1.0) + np.floor((slot + u) * c / npf)
    return np.minimum(want, np.maximum(c, f32(1.0))).astype(np.int64)


def _e2e_gates(launches, batch, metrics, model, scene_np) -> None:
    """What an end-to-end step must show (phases 16 and 21): 1 K15 launch
    and none of K1-K9; every frustum non-empty and valid, on the card;
    every batch entry, loss term and gradient finite; the foreground share
    of `seg` strictly between 0 and 1; every sampled pixel in its 2D
    box."""
    _expect_launches(launches, {"fetch_select": 1})
    _check(all(v.device.type == "cuda" for v in batch.values()),
           "a batch tensor left the card")
    _check(tuple(batch["points"].shape) == (B, N, 3)
           and bool((batch["count"] > 0).all())
           and bool(batch["valid"].all()),
           "an e2e frustum is empty or invalid")
    _check(all(bool(torch.isfinite(v.float()).all())
               for v in batch.values()), "a batch entry is not finite")
    fg = float(batch["seg"].float().mean())
    vals = {k: float(v) for k, v in metrics.items()}
    print(f"  counts {int(batch['count'].min())}-"
          f"{int(batch['count'].max())}, foreground share {fg:.4f}; "
          + " ".join(f"{k} {v:.5g}" for k, v in vals.items()), flush=True)
    _check(0.0 < fg < 1.0, "seg labels are all one class")
    _check(all(math.isfinite(v) for v in vals.values()),
           "a loss term is not finite")
    grads = _grads(model)
    bad = [k for k, g in grads.items() if not bool(torch.isfinite(g).all())]
    _check(not bad, f"non-finite gradients: {bad}")
    print(f"  gradients: {len(grads)} leaves finite", flush=True)
    frames, mb = scene_np.boxes2d.shape[:2]
    v_pix, u_pix = np.divmod(batch["idx"].cpu().numpy().reshape(
        frames, mb, N), scene_np.depth.shape[-1])
    b2d = scene_np.boxes2d[:, :, None, :]
    _check(bool(((u_pix >= b2d[..., 0]) & (u_pix < b2d[..., 2])
                 & (v_pix >= b2d[..., 1]) & (v_pix < b2d[..., 3])).all()),
           "a sampled pixel lies outside its 2D box")


def e2e(args, dev, card: str, ctx):
    """Phases 16-20: the end-to-end depth -> frustum -> F-PointNet v1
    train step (kernel K15), and v1 on the synthetic frustums. Returns
    K15's JSON entry."""
    from transferable3d_torch.core import bins, geometry
    from transferable3d_torch.data import depth_pipeline, frustum_jit
    from transferable3d_torch.models import registry
    from transferable3d_torch.ops import _build
    from transferable3d_torch.train import schedules, train_loop
    from transferable3d_torch.train import test as test_lib

    # 16. one end-to-end step at bench.py's e2e_train shape
    cfg = bins.SUNRGBD
    frames, mb = B // 4, 4
    scene_np, _ = depth_pipeline.make_depth_scene(
        np.random.RandomState(args.seed), cfg, n_frames=frames,
        boxes_per_frame=mb, h=96, w=128)
    scene = depth_pipeline.scene_to_device(scene_np)  # no device: the card
    model = registry.get_model(
        "frustum_pointnets_v1", cfg, dtype=torch.bfloat16, in_channels=3,
        generator=torch.Generator().manual_seed(args.seed + 4))
    where = ({t.device for t in scene} | {p.device for p in
                                          model.parameters()}
             | {b.device for b in model.buffers()})
    _check(where == {torch.device("cuda", torch.cuda.current_device())},
           f"scene or model built without `device` not on the card: {where}")
    initial = copy.deepcopy(model)
    lr = schedules.exponential_staircase_lr(batch_size=B)
    bn = schedules.bn_momentum_schedule(batch_size=B)
    step_cfg = train_loop.StepConfig(compute_iou_metrics=False,
                                     use_valid_weights=True)
    state = train_loop.create_train_state(
        model, train_loop.make_optimizer(lr), seed=args.seed)
    step = train_loop.make_train_step(cfg, lr, bn, step_cfg)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 5)

    calls = []
    orig_fetch = frustum_jit.fetch_select_cuda

    def rec_fetch(*a):
        calls.append(a)
        return orig_fetch(*a)

    def captured(fn):
        """The arguments of the one K15 launch that `fn` makes."""
        del calls[:]
        frustum_jit.fetch_select_cuda = rec_fetch
        try:
            out = fn()
        finally:
            frustum_jit.fetch_select_cuda = orig_fetch
        _check(len(calls) == 1, f"{len(calls)} K15 launches, expected 1")
        return calls[0], out

    torch.cuda.synchronize()
    _build.reset_launch_counts()
    def first_step():
        bt = depth_pipeline.scene_to_train_batch(scene, gen, N, cfg)
        return bt, step(state, bt)[1]

    main_args, (batch, metrics) = captured(first_step)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    print(f"phase 16 e2e step (F={frames} frames x MB={mb} boxes, 96x128 "
          f"depth, {N} points, v1 bf16 C=3): launches {launches}",
          flush=True)
    _e2e_gates(launches, batch, metrics, model, scene_np)

    # 17. K15 vs its plain twin (a gather: exact) on the captured
    # arguments and on probes, with a host check in numpy
    def k15_cost(pts, inside, u, npoints):
        """Bytes: the mask, the phases and the slot order read once, the
        outputs written once, and of `pts` only the rows that this run's
        frustums take (min(count, npoints) distinct rows each)."""
        f, m = inside.shape[:2]
        c = pts.shape[-1]
        out = f * m * (npoints * (c + 1) + 1) * 4
        rows = int(inside.sum(-1).clamp(max=npoints).sum())
        return (_nbytes(inside, u) + npoints * 4 + rows * c * 4 + out,
                float(inside.numel() + 20 * f * m * npoints))

    times = []

    def k15_check(tag, a, time_it=True, phase="phase 17"):
        pts, inside, u, npoints = a
        got = frustum_jit.fetch_select_cuda(*a)
        ref = frustum_jit.fetch_select_plain(*a)
        torch.cuda.synchronize()
        same = all(torch.equal(g, r) for g, r in zip(got, ref))
        err = float((got[0] - ref[0]).abs().max())
        # Host check: slot s holds point flatnonzero(inside)[want_s - 1].
        idx, cnt = got[1].cpu().numpy(), got[2].cpu().numpy()
        ins = inside.cpu().numpy()
        want = _want_np(u.cpu().numpy(), cnt, npoints)
        host = True
        for fi, bi in np.ndindex(*cnt.shape):
            nz = np.flatnonzero(ins[fi, bi])
            exp = nz[want[fi, bi] - 1] if len(nz) else np.full(npoints, -1)
            host &= bool(np.array_equal(idx[fi, bi], exp))
            host &= len(nz) == cnt[fi, bi]
        gathered = torch.equal(
            got[0], torch.where((got[1] < 0)[..., None], 0.0, pts[
                torch.arange(pts.shape[0], device=dev)[:, None, None],
                got[1].clamp(min=0).long()]))
        line = (f"{phase} {tag}: pts {list(pts.shape)} inside "
                f"{list(inside.shape)} npoints {npoints}, counts "
                f"{int(cnt.min())}-{int(cnt.max())}: sampled, idx, count "
                f"identical to the twin {same} (max |diff| of sampled "
                f"{err:.3g}), idx == host numpy {host}, "
                f"sampled == pts[idx] {gathered}")
        if time_it:
            mk = _time_ms(lambda: frustum_jit.fetch_select_cuda(*a), 3, 20)
            mp = _time_ms(lambda: frustum_jit.fetch_select_plain(*a), 2, 5)
            bound = _bound(*k15_cost(*a), PEAK_F32)
            times.append((mk, mp, bound, err))
            line += (f"; kernel {mk:.4f} ms, plain {mp:.4f} ms, bound "
                     f"{bound[0]:.4f} ms by {bound[1]} {card}")
        print(line, flush=True)
        _check(same and host and gathered,
               f"K15 disagrees with its plain twin ({tag})")
        return got

    k15_check("e2e step", main_args)
    main_ms, main_plain, main_bound, main_err = times[0]
    # A zero-area box and a box with fewer points than slots.
    pts, inside, u, _ = main_args
    probe = inside.clone()
    probe[0, 0] = False
    few = torch.nonzero(probe[0, 1])[:, 0][37:]
    probe[0, 1, few] = False
    got = k15_check("empty and short frustums", (pts, probe, u, N), False)
    _check(bool((got[1][0, 0] == -1).all()) and bool((got[0][0, 0] == 0)
                                                     .all())
           and int(got[2][0, 0]) == 0, "an empty frustum is not zeros")
    _check(int(got[2][0, 1]) == 37 and torch.equal(
        torch.unique(got[1][0, 1]).long(), torch.nonzero(probe[0, 1])[:, 0]),
        "a short frustum does not wrap over all of its points")
    rng = np.random.RandomState(args.seed + 6)
    k_big = np.array([[520.0, 0, 320.0], [0, 520.0, 240.0], [0, 0, 1]],
                     np.float32)
    depth = rng.uniform(0.5, 8.0, (4, 480, 640)).astype(np.float32)
    depth[rng.rand(4, 480, 640) < 0.1] = 0.0
    x0, y0 = rng.uniform(0, 400, (4, 4)), rng.uniform(0, 300, (4, 4))
    boxes = np.stack([x0, y0, x0 + rng.uniform(20, 239.5, (4, 4)),
                      y0 + rng.uniform(20, 179.5, (4, 4))],
                     -1).astype(np.float32)
    for npts in (1024, 2048):
        a, _ = captured(lambda: frustum_jit.lift_depth_frustums(
            depth, k_big, boxes, npts, gen))
        k15_check(f"480x640 depth, npoints {npts}", a)
    cloud = rng.uniform(-20, 20, (20000, 4)).astype(np.float32)
    cloud[:, 2] = np.abs(cloud[:, 2]) + 1.0
    a, out = captured(lambda: frustum_jit.crop_point_frustums(
        cloud, k_big, boxes[0], N, gen))
    k15_check("20,000-point cloud, C=4", a)
    _check(tuple(out.points.shape) == (4, N, 4), "cloud crop shape")
    a, _ = captured(lambda: frustum_jit.lift_depth_frustums(
        scene.depth, scene.K, scene.boxes2d, 1000, gen))
    k15_check("e2e scene, npoints 1000", a)
    # Kinect v2's 530x730 (a ragged last word of the mask, 4-byte loads).
    k_v2 = np.array([[600.0, 0, 365.0], [0, 600.0, 265.0], [0, 0, 1]],
                    np.float32)
    depth = rng.uniform(0.5, 8.0, (4, 530, 730)).astype(np.float32)
    depth[rng.rand(4, 530, 730) < 0.1] = 0.0
    x0, y0 = rng.uniform(0, 490, (4, 4)), rng.uniform(0, 350, (4, 4))
    boxes = np.stack([x0, y0, x0 + rng.uniform(20, 239.5, (4, 4)),
                      y0 + rng.uniform(20, 179.5, (4, 4))],
                     -1).astype(np.float32)
    a, _ = captured(lambda: frustum_jit.lift_depth_frustums(
        depth, k_v2, boxes, N, gen))
    k15_check("530x730 depth, npoints 1024", a)

    # 18. card vs CPU: the preprocessing from one scene and one set of
    # phases, then one v1 step on 8 frustums of the card's batch
    phases = torch.rand(frames, mb,
                        generator=torch.Generator().manual_seed(args.seed))
    on_card = depth_pipeline.scene_to_train_batch(scene, phases, N, cfg)
    on_cpu = depth_pipeline.scene_to_train_batch(scene_np, phases, N, cfg,
                                                 device="cpu")
    host = {k: v.cpu() for k, v in on_card.items()}
    exact = [k for k in ("idx", "count", "valid", "heading_class",
                         "size_class", "class_idx", "one_hot")
             if not torch.equal(host[k], on_cpu[k])]
    diffs = {k: float((host[k] - on_cpu[k]).abs().max())
             for k in ("points", "center", "frustum_angle",
                       "heading_residual", "size_residual")}
    rel = geometry.rotate_points_y(
        on_cpu["points"] - on_cpu["center"][:, None],
        -(torch.as_tensor(scene_np.heading).reshape(-1)
          + on_cpu["frustum_angle"]))
    half = torch.as_tensor(scene_np.size).reshape(-1, 1, 3)[..., [0, 2, 1]] / 2
    near = ((rel.abs() - half).abs() < 1e-4).any(-1)
    seg_off = host["seg"] != on_cpu["seg"]
    print(f"phase 18 scene_to_train_batch card vs CPU: integer entries that "
          f"differ {exact or 'none'}; max |diff| "
          + ", ".join(f"{k} {v:.3g}" for k, v in diffs.items())
          + f"; seg differs at {int(seg_off.sum())} of {seg_off.numel()} "
          f"points, {int((seg_off & ~near).sum())} of them farther than "
          f"1e-4 m from a box face ({int(near.sum())} points are that "
          f"near)", flush=True)
    _check(not exact, f"card and CPU batches differ in {exact}")
    # A few ulps of a coordinate of up to 8 m (sin, cos, atan2 and the
    # rotation's fused multiply-adds differ in the last place).
    _check(diffs["points"] <= 4e-6 and diffs["center"] <= 4e-6
           and diffs["frustum_angle"] <= 1e-6
           and diffs["heading_residual"] <= 2e-6
           and diffs["size_residual"] == 0.0,
           f"card and CPU batches differ: {diffs}")
    _check(not bool((seg_off & ~near).any()),
           "seg labels differ away from the box faces")

    small = {k: v.cpu().numpy() for k, v in on_card.items()}
    one_step = SmallStep(cfg, initial, small, lr, bn, args.seed, dev,
                         name="frustum_pointnets_v1",
                         model_kw={"in_channels": 3}, step_cfg=step_cfg)
    a, b = (one_step(torch.float32, w) for w in ("cuda", "cpu"))
    _check(torch.equal(a[2], b[2]), "float32 masks differ")
    res = compare(a, b)
    show(f"phase 18 v1 step card vs CPU, float32 ({CHECK_B} frustums)", res)
    _check(res[0] <= 0.02 and res[1]["all"] >= 0.99,
           "the card's float32 v1 train step disagrees with the CPU's")
    bf = torch.bfloat16
    a, b = one_step(bf, "cuda", True), one_step(bf, "cpu", True)
    _check(torch.equal(a[2], b[2]) and bool(a[2].all()),
           "bf16 masks differ or are not full")
    runs = {"card vs CPU": compare(a, b),
            "witness: card vs card on the batch reversed":
                compare(a, one_step(bf, "cuda", True, one_step.perm)),
            "witness: CPU vs CPU on the batch reversed":
                compare(b, one_step(bf, "cpu", True, one_step.perm))}
    # Controls: both sides with the mask free to differ; the CPU side
    # with another dropout mask; the CPU side with every frustum given
    # its neighbour's box labels.
    controls = {
        "control: both sides unpinned": compare(one_step(bf, "cuda"),
                                                one_step(bf, "cpu")),
        "control: CPU with another dropout mask": compare(
            a, one_step(bf, "cpu", True, mask_keep=one_step.other_keep))}
    labels = ("center", "heading_class", "heading_residual", "size_class",
              "size_residual")
    kept = {k: one_step.small[k] for k in labels}
    one_step.small.update({k: np.roll(v, 1, axis=0)
                           for k, v in kept.items()})
    try:
        controls["control: CPU with its neighbour's box labels"] = compare(
            a, one_step(bf, "cpu", True))
    finally:
        one_step.small.update(kept)
    judge("phase 18", f"v1 bf16 ({CHECK_B} frustums, foreground margin "
          f"{one_step.margin:.4g})", V1_COS, runs, controls)

    # 19. 30 end-to-end steps, each on a fresh draw of the frustums
    def e2e_step():
        return step(state, depth_pipeline.scene_to_train_batch(
            scene, gen, N, cfg))[1]

    losses = [float(e2e_step()["total_loss"]) for _ in range(30)]
    print(f"phase 19 30 e2e steps: first {losses[0]:.5g}, mean of last 5 "
          f"{np.mean(losses[-5:]):.5g}, all finite "
          f"{all(map(math.isfinite, losses))}", flush=True)
    _check(all(map(math.isfinite, losses)), "an e2e loss is not finite")
    _check(np.mean(losses[-5:]) < losses[0], "the e2e loss did not decrease")
    torch.cuda.reset_peak_memory_stats(dev)
    e2e_ms = _time_ms(e2e_step, 2, 10)
    peak = torch.cuda.max_memory_allocated(dev)
    prep_ms = _time_ms(lambda: depth_pipeline.scene_to_train_batch(
        scene, gen, N, cfg), 2, 10)
    print(f"times e2e step B={B}: {e2e_ms:.3f} ms, "
          f"{B * 1000.0 / e2e_ms:.1f} frustums/s, peak device memory "
          f"{peak / 2**30:.2f} GiB; scene_to_train_batch alone "
          f"{prep_ms:.3f} ms = {100 * prep_ms / e2e_ms:.1f}% of the step "
          f"{card}", flush=True)

    # 20. v1 on the synthetic frustums (C=4): serving and one train step
    # with the IoU metrics; v1 reaches no kernel
    v1 = registry.get_model(
        "frustum_pointnets_v1", cfg, dtype=torch.bfloat16,
        generator=torch.Generator().manual_seed(args.seed + 7))
    data = SyntheticFrustums(4 * B, cfg, args.seed)
    small_batch = data.get_batch(list(range(B)))
    predict = train_loop.make_predict_step(v1, cfg)
    v1_state = train_loop.create_train_state(
        v1, train_loop.make_optimizer(lr), seed=args.seed)
    v1_step = train_loop.make_train_step(cfg, lr, bn)
    _build.reset_launch_counts()
    v1_state, met = v1_step(v1_state, ctx["batch"])
    with torch.no_grad():
        out = predict(small_batch)
        dets = test_lib.run_inference(v1, data, cfg, batch_size=B)
    torch.cuda.synchronize()
    _expect_launches(dict(_build.LAUNCHES), {})
    vals = {k: float(v) for k, v in met.items()}
    ok = all(np.isfinite(d.center).all() and np.isfinite(d.size).all()
             and math.isfinite(d.score) and math.isfinite(d.heading)
             for d in dets)
    print(f"phase 20 v1 C=4: train step metrics "
          + " ".join(f"{k} {v:.5g}" for k, v in vals.items())
          + f"; predict step finite "
          f"{all(bool(torch.isfinite(v.float()).all()) for v in out.values())}"
          f"; run_inference {len(dets)} detections finite {ok}", flush=True)
    _check(all(math.isfinite(v) for v in vals.values())
           and "iou3d_mean" in vals, "a v1 loss term or metric is not finite")
    _check(all(bool(torch.isfinite(v.float()).all()) for v in out.values())
           and len(dets) == 4 * B and ok, "v1 serving output not finite")
    torch.cuda.reset_peak_memory_stats(dev)
    train_ms = _time_ms(lambda: v1_step(v1_state, ctx["batch"]), 2, 10)
    v1_peak = torch.cuda.max_memory_allocated(dev)
    with torch.no_grad():
        pred_ms = _time_ms(lambda: predict(small_batch), 2, 10)
    print(f"times v1 B={B} C=4: train step {train_ms:.3f} ms, "
          f"{B * 1000.0 / train_ms:.1f} frustums/s, peak device memory "
          f"{v1_peak / 2**30:.2f} GiB; predict step {pred_ms:.3f} ms, "
          f"{B * 1000.0 / pred_ms:.1f} frustums/s {card}", flush=True)

    # 21. the e2e step at SUN RGB-D's depth resolution, 480x640
    t0 = time.perf_counter()
    full_np, _ = depth_pipeline.make_depth_scene(
        np.random.RandomState(args.seed + 8), cfg, n_frames=frames,
        boxes_per_frame=mb, h=480, w=640)
    full = depth_pipeline.scene_to_device(full_np)
    scene_s = time.perf_counter() - t0
    full_model = registry.get_model(
        "frustum_pointnets_v1", cfg, dtype=torch.bfloat16, in_channels=3,
        generator=torch.Generator().manual_seed(args.seed + 9))
    full_state = train_loop.create_train_state(
        full_model, train_loop.make_optimizer(lr), seed=args.seed)

    def full_step():
        bt = depth_pipeline.scene_to_train_batch(full, gen, N, cfg)
        return bt, step(full_state, bt)[1]

    torch.cuda.synchronize()
    _build.reset_launch_counts()
    full_args, (batch, metrics) = captured(full_step)
    torch.cuda.synchronize()
    full_launches = dict(_build.LAUNCHES)
    plan = frustum_jit.fetch_select_plan(full_args[0].shape[1], B)
    print(f"phase 21 e2e step at 480x640 (F={frames} frames x MB={mb} "
          f"boxes, {N} points, v1 bf16 C=3; scene made in {scene_s:.2f} s): "
          f"launches {full_launches}; K15 plan {plan}", flush=True)
    _e2e_gates(full_launches, batch, metrics, full_model, full_np)
    k15_check("480x640 e2e step", full_args, phase="phase 21")
    full_ms = _time_ms(full_step, 1, 5)
    full_prep = _time_ms(lambda: depth_pipeline.scene_to_train_batch(
        full, gen, N, cfg), 1, 5)
    print(f"times e2e step at 480x640 B={B}: {full_ms:.3f} ms, "
          f"{B * 1000.0 / full_ms:.1f} frustums/s; scene_to_train_batch "
          f"alone {full_prep:.3f} ms = {100 * full_prep / full_ms:.1f}% of "
          f"the step; K15 {times[-1][0]:.4f} ms (bound {times[-1][2][0]:.4f}"
          f" ms, plain {times[-1][1]:.4f} ms); phase 21 took "
          f"{time.perf_counter() - t0:.1f} s {card}", flush=True)

    return [_entry("fetch_select", K15_SOURCE, K15_REPLACES,
                   launches["fetch_select"], main_err, main_ms, main_plain,
                   main_bound)]


# Phases 22-23: the driver and the evaluation at config 2's widths on v2
# bf16 (the README's v2 showcase), through the functions a user runs.
DRIVER_STEPS, DRIVER_RESUME, DRIVER_HOST = 48, 56, 8


def _clone_state(state, tx, dev):
    """An in-memory copy of a train state (no file): the model, Adam's
    state, the accumulation counters and the dropout generator."""
    from transferable3d_torch.train import train_loop

    model = copy.deepcopy(state.model)
    opt = tx(model.parameters())
    opt.adam.load_state_dict(copy.deepcopy(state.optimizer.adam.state_dict()))
    opt.count, opt.mini_step = state.optimizer.count, state.optimizer.mini_step
    opt.acc = (None if state.optimizer.acc is None
               else [a.clone() for a in state.optimizer.acc])
    gen = torch.Generator(device=dev)
    gen.set_state(state.generator.get_state())
    return train_loop.TrainState(state.step, model, opt, gen)


def _after_step(state, metrics):
    """Loss, gradients and updated parameters (with the BN statistics)
    after one step, for bitwise comparison."""
    return {"loss": [metrics["total_loss"].float().reshape(1)],
            "grads": [p.grad.detach().clone() for p in
                      state.model.parameters() if p.grad is not None],
            "params": [v.detach().clone() for v in
                       state.model.state_dict().values()]}


def _gaps(a, b):
    """Per quantity, the largest absolute difference (0.0: bit-identical;
    NaN positions must match)."""
    out = {}
    for k in a:
        same = all(torch.equal(x, y) for x, y in zip(a[k], b[k]))
        out[k] = 0.0 if same else max(
            float((x.float() - y.float()).abs().max())
            for x, y in zip(a[k], b[k]))
    return out


def _csv_rows(path):
    import csv

    with open(path) as f:
        return [{k: float(v) for k, v in row.items()}
                for row in csv.DictReader(f)]


def _driver_launches(launches, steps, evals, what):
    """The kernels of `steps` fused v2 train steps and `evals` eval steps:
    K1 4 a step, K5-K9 8 a train step, K2 8 an eval step; a scale that
    `fused_route` sends to the unfused branch trains through K3/K4 and is
    printed, never silent."""
    rerouted = launches["fused_sa_rerouted"]
    per_step = launches["extract_fwd"] // max(steps, 1)
    if rerouted or launches["extract_fwd"]:
        print(f"{what}: fused_sa_rerouted {rerouted}, K3/K4 "
              f"{launches['extract_fwd']}/{launches['extract_bwd']} "
              f"({per_step} scales a step)", flush=True)
        _check(rerouted > 0 and launches["extract_fwd"] == per_step * steps,
               f"{what}: K3/K4 launched without a counted reroute, or not "
               f"a whole number of scales a step: {launches}")
    want = {"fps": 4 * (steps + evals), "sa_infer": 8 * evals}
    want.update({k: (8 - per_step) * steps for k, _, _ in FUSED_KERNELS})
    if per_step:
        want.update({"extract_fwd": per_step * steps,
                     "extract_bwd": per_step * steps,
                     "fused_sa_rerouted": rerouted})
    _expect_launches(launches, want)


def driver_cfg(seed: int, log_dir: str):
    """Phase 22's configuration: config 2's widths on v2 bf16."""
    from transferable3d_torch.train import config as config_lib

    return dataclasses.replace(
        config_lib.PRESETS["config2_fpointnet_v1_sunrgbd"],
        model="frustum_pointnets_v2", compute_dtype="bfloat16",
        synthetic_train=512, synthetic_val=128, device_data=True,
        max_steps=DRIVER_STEPS, eval_every_epochs=1, ckpt_every_epochs=1,
        log_dir=log_dir, seed=seed)


def driver(args, dev, card: str):
    """Phases 22-23: `train_sup.train` and `test.evaluate` on the card."""
    with fused_sa_env(None):
        _driver(args, dev, card)


def _driver(args, dev, card: str):
    import tempfile

    from transferable3d_torch.data import device_dataset
    from transferable3d_torch.eval import ap as ap_lib
    from transferable3d_torch.ops import _build
    from transferable3d_torch.train import schedules, train_loop, train_sup
    from transferable3d_torch.train import test as test_lib
    from transferable3d_torch.utils.checkpoint import CheckpointManager

    tmp = tempfile.TemporaryDirectory(prefix="t3d_driver_")
    cfg = driver_cfg(args.seed, os.path.join(tmp.name, "log"))
    _check((cfg.num_point, cfg.num_channels, cfg.batch_size)
           == (1024, 6, 32), f"config 2's widths changed: {cfg}")
    epoch_steps = cfg.synthetic_train // cfg.batch_size
    val_batches = cfg.synthetic_val // cfg.batch_size

    def run(c, steps, evals, what):
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        out = train_sup.train(c)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
        print(f"{what}: {wall:.2f} s, launches {launches}", flush=True)
        _driver_launches(launches, steps, evals, what)
        _check(out and all(math.isfinite(v) for v in out.values()),
               f"{what}: val metrics not finite: {out}")
        return wall

    # 22. train 48 steps (3 epochs of 16, an eval pass of 4 batches and a
    # checkpoint after each), resume to 56, then the host provider path.
    t_run = run(cfg, DRIVER_STEPS, 3 * val_batches, "phase 22 train")
    log = os.path.join(cfg.log_dir, "log_train.txt")
    rates = [float(r) for r in re.findall(r"\(([0-9.]+) frustums/s\)",
                                          open(log).read())]
    train_rows = _csv_rows(os.path.join(cfg.log_dir, "metrics_train.csv"))
    val_rows = _csv_rows(os.path.join(cfg.log_dir, "metrics_val.csv"))
    ckpt = CheckpointManager(os.path.join(cfg.log_dir, "ckpt"))
    steps_logged = [int(r["step"]) for r in val_rows]
    print(f"phase 22 train: latest checkpoint {ckpt.latest_step()}, "
          f"checkpoints {ckpt.steps()}; val logged at steps {steps_logged}; "
          f"last train row "
          + " ".join(f"{k} {v:.5g}" for k, v in train_rows[-1].items())
          + "; last val row "
          + " ".join(f"{k} {v:.5g}" for k, v in val_rows[-1].items()),
          flush=True)
    _check(all(math.isfinite(v) for r in train_rows + val_rows
               for v in r.values()), "phase 22: a logged metric is not finite")
    _check(steps_logged == [epoch_steps, 2 * epoch_steps, DRIVER_STEPS],
           f"phase 22: val metrics not logged each epoch: {steps_logged}")
    _check(ckpt.latest_step() == DRIVER_STEPS,
           f"phase 22: latest checkpoint {ckpt.latest_step()}")

    resumed = dataclasses.replace(cfg, max_steps=DRIVER_RESUME)
    run(resumed, DRIVER_RESUME - DRIVER_STEPS, val_batches,
        "phase 22 resume")
    text = open(log).read()
    _check(f"resumed from step {DRIVER_STEPS}" in text
           and ckpt.latest_step() == DRIVER_RESUME,
           f"phase 22: no resume from {DRIVER_STEPS} to {DRIVER_RESUME} "
           f"(latest {ckpt.latest_step()})")
    host = dataclasses.replace(cfg, device_data=False, max_steps=DRIVER_HOST,
                               log_dir=os.path.join(tmp.name, "host"))
    run(host, DRIVER_HOST, val_batches, "phase 22 host provider")
    host_rows = _csv_rows(os.path.join(host.log_dir, "metrics_train.csv"))
    _check(all(math.isfinite(v) for r in host_rows for v in r.values())
           and host_rows[-1]["step"] == DRIVER_HOST,
           f"phase 22: host provider path: {host_rows}")

    # The checkpoint round trip: phase 22's state saved and restored into
    # a fresh template, one step on one batch, against steps from
    # in-memory copies of the state that never saved.
    train_ds, _ = train_sup.build_datasets(resumed)
    lr = schedules.exponential_staircase_lr(
        cfg.learning_rate, cfg.lr_decay_rate, cfg.lr_decay_samples,
        cfg.batch_size, cfg.min_lr)
    bn = schedules.bn_momentum_schedule(
        cfg.bn_init_decay, cfg.bn_decay_rate, cfg.bn_decay_samples,
        cfg.batch_size, cfg.bn_decay_clip)
    tx = train_loop.make_optimizer(lr)
    step = train_loop.make_train_step(cfg.bin_config(), lr, bn)

    def template():
        return train_loop.create_train_state(
            train_sup.build_model(resumed, cfg.num_channels, dev), tx,
            seed=args.seed + 1)

    data = device_dataset.build_device_dataset(
        train_ds.records, cfg.bin_config(), cfg.max_points_device)
    batch = next(device_dataset.DeviceEpochIterator(
        data, cfg.bin_config(), cfg.batch_size, cfg.num_point,
        seed=args.seed).epoch())
    state = template()
    ckpt.restore_latest(state)
    witnesses = []
    for _ in range(3):
        w = _clone_state(state, tx, dev)
        witnesses.append(_after_step(*step(w, batch)))
    trip = CheckpointManager(os.path.join(tmp.name, "trip"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trip.save(state.step, state)
    save_ms = (time.perf_counter() - t0) * 1e3
    fresh = template()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trip.restore_latest(fresh)
    torch.cuda.synchronize()
    restore_ms = (time.perf_counter() - t0) * 1e3
    _check(fresh.step == state.step == DRIVER_RESUME,
           f"round trip restored step {fresh.step}")
    restored = _after_step(*step(fresh, batch))
    own = [_gaps(witnesses[i], witnesses[j])
           for i, j in ((0, 1), (0, 2), (1, 2))]
    limit = {k: max(g[k] for g in own) for k in own[0]}
    got = _gaps(restored, witnesses[0])
    print(f"phase 22 checkpoint round trip at step {DRIVER_RESUME}: "
          f"restored vs unsaved {got}; unsaved vs unsaved (the limit) "
          f"{limit}; save {save_ms:.1f} ms, restore {restore_ms:.1f} ms "
          f"{card}", flush=True)
    _check(all(got[k] <= limit[k] for k in got),
           f"phase 22: the restored step differs from the unsaved steps by "
           f"more than they differ from each other: {got} > {limit}")

    # 23. evaluate on phase 22's checkpoint: 128 frustums in 4 predict
    # calls, the files, and the AP read back from detections.txt.
    result_dir = os.path.join(tmp.name, "result")
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    aps = test_lib.evaluate(resumed, result_dir)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    print(f"phase 23 evaluate: {eval_s:.2f} s, launches {launches}",
          flush=True)
    _expect_launches(launches, {"fps": 4 * val_batches,
                                "sa_infer": 8 * val_batches})
    dets = test_lib.read_sunrgbd_results(
        os.path.join(result_dir, "detections.txt"))
    _, val_ds = train_sup.build_datasets(resumed)
    again = ap_lib.eval_det(test_lib.detections_to_eval_boxes(dets),
                            test_lib.groundtruth_boxes(val_ds,
                                                       cfg.bin_config()))
    finite = all(np.isfinite(d.center).all() and np.isfinite(d.size).all()
                 and math.isfinite(d.score) and math.isfinite(d.heading)
                 for d in dets)
    print("phase 23 AP@0.25 " + " ".join(f"{k} {v:.4f}" for k, v in
                                          sorted(aps.items()))
          + f"; {len(dets)} detections, finite {finite}; read back "
          f"{'equal' if again == aps else again}", flush=True)
    _check(len(dets) == cfg.synthetic_val and finite,
           f"phase 23: {len(dets)} detections, finite {finite}")
    _check(again == aps, "phase 23: detections.txt read back gives other "
           "APs than evaluate returned")
    _check(all(0.0 <= v <= 1.0 for v in aps.values()),
           f"phase 23: an AP outside [0, 1]: {aps}")
    print(f"times driver (v2 bf16, B={cfg.batch_size}, N={cfg.num_point}, "
          f"C={cfg.num_channels}): train frustums/s by epoch from its log "
          f"{rates}; {DRIVER_STEPS} steps with 3 eval passes and 3 "
          f"checkpoints {t_run:.2f} s; checkpoint save {save_ms:.1f} ms, "
          f"restore {restore_ms:.1f} ms; evaluate {eval_s:.2f} s {card}",
          flush=True)
    tmp.cleanup()


# Phases 24-26: the transfer loop at config 4's widths (`config4_transfer`:
# N=1024, C=6, B=32, SUN RGB-D bins) on a v2 bf16 detector, through the
# functions a user runs.
TRANSFER_STEPS, TRANSFER_BOXPC_EPOCHS = 32, 2
REFINE_STEPS, REFINE_B = 500, 64


def transfer_cfg(seed: int, log_dir: str):
    """Phase 25's configuration: config 4's widths, a v2 bf16 detector."""
    from transferable3d_torch.train import config as config_lib
    from transferable3d_torch.train import train_semisup

    return train_semisup.SemisupConfig(**dataclasses.asdict(
        dataclasses.replace(
            config_lib.PRESETS["config4_transfer"],
            model="frustum_pointnets_v2", compute_dtype="bfloat16",
            synthetic_train=640, synthetic_val=160, device_data=True,
            max_steps=TRANSFER_STEPS, eval_every_epochs=1,
            ckpt_every_epochs=1, log_dir=log_dir, seed=seed)),
        boxpc_epochs=TRANSFER_BOXPC_EPOCHS)


def _flat_grads(model):
    return torch.cat([g.reshape(-1).cpu() for g in _grads(model).values()])


def _card_vs_cpu(what, step, make_state, model, batches):
    """One `step` on the card and on the CPU from copies of `model` (a
    module or a tuple of modules), each state built by `make_state` with
    a CPU generator of one seed, so both draw the same numbers and the
    same dropout masks; the float32 loss within 2% and the gradient
    cosine >= 0.99 (phase 10's f32 limits)."""
    from transferable3d_torch.ops import _build

    models = model if isinstance(model, tuple) else (model,)
    twins = tuple(copy.deepcopy(m).cpu() for m in models)
    out = []
    for ms in (models, twins):
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        _, metrics = step(make_state(*ms), *batches)
        torch.cuda.synchronize()
        out.append((metrics, _flat_grads(ms[0]), dict(_build.LAUNCHES)))
    key = "combined_loss" if "combined_loss" in out[0][0] else "total_loss"
    card, cpu = (float(o[0][key]) for o in out)
    rel = abs(card - cpu) / abs(cpu)
    cos = _cos(out[0][1], out[1][1])
    print(f"{what} card vs CPU, float32: {key} {card:.6g} vs {cpu:.6g} "
          f"(rel {rel:.3g}), gradient cosine {cos:.6f}", flush=True)
    _check(rel <= BF16_LOSS_REL and cos >= 0.99,
           f"{what}: card and CPU disagree (loss rel {rel}, cosine {cos})")
    return out[0][2]


def transfer(args, dev, card: str):
    """Phases 24-26: BoxPC (phase A), the semi-supervised driver (phase
    B) and `evaluate` with the BoxPC refinement, on the card."""
    with fused_sa_env(None):
        _transfer(args, dev, card)


def _phase_a(args, cfg, strong_ds, card):
    """24. One BoxPC step card vs CPU (no kernel), its time at B=32, then
    500 steps at B=64 on one batch and the refinement's IoU gain."""
    from transferable3d_torch.core import geometry
    from transferable3d_torch.models.boxpc import (BoxPCFitNet,
                                                   sample_perturbed_boxes)
    from transferable3d_torch.train import semisup, train_loop, train_sup
    from transferable3d_torch.train.test import make_boxpc_refine_step

    bins_cfg = cfg.bin_config()
    lr, bn = train_sup.build_schedules(cfg)
    step = semisup.make_boxpc_train_step(bins_cfg, bn,
                                         aniso_aug=cfg.boxpc_aniso_aug)
    batch = strong_ds.get_batch(list(range(cfg.batch_size)))
    model = BoxPCFitNet(bins_cfg,
                        generator=torch.Generator().manual_seed(args.seed))
    _check(next(model.parameters()).is_cuda, "BoxPC did not land on the card")
    launches = _card_vs_cpu(
        "phase 24 BoxPC step", step,
        lambda m: semisup.create_boxpc_state(
            m, train_loop.make_optimizer(lr),
            generator=torch.Generator().manual_seed(args.seed)),
        model, (batch,))
    print(f"phase 24 BoxPC step: launches {launches}", flush=True)
    _expect_launches(launches, {})

    # The step's time as the driver runs it (the state's generator on the
    # card), on the card's copy of the batch.
    state = semisup.create_boxpc_state(
        model, train_loop.make_optimizer(lr), seed=args.seed)
    dev_batch = train_loop.batch_to_device(batch, next(
        model.parameters()).device)
    a_ms = _time_ms(lambda: step(state, dev_batch), 5, 50)

    big = train_loop.batch_to_device(
        strong_ds.get_batch(list(range(REFINE_B))), dev_batch["points"].device)
    model = BoxPCFitNet(bins_cfg,
                        generator=torch.Generator().manual_seed(args.seed))
    lr64, bn64 = train_sup.build_schedules(
        dataclasses.replace(cfg, batch_size=REFINE_B))
    state = semisup.create_boxpc_state(model, train_loop.make_optimizer(lr64),
                                       seed=args.seed)
    step64 = semisup.make_boxpc_train_step(bins_cfg, bn64,
                                           aniso_aug=cfg.boxpc_aniso_aug)
    losses = []
    for _ in range(REFINE_STEPS):
        state, m = step64(state, big)
        losses.append(m["total_loss"])
    losses = [float(x) for x in losses]
    gt = semisup.gt_boxes_from_batch(big, bins_cfg)
    pert = sample_perturbed_boxes(
        torch.Generator(device=gt.center.device).manual_seed(args.seed + 5),
        gt)
    c, s, h, fit = make_boxpc_refine_step(model, 1)(big["points"], *pert)
    before = float(geometry.box3d_iou(*pert, *gt)[0].mean())
    after = float(geometry.box3d_iou(c, s, h, *gt)[0].mean())
    finite = all(bool(torch.isfinite(x).all()) for x in (c, s, h, fit))
    print(f"phase 24 BoxPC {REFINE_STEPS} steps at B={REFINE_B}: loss "
          f"{losses[0]:.4f} -> mean of last 5 {np.mean(losses[-5:]):.4f}; "
          f"refinement of perturbed boxes: mean 3D IoU {before:.4f} -> "
          f"{after:.4f} (gain {after - before:.4f}), finite {finite}",
          flush=True)
    _check(all(math.isfinite(x) for x in losses) and finite,
           "phase 24: a BoxPC loss or a refined box is not finite")
    _check(after > before + 0.02,
           f"phase 24: the refinement raised the mean IoU by "
           f"{after - before:.4f}, not more than 0.02")
    return a_ms


def _counting(make, record, hook=None):
    """`make` (a step factory) whose steps append their launch counts to
    `record`; `hook(i, args)` runs before step i, and `hook(i, None)`
    after it."""
    from transferable3d_torch.ops import _build

    def make_counting(*a, **kw):
        fn = make(*a, **kw)

        def step(*args):
            i = len(record)
            if hook:
                hook(i, args)
            before = dict(_build.LAUNCHES)
            out = fn(*args)
            record.append({k: v - before[k]
                           for k, v in _build.LAUNCHES.items()})
            if hook:
                hook(i, None)
            return out
        return step
    return make_counting


def _transfer(args, dev, card: str):
    import tempfile

    from transferable3d_torch.eval import ap as ap_lib
    from transferable3d_torch.models import registry
    from transferable3d_torch.models.boxpc import BoxPCFitNet
    from transferable3d_torch.ops import _build
    from transferable3d_torch.train import semisup, train_loop
    from transferable3d_torch.train import test as test_lib
    from transferable3d_torch.train import train_semisup, train_sup
    from transferable3d_torch.utils.checkpoint import CheckpointManager

    tmp = tempfile.TemporaryDirectory(prefix="t3d_transfer_")
    cfg = transfer_cfg(args.seed, os.path.join(tmp.name, "log"))
    _check((cfg.num_point, cfg.num_channels, cfg.batch_size)
           == (1024, 6, 32), f"config 4's widths changed: {cfg}")
    b = cfg.batch_size
    strong_ds, weak_ds, weak_val = train_semisup.build_semisup_datasets(cfg)
    epoch_steps = len(strong_ds) // b
    print(f"phase 24 data: strong {len(strong_ds)} ({cfg.strong_classes}), "
          f"weak {len(weak_ds)} ({cfg.weak_classes}), weak val "
          f"{len(weak_val)}; {epoch_steps} steps an epoch", flush=True)
    _check(3 <= epoch_steps <= TRANSFER_STEPS // 2 and len(weak_ds) >= b
           and len(weak_val) >= b,
           "phase 24: a split is too small or too large for phases 24-25")

    # 24. phase A
    a_ms = _phase_a(args, cfg, strong_ds, card)

    # 25. phase B through `train_semisup.train`: per-step launch gates,
    # BoxPC frozen, finite terms, the checkpoints; then one v1 float32
    # step card vs CPU.
    steps, evals, frozen, times = [], [], {}, {}
    timed = (epoch_steps + 1, 2 * epoch_steps - 1)  # in epoch 1, not its first

    def watch(i, step_args):
        if step_args is not None and i == 0:
            bp = step_args[0].boxpc
            frozen["module"] = bp
            frozen["before"] = {k: v.clone() for k, v in
                                bp.state_dict().items()}
        for key, at, before in (("start", timed[0], True),
                                ("end", timed[1], False)):
            if i == at and (step_args is not None) == before:
                torch.cuda.synchronize()
                times[key] = time.perf_counter()

    saved = (semisup.make_semisup_train_step, train_loop.make_eval_step)
    semisup.make_semisup_train_step = _counting(saved[0], steps, watch)
    train_loop.make_eval_step = _counting(saved[1], evals)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        train_semisup.train(cfg)
    finally:
        semisup.make_semisup_train_step, train_loop.make_eval_step = saved
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    total = dict(_build.LAUNCHES)
    print(f"phase 25 train_semisup.train: {run_s:.2f} s, {len(steps)} "
          f"steps, {len(evals)} eval steps, launches {total}", flush=True)
    # Two detector passes a step: K1 and the forward kernels K5-K7 run for
    # all 8 SA scales of each. The backward kernels K8/K9 run for the
    # strong pass's 8 scales and the weak pass's box net (2 scales): the
    # weak losses do not reach the weak pass's seg net (its mask is an
    # argmax), so that backward has no cotangent and is never launched.
    want_step = {"fps": 8, "sa_extract": 16, "sa_fwd_step": 16,
                 "sa_fwd_last": 16, "sa_bwd_step": 10, "sa_bwd_step0": 10}
    want_eval = {"fps": 4, "sa_infer": 8}
    for what, record, want in (("step", steps, want_step),
                               ("eval step", evals, want_eval)):
        bad = [(i, r) for i, r in enumerate(record)
               if r != {k: want.get(k, 0) for k in r}]
        _check(not bad, f"phase 25: a {what} launched other kernels than "
               f"{want}: {bad[:2]}")
    val_batches = len(weak_val) // b
    n_epochs = -(-TRANSFER_STEPS // epoch_steps)
    _check(len(steps) == TRANSFER_STEPS
           and len(evals) == n_epochs * val_batches,
           f"phase 25: {len(steps)} steps and {len(evals)} eval steps")
    _expect_launches(total, {
        k: len(steps) * want_step.get(k, 0) + len(evals) * want_eval.get(k, 0)
        for k in set(want_step) | set(want_eval)})
    bp = frozen["module"]
    changed = [k for k, v in bp.state_dict().items()
               if not torch.equal(v, frozen["before"][k])]
    phase_a = CheckpointManager(os.path.join(cfg.log_dir, "boxpc_ckpt"))
    restored = semisup.create_boxpc_state(
        BoxPCFitNet(cfg.bin_config()), train_loop.make_optimizer(
            train_sup.build_schedules(cfg)[0]))
    phase_a.restore_latest(restored)
    unlike_a = [k for k, v in restored.model.state_dict().items()
                if not torch.equal(v, bp.state_dict()[k])]
    print(f"phase 25 BoxPC: phase A's checkpoint at step {restored.step}; "
          f"entries changed in phase B {changed}; unlike the checkpoint "
          f"{unlike_a}; grads {[k for k, p in bp.named_parameters() if p.grad is not None]}",
          flush=True)
    _check(not changed and not unlike_a and restored.step == (
        TRANSFER_BOXPC_EPOCHS * epoch_steps) and all(
            p.grad is None and not p.requires_grad for p in bp.parameters()),
        "phase 25: BoxPC is not bit-identical through phase B")
    rows = _csv_rows(os.path.join(cfg.log_dir, "metrics_train.csv"))
    terms = [k for k in rows[-1] if k.endswith("_loss")]
    print("phase 25 last train row " + " ".join(
        f"{k} {v:.5g}" for k, v in rows[-1].items()), flush=True)
    _check(all(math.isfinite(r[k]) for r in rows for k in terms)
           and {"total_loss", "weak_total_loss", "weak_fit_loss",
                "weak_refine_loss", "weak_reproj_loss",
                "weak_size_prior_loss", "combined_loss"} <= set(terms),
           f"phase 25: a logged term is missing or not finite: {terms}")
    _check(all(0.0 <= r["weak_trust_frac"] <= 1.0 for r in rows),
           "phase 25: weak_trust_frac outside [0, 1]")
    ckpt = CheckpointManager(os.path.join(cfg.log_dir, "ckpt"))
    _check(ckpt.latest_step() == TRANSFER_STEPS,
           f"phase 25: newest checkpoint {ckpt.latest_step()}")
    log = open(os.path.join(cfg.log_dir, "log_train.txt")).read()
    rates = [float(r) for r in re.findall(r"\(([0-9.]+) frustums/s\)", log)]
    span = timed[1] - timed[0] + 1
    b_ms = (times["end"] - times["start"]) / span * 1e3
    print(f"phase 25 checkpoints {ckpt.steps()}, weak val logged at "
          f"{[int(r['step']) for r in _csv_rows(os.path.join(cfg.log_dir, 'metrics_weak_val.csv'))]}"
          f"; frustums/s by epoch from the log {rates}; {span} steps of "
          f"epoch 1 {b_ms:.2f} ms a step", flush=True)

    lr, bn = train_sup.build_schedules(cfg)
    bins_cfg = cfg.bin_config()
    det = registry.get_model("frustum_pointnets_v1", bins_cfg, in_channels=6,
                             generator=torch.Generator().manual_seed(args.seed))
    boxpc = BoxPCFitNet(bins_cfg,
                        generator=torch.Generator().manual_seed(args.seed + 1))
    _card_vs_cpu(
        f"phase 25 v1 semi-supervised step ({CHECK_B} + {CHECK_B} frustums)",
        semisup.make_semisup_train_step(bins_cfg, lr, bn),
        lambda d, p: semisup.SemisupState(train_loop.create_train_state(
            d, train_loop.make_optimizer(lr),
            generator=torch.Generator().manual_seed(args.seed)), p),
        (det, boxpc), (strong_ds.get_batch(list(range(CHECK_B))),
                       weak_ds.get_batch(list(range(CHECK_B)))))

    # 26. evaluate with the BoxPC refinement, and without it.
    result_dir = os.path.join(tmp.name, "result")
    _, val_ds = train_sup.build_datasets(cfg)
    calls = -(-len(val_ds) // b)
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    aps = test_lib.evaluate(cfg, result_dir,
                            boxpc_dir=os.path.join(cfg.log_dir, "boxpc_ckpt"))
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    print(f"phase 26 evaluate with BoxPC refinement: {eval_s:.2f} s, "
          f"{calls} predict calls, launches {launches}", flush=True)
    _expect_launches(launches, {"fps": 4 * calls, "sa_infer": 8 * calls})
    plain_dir = os.path.join(tmp.name, "plain")
    plain_aps = test_lib.evaluate(cfg, plain_dir)
    dets, plain = (test_lib.read_sunrgbd_results(os.path.join(d,
                                                              "detections.txt"))
                   for d in (result_dir, plain_dir))
    again = ap_lib.eval_det(test_lib.detections_to_eval_boxes(dets),
                            test_lib.groundtruth_boxes(val_ds, bins_cfg))
    finite = all(np.isfinite(d.center).all() and np.isfinite(d.size).all()
                 and math.isfinite(d.score) and math.isfinite(d.heading)
                 for d in dets)
    moved = max(float(np.abs(d.center - p.center).max()) for d, p in
                zip(dets, plain))
    print("phase 26 AP@0.25 refined " + " ".join(
        f"{k} {v:.4f}" for k, v in sorted(aps.items()))
          + f"; unrefined mAP {plain_aps['mAP']:.4f}; {len(dets)} "
          f"detections, finite {finite}, largest center move {moved:.4f} m;"
          f" read back {'equal' if again == aps else again}", flush=True)
    _check(len(dets) == len(plain) == len(val_ds) and finite,
           f"phase 26: {len(dets)} detections, finite {finite}")
    _check(moved > 0, "phase 26: the refinement moved no detection")
    _check(again == aps, "phase 26: detections.txt read back gives other "
           "APs than evaluate returned")
    _check(all(0.0 <= v <= 1.0 for v in aps.values()),
           f"phase 26: an AP outside [0, 1]: {aps}")
    print(f"times transfer (config 4's widths, v2 bf16 detector, B={b}, "
          f"N={cfg.num_point}, C={cfg.num_channels}): phase A "
          f"{a_ms:.3f} ms a BoxPC step at B={b}; phase B {b_ms:.2f} ms a "
          f"step, {2 * b / b_ms * 1e3:.1f} frustums/s (2 x {b} a step), "
          f"peak memory {peak:.3f} GiB; train_semisup.train {run_s:.2f} s; "
          f"evaluate with the refinement {eval_s:.2f} s {card}", flush=True)
    tmp.cleanup()


# Phase 27: the training repeats bit for bit on one card.
def repro(args, dev, card: str):
    """Phase 27: phase 22's training and phase 25's phase B, each run twice
    in this process from one seed."""
    with fused_sa_env(None):
        _repro(args, dev, card)


def flat_state(model, optimizer=None):
    """Every parameter and buffer, and Adam's moments, as clones."""
    out = [v.detach().clone() for v in model.state_dict().values()]
    if optimizer is not None:
        for st in optimizer.adam.state.values():
            out += [st[k].detach().clone() for k in ("exp_avg", "exp_avg_sq")
                    if k in st]
    return out


def first_parting(a, b):
    """(first step index at which two runs' recorded states differ or
    None, tensors that differ at the end, their largest |diff|)."""
    first = None
    for i, (x, y) in enumerate(zip(a, b)):
        if not all(torch.equal(u, v) for u, v in zip(x, y)):
            first = i
            break
    end = [(u, v) for u, v in zip(a[-1], b[-1]) if not torch.equal(u, v)]
    gap = max((float((u.float() - v.float()).abs().max()) for u, v in end),
              default=0.0)
    return first, len(end), gap


def _recording(make, record, state_of):
    """`make` (a step factory) whose steps append `state_of(state)` after
    every step to `record`."""
    def make_recording(*a, **kw):
        fn = make(*a, **kw)

        def step(*args):
            out = fn(*args)
            record.append(state_of(out[0]))
            return out
        return step
    return make_recording


def run_driver(seed, tmp, tag):
    """Phase 22's training; the state after every step."""
    from transferable3d_torch.train import train_loop, train_sup

    record = []
    saved = train_loop.make_train_step
    train_loop.make_train_step = _recording(
        saved, record, lambda s: flat_state(s.model, s.optimizer))
    try:
        train_sup.train(driver_cfg(seed, os.path.join(tmp, tag)))
    finally:
        train_loop.make_train_step = saved
    return record


def run_transfer(seed, tmp, tag):
    """Phase 25's transfer loop; the detector's state after every
    phase-B step."""
    from transferable3d_torch.train import semisup, train_semisup

    record = []
    saved = semisup.make_semisup_train_step
    semisup.make_semisup_train_step = _recording(
        saved, record,
        lambda s: flat_state(s.detector.model, s.detector.optimizer))
    try:
        train_semisup.train(transfer_cfg(seed, os.path.join(tmp, tag)))
    finally:
        semisup.make_semisup_train_step = saved
    return record


def _repro(args, dev, card: str):
    import tempfile

    from transferable3d_torch.train import test as test_lib

    tmp = tempfile.TemporaryDirectory(prefix="t3d_repro_")
    t0 = time.perf_counter()
    runs = [run_driver(args.seed, tmp.name, f"driver{i}") for i in range(2)]
    aps = [test_lib.evaluate(driver_cfg(args.seed, os.path.join(
        tmp.name, f"driver{i}")), os.path.join(tmp.name, f"r{i}"))
        for i in range(2)]
    first, end, _ = first_parting(*runs)
    print(f"phase 27 driver twice ({DRIVER_STEPS} steps, "
          f"{len(runs[0][-1])} tensors: parameters, BN buffers, Adam "
          f"moments): "
          + ("bit-identical after every step" if first is None else
             f"part after step {first + 1}, {end} tensors differ at the end")
          + f"; evaluate mAP@0.25 {aps[0]['mAP']:.6f} and "
          f"{aps[1]['mAP']:.6f}, APs equal {aps[0] == aps[1]}", flush=True)
    _check(len(runs[0]) == len(runs[1]) == DRIVER_STEPS and first is None,
           "phase 27: the driver's two runs from one seed differ")
    _check(aps[0] == aps[1], "phase 27: evaluate gives other APs on the "
           "second run's checkpoint")
    runs = [run_transfer(args.seed, tmp.name, f"transfer{i}")
            for i in range(2)]
    first, end, _ = first_parting(*runs)
    print(f"phase 27 transfer loop twice ({TRANSFER_STEPS} phase-B steps, "
          f"the detector's {len(runs[0][-1])} tensors): "
          + ("bit-identical after every step" if first is None else
             f"part after step {first + 1}, {end} tensors differ at the end")
          + f"; {time.perf_counter() - t0:.1f} s {card}", flush=True)
    _check(len(runs[0]) == len(runs[1]) == TRANSFER_STEPS and first is None,
           "phase 27: the transfer loop's two runs from one seed differ")
    tmp.cleanup()


# Phase 28: the transfer study (scripts/torch_transfer_study.py) at its
# published widths (N=512, B=64, C=4, hard synthetic frustums, v2 bf16),
# cut in depth: STUDY_BOXPC_EPOCHS BoxPC epochs and STUDY_EPOCHS phase-B
# epochs of the protocol's 40 and 150, at its 4,096 train and 1,024 val
# frustums.
STUDY_EPOCHS, STUDY_BOXPC_EPOCHS = 2, 2
# The phase-B step (of the transfer arm's second epoch) and the eval step
# whose kernel arguments are captured and held against the plain twins.
STUDY_CHECK_STEP, STUDY_CHECK_EVAL = 25, 0
STUDY_KEYS = {"variant", "seed", "model", "mAP", "per_class",
              "train_seconds"}


def _to(x, dev):
    """x (a tensor, or a tuple or list holding tensors) copied to `dev`."""
    if torch.is_tensor(x):
        return x.detach().to(dev, copy=True)
    if isinstance(x, (tuple, list)):
        return type(x)(_to(v, dev) for v in x)
    return x


class _Capture:
    """A `_counting` hook that, around step `at` only, records the
    arguments of each (module, function) as copies on the host, so that
    they hold no device memory while the run goes on."""

    def __init__(self, at, targets):
        self.at, self.targets = at, targets
        self.calls = {name: [] for _, name in targets}

    def __call__(self, i, args):
        if i != self.at:
            return
        if args is None:
            for mod, name in self.targets:
                setattr(mod, name, self.saved[name])
            return

        def recorder(fn, out):
            def rec(*a):
                out.append(_to(a, "cpu"))
                return fn(*a)
            return rec

        self.saved = {name: getattr(mod, name) for mod, name in self.targets}
        for mod, name in self.targets:
            setattr(mod, name, recorder(self.saved[name], self.calls[name]))


def _study_kernels(step_calls, eval_calls, step_launches, phase=28):
    """K1 and K5-K9 on one train step's arguments and K1 and K2 on one
    eval or predict step's, each against its plain twin at phases 5 and
    13's limits; K9's H, Mq and cnt also twice the same bits and equal,
    bit for bit, to the twin's order over its own dy_0."""
    calls, ev = ({k: [_to(a, "cuda") for a in v] for k, v in c.calls.items()}
                 for c in (step_calls, eval_calls))
    k6 = [a for a in calls["sa_fwd_step_cuda"] if not a[4]]
    k7 = [a for a in calls["sa_fwd_step_cuda"] if a[4]]
    for c in (calls, ev):  # FPS of one point launches nothing
        c["farthest_point_sample"] = [a for a in c["farthest_point_sample"]
                                      if a[1] > 1]
    got = {"fps": len(calls["farthest_point_sample"]),
           "sa_extract": len(calls["sa_extract_cuda"]),
           "sa_fwd_step": len(k6), "sa_fwd_last": len(k7),
           "sa_bwd_step": len(calls["sa_bwd_step_cuda"]),
           "sa_bwd_step0": len(calls["sa_bwd_step0_cuda"])}
    _check(got == {k: step_launches[k] for k in got},
           f"phase {phase}: the captured step's calls {got} are not its "
           f"launches {step_launches}")
    _check(ev["farthest_point_sample"] and ev["sa_infer"],
           f"phase {phase}: no eval step was captured")
    for a in calls["farthest_point_sample"] + ev["farthest_point_sample"]:
        _check_fps(f"phase {phase}", *a)
    for a in ev["sa_infer"]:
        _check_sa_infer(f"phase {phase}", a)
    check = FusedChecks(phase=phase)
    for a in calls["sa_extract_cuda"]:
        share = _ball_shares(a[0], a[1], a[4], a[5])
        print(f"phase {phase} balls S={a[0].shape[1]} N={a[1].shape[1]} "
              f"K={a[5]} r={a[4]}: " + " ".join(f"{nm} {v:.4f}"
                                       for nm, v in share.items()),
              flush=True)
        check.extract("", *a)
    for a in k6 + k7:
        check.fwd_step("", *a)
    for a in calls["sa_bwd_step_cuda"]:
        check.bwd_step("", *a)
    for a in calls["sa_bwd_step0_cuda"]:
        check.bwd_step0("", *a)


def study(args, dev, card: str):
    """Phase 28: `torch_transfer_study.main` for the transfer and control
    arms of one seed, then again on its JSON, which must skip both."""
    with fused_sa_env(None):
        _study(args, dev, card)


def _study(args, dev, card: str):
    import io
    import tempfile

    from transferable3d_torch.models import pointnet2
    from transferable3d_torch.ops import _build, fused_sa
    from transferable3d_torch.train import semisup, train_loop

    mod = _script("torch_transfer_study")
    tmp = tempfile.TemporaryDirectory(prefix="t3d_study_")
    out_json = os.path.join(tmp.name, "study.json")
    argv = ["--model", "frustum_pointnets_v2", "--diag", "--seed_list",
            str(args.seed), "--variants", "transfer,control", "--epochs",
            str(STUDY_EPOCHS), "--boxpc_epochs", str(STUDY_BOXPC_EPOCHS),
            "--train_size", "4096", "--val_size", "1024", "--num_point",
            "512", "--batch_size", "64", "--weak_warmup_steps", "2000",
            "--out_dir", tmp.name, "--out_json", out_json]
    steps, evals = [], []
    step_calls = _Capture(STUDY_CHECK_STEP, (
        (pointnet2, "farthest_point_sample"), (fused_sa, "sa_extract_cuda"),
        (fused_sa, "sa_fwd_step_cuda"), (fused_sa, "sa_bwd_step_cuda"),
        (fused_sa, "sa_bwd_step0_cuda")))
    eval_calls = _Capture(STUDY_CHECK_EVAL, (
        (pointnet2, "farthest_point_sample"), (fused_sa, "sa_infer")))
    saved = (semisup.make_semisup_train_step, train_loop.make_eval_step)
    semisup.make_semisup_train_step = _counting(saved[0], steps, step_calls)
    train_loop.make_eval_step = _counting(saved[1], evals, eval_calls)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        mod.main(argv)
    finally:
        semisup.make_semisup_train_step, train_loop.make_eval_step = saved
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    total = dict(_build.LAUNCHES)
    print(f"phase 28 study main: {run_s:.2f} s, {len(steps)} phase-B steps, "
          f"{len(evals)} eval steps, launches {total}", flush=True)
    rerouted = total["fused_sa_rerouted"]
    if rerouted:
        print(f"phase 28: fused_sa_rerouted {rerouted}, K3/K4 "
              f"{total['extract_fwd']}/{total['extract_bwd']}", flush=True)
    want_step = {"fps": 8, "sa_extract": 16, "sa_fwd_step": 16,
                 "sa_fwd_last": 16, "sa_bwd_step": 10, "sa_bwd_step0": 10}
    bad = [(i, r) for i, r in enumerate(steps)
           if r != {k: want_step.get(k, 0) for k in r}]
    _check(steps and not rerouted and not bad,
           f"phase 28: a phase-B step launched other kernels than "
           f"{want_step}: {bad[:2]}")
    with open(out_json) as f:
        results = json.load(f)
    _check([(r["variant"], r["seed"]) for r in results]
           == [("transfer", args.seed), ("control", args.seed)]
           and all(set(r) == STUDY_KEYS for r in results),
           f"phase 28: the study's JSON records: {results}")
    for r in results:
        rows = _csv_rows(os.path.join(tmp.name, f"{r['variant']}_s{r['seed']}",
                                      "metrics_train.csv"))
        terms = [k for k in rows[-1] if k.endswith("_loss")]
        print(f"phase 28 {r['variant']}: mAP@0.25 {r['mAP']:.4f}, per class "
              + " ".join(f"{k} {v:.4f}" for k, v in r["per_class"].items())
              + f", train {r['train_seconds']} s; last train row "
              + " ".join(f"{k} {rows[-1][k]:.5g}" for k in terms), flush=True)
        _check(all(math.isfinite(row[k]) for row in rows for k in terms),
               f"phase 28 {r['variant']}: a logged loss is not finite")
        _check(all(0.0 <= v <= 1.0 for v in [r["mAP"],
                                             *r["per_class"].values()]),
               f"phase 28 {r['variant']}: an AP outside [0, 1]")
    before = len(steps)
    semisup.make_semisup_train_step = _counting(saved[0], steps)
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            mod.main(argv)
    finally:
        semisup.make_semisup_train_step = saved[0]
    with open(out_json) as f:
        again = json.load(f)
    print(f"phase 28 resume: {len(steps) - before} new steps, JSON "
          f"{'unchanged' if again == results else 'changed'}; summary:\n"
          + out.getvalue().strip(), flush=True)
    _check(len(steps) == before and again == results,
           "phase 28: a second main on the same JSON trained again")
    _study_kernels(step_calls, eval_calls, steps[STUDY_CHECK_STEP])
    per_run = len(steps) // 2
    print(f"times study (cut: {STUDY_BOXPC_EPOCHS} BoxPC and {STUDY_EPOCHS} "
          f"phase-B epochs, {per_run} phase-B steps a run at B=64, N=512, "
          f"C=4): {run_s:.2f} s for two runs, peak memory {peak:.3f} GiB "
          f"{card}", flush=True)
    tmp.cleanup()


def _trace_kernels(log_dir: str) -> list:
    """Names of the device kernels in the one Chrome trace under
    `log_dir`."""
    import glob

    files = glob.glob(os.path.join(log_dir, "*.pt.trace.json"))
    _check(len(files) == 1, f"phase 29: trace files {files}")
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    return sorted({e["name"] for e in events if e.get("cat") == "kernel"})


def tools(args, dev, card: str, keep: dict):
    """Phase 29: `sample_and_group` and `knn_point` on the card against the
    same calls on the CPU, `profiling.trace` and `device_ms` around a
    predict step, and `viz` on phase 6's first detection."""
    import tempfile

    from transferable3d_torch.core.geometry import rotate_points_y_np
    from transferable3d_torch.models import pointnet2
    from transferable3d_torch.ops import _build, grouping
    from transferable3d_torch.utils import profiling, viz

    # v2's SA1 shape on frustums whose distances are exact on both devices
    pts = keep["batch"]["points"].astype(np.float64)
    pts[..., :3] = np.clip(pts[..., :3] - pts[..., :3].mean(1, keepdims=True),
                           -8.9, 8.9)
    pts = (np.round(pts * 256) / 256).astype(np.float32)
    xyz_h, feats_h = torch.from_numpy(pts[..., :3]), torch.from_numpy(
        pts[..., 3:])
    xyz, feats = xyz_h.to(dev), feats_h.to(dev)
    for r, k in zip((0.2, 0.4, 0.8), (32, 64, 128)):
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        new_xyz, grouped = pointnet2.sample_and_group(128, r, k, xyz, feats)
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
        _expect_launches(launches, {"fps": 1})
        ref_xyz, ref_grouped = pointnet2.sample_and_group(128, r, k, xyz_h,
                                                          feats_h)
        same = (torch.equal(new_xyz.cpu(), ref_xyz)
                and torch.equal(grouped.cpu(), ref_grouped))
        print(f"phase 29 sample_and_group S=128 r={r} K={k}: grouped "
              f"{tuple(grouped.shape)}, launches "
              f"{ {n: v for n, v in launches.items() if v} }, equal to the "
              f"CPU's {same}", flush=True)
        _check(same, "phase 29: sample_and_group on the card differs from "
               "the CPU's")
    idx, d2 = grouping.knn_point(new_xyz, xyz, 0.0, 16)
    ref_idx, ref_d2 = grouping.knn_point(ref_xyz, xyz_h, 0.0, 16)
    ties = float((ref_d2[..., 1:] == ref_d2[..., :-1]).float().mean())
    same = torch.equal(idx.cpu(), ref_idx) and torch.equal(d2.cpu(), ref_d2)
    print(f"phase 29 knn_point k=16: indices {tuple(idx.shape)} "
          f"{idx.dtype}, neighbours tied with the next {ties:.4f}, equal to "
          f"the CPU's {same}", flush=True)
    _check(idx.dtype == torch.int32 and same,
           "phase 29: knn_point on the card differs from the CPU's")

    # profiling around the predict step
    predict = keep["predict"]
    batch = {k: torch.as_tensor(v, device=dev)
             for k, v in keep["batch"].items()}
    with tempfile.TemporaryDirectory(prefix="t3d_tools_") as tmp:
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        with profiling.trace(os.path.join(tmp, "trace")):
            predict(batch)
            torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
        names = _trace_kernels(os.path.join(tmp, "trace"))
    _expect_launches(launches, {"fps": 4, "sa_infer": 8})
    k1 = [n for n in names if "fps_kernel" in n]
    k2 = [n for n in names if "sa_infer_" in n and "_kernel" in n]
    print(f"phase 29 trace of a predict step: {len(names)} kernel names, "
          f"K1 {k1}, K2 {k2}, launches "
          f"{ {n: v for n, v in launches.items() if v} }", flush=True)
    _check(k1 and k2, "phase 29: the trace does not name K1 and K2")
    walls = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        predict(batch)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    stamps = []

    def stamped(b):
        stamps.append(time.perf_counter())
        return predict(b)

    torch.cuda.synchronize()
    dms = profiling.device_ms(stamped, batch, steps=3)
    # the host's clock from the first timed call to device_ms's return,
    # its untimed first call left out: the wall time of the 3 calls that
    # the CUDA events bracket
    wall = (time.perf_counter() - stamps[1]) * 1e3 / 3
    print(f"phase 29 device_ms of the predict step: {dms:.3f} ms (CUDA "
          f"events over 3 calls), the wall time of those 3 calls "
          f"{wall:.3f} ms a call, a synchronised step alone "
          f"{np.median(walls):.3f} ms (median of 5) {card}", flush=True)
    _check(0.0 < dms <= wall, "phase 29: device_ms outside (0, wall]")

    # viz of phase 6's first detection, in the camera frame
    det, data = keep["det"], keep["data"]
    frustum = rotate_points_y_np(
        data.points[0][None, :, :3],
        np.float32(-data.records[0].frustum_angle))[0]
    with tempfile.TemporaryDirectory(prefix="t3d_viz_") as tmp:
        page = viz.export_html(
            frustum, boxes=[{"center": det.center, "size": det.size,
                             "heading": det.heading,
                             "label": det.classname}],
            path=os.path.join(tmp, "det.html"), title=det.frame_id)
        with open(page) as f:
            data_js = json.loads(f.read().split("const DATA = ")[1]
                                 .split(";\n")[0])
        print(f"phase 29 viz: export_html {len(data_js['points'])} points "
              f"and {len(data_js['boxes'])} box labelled "
              f"{data_js['boxes'][0]['label']!r}", flush=True)
        _check(len(data_js["points"]) == N
               and data_js["boxes"][0]["label"] == det.classname,
               "phase 29: export_html wrote no viewer of the detection")
        if importlib.util.find_spec("matplotlib") is None:
            print("phase 29 viz: draw_frustum not run on the card: it draws "
                  "with matplotlib, which this machine does not have",
                  flush=True)
        else:
            png = viz.draw_frustum(
                frustum, pred_box=(det.center, det.size, det.heading),
                path=os.path.join(tmp, "det.png"),
                title=f"{det.frame_id} ({det.classname})")
            with open(png, "rb") as f:
                png_ok = f.read(8) == b"\x89PNG\r\n\x1a\n"
            png_bytes = os.path.getsize(png)
            print(f"phase 29 viz: draw_frustum {png_bytes} bytes",
                  flush=True)
            _check(png_ok and png_bytes > 1000,
                   "phase 29: draw_frustum wrote no figure")
    print("phase 29 tf1_import: not run on the card: it reads TF1 "
          "checkpoints through tensorflow, which this machine need not "
          "have", flush=True)


# Phase 30: data parallelism, by default two ranks on the one card (gloo;
# NCCL takes one rank a card). `--world N` on a machine with N cards runs
# N ranks over NCCL, a card each.
DP_WORLD = 2
# (a) `config5_mesh_large_batch` at its widths (v1 bf16, N=1024, C=6, a
# global batch of 256); (b) `v2_train`'s shape (v2 bf16 fused, N=1024,
# C=4, a global batch of 128).
DP_V1_B, DP_V2_B = 256, 128
# (c) the drivers: config5 to DP_DRIVER_STEPS steps, then resumed to
# DP_DRIVER_RESUME (768 train frustums: 3 steps an epoch).
DP_DRIVER_STEPS, DP_DRIVER_RESUME = 12, 24
# Limits of the W-rank step against the 1-rank step (bf16): the loss
# (relative), the gradient cosine of the whole model and of each net,
# the BN running buffers (largest gap over the buffer's largest value),
# the norm of the whole gradient over the 1-rank step's (v1: the cosines
# do not see a gradient scaled as a whole) and, on the fused path, the
# norm of the fused chains' BN gradients over the 1-rank step's. Set
# from the card's readings (PERF.md section 6), each between the sound
# runs with their witness and the controls (v1's norm on an NVIDIA H100
# 80GB HBM3 at 700 W: two ranks 1.0003, the witness 0.9991, per-rank
# denominators 2.0006).
DP_V1_LIMITS = {"loss": 5e-3, "all": 0.9, "seg_net": 0.999, "tnet": 0.85,
                "box_net": 0.95, "stats": 5e-2, "norm": (0.98, 1.02)}
DP_V2_LIMITS = {"loss": 0.02, **FULL_BATCH_COS, "stats": 5e-2,
                "fused_bn_norm": (0.9, 1.1)}


def _grid_batch(batch):
    """Each frustum moved to its own mean and onto the 1/256 grid, as
    `SmallStep` places its frustums."""
    out = {k: v.copy() for k, v in batch.items()}
    mean = out["points"][..., :3].mean(axis=1)
    out["points"][..., :3] = np.round(
        (out["points"][..., :3] - mean[:, None]) * 256) / 256
    out["center"] = out["center"] - mean
    return out


@contextlib.contextmanager
def _dp_faults(names, model):
    """Phase 30's and 31's controls for the block: `local_bn` (BN
    statistics left per rank), `local_denominators` (loss and metric
    denominators left per rank), `dgamma_twice` (the fused chains' dgamma
    and dbeta all-reduced once before the gradient all-reduce adds them
    again); on a points mesh `local_pool` (every max over points on the
    rank's points alone), `local_masking` (the masking on the rank's
    points alone) and `box_grads_everywhere` (the box stages' gradients
    summed over every rank, not over the data group) and
    `box_cotangent_unsummed` (BoxPC's cotangent of the box it reads on the
    rank's points left unsummed over the points group)."""
    import torch.distributed as dist

    from transferable3d_torch.models import model_util
    from transferable3d_torch.models.pointnet2 import GroupedPointMLP
    from transferable3d_torch.parallel import mesh as mesh_lib

    saved = (mesh_lib.batch_stats_sum, mesh_lib.global_count,
             mesh_lib.all_reduce_grads, mesh_lib.points_max,
             model_util.point_cloud_masking, mesh_lib.from_replicated)
    if "box_cotangent_unsummed" in names:
        mesh_lib.from_replicated = lambda x: x
    if "local_bn" in names:
        mesh_lib.batch_stats_sum = lambda s, s2, rows: (s, s2, rows)
    if "local_denominators" in names:
        mesh_lib.global_count = lambda count: count
    if "dgamma_twice" in names:
        twice = [p for m in model.modules() if isinstance(m, GroupedPointMLP)
                 for i in range(len(m.features))
                 for p in (getattr(m, f"bn_{i}").scale,
                           getattr(m, f"bn_{i}").bias)]

        def all_reduce_grads(params, replicated=()):
            for p in twice:
                dist.all_reduce(p.grad)
            saved[2](params, replicated)
        mesh_lib.all_reduce_grads = all_reduce_grads
    if "local_pool" in names:
        mesh_lib.points_max = lambda x, dim: x.amax(dim=dim)
    if "local_masking" in names:
        def masking(*a, **kw):
            gather = mesh_lib.points_gather
            mesh_lib.points_gather = lambda x: x
            try:
                return saved[4](*a, **kw)
            finally:
                mesh_lib.points_gather = gather
        model_util.point_cloud_masking = masking
    if "box_grads_everywhere" in names:
        mesh_lib.all_reduce_grads = lambda params, replicated=(): saved[2](
            params)
    try:
        yield
    finally:
        (mesh_lib.batch_stats_sum, mesh_lib.global_count,
         mesh_lib.all_reduce_grads, mesh_lib.points_max,
         model_util.point_cloud_masking, mesh_lib.from_replicated) = saved


class DPStep:
    """One train step of phase 30 on `device` (default cuda:0) from a
    spec (model name, dtype, state_dict, the global batch, the keep
    mask's seed, the foreground margin), on this rank's rows of the
    current mesh (none: one rank, the whole batch), with the counters
    zeroed just before it and the
    local sums of K5-K7 recorded. The foreground logit is raised by the
    margin (every point masked) and a v2 box net's input is snapped to
    the grid (`_snap_to_grid`), as `SmallStep` pins its bf16 steps."""

    def __init__(self, spec, device=None):
        self.spec, self.device = spec, device or "cuda:0"
        self._keep = None

    def model(self):
        from transferable3d_torch.core import bins as bins_lib
        from transferable3d_torch.models import registry

        s = self.spec
        m = registry.get_model(
            s["name"], bins_lib.SUNRGBD, dtype=torch.bfloat16,
            device=self.device, in_channels=s["batch"]["points"].shape[-1])
        m.load_state_dict(s["state_dict"])
        if s.get("margin"):
            with torch.no_grad():
                m.seg_net.seg_out.bias[1] += s["margin"]
            if s["name"].endswith("v2"):
                m.box_net.register_forward_pre_hook(_snap_to_grid)
        return m

    def keep(self):
        """The whole batch's keep mask, drawn once (33.5M numbers on the
        host at B=256)."""
        from transferable3d_torch.models import layers

        if self._keep is None:
            pts = self.spec["batch"]["points"]
            self._keep = layers.dropout_keep_mask(
                (pts.shape[0], pts.shape[1], 128), 0.5,
                torch.Generator().manual_seed(self.spec["keep_seed"]))
        return self._keep

    def state(self, model):
        from transferable3d_torch.train import schedules, train_loop

        b = len(self.spec["batch"]["points"])
        lr = schedules.exponential_staircase_lr(batch_size=b)
        self.bn = schedules.bn_momentum_schedule(batch_size=b)
        self.lr = lr
        return train_loop.create_train_state(
            model, train_loop.make_optimizer(lr), generator=torch.Generator())

    def __call__(self, faults=(), order=None, keep_args=False):
        from transferable3d_torch.core import bins as bins_lib
        from transferable3d_torch.ops import _build, fused_sa
        from transferable3d_torch.parallel import mesh as mesh_lib
        from transferable3d_torch.train import train_loop

        model = self.model()
        state = self.state(model)
        batch, keep = self.spec["batch"], self.keep()
        if order is not None:
            batch = {k: v[order] for k, v in batch.items()}
            keep = keep[torch.from_numpy(order)]
        step = train_loop.make_train_step(bins_lib.SUNRGBD, self.lr,
                                          self.bn)
        sums, seen = [], {}
        orig = fused_sa.sa_extract, fused_sa.sa_fwd_step

        def record(fn):
            def wrapped(*a, **kw):
                out = fn(*a, **kw)
                # The arguments are copied: the biases among them are
                # the parameters, which the optimizer then updates.
                sums.append(tuple(t.detach().cpu().clone() for t in (
                    out[1], out[2], out[0].float().abs().sum((0, 1, 2))))
                    + ((fn, tuple(x.detach().clone() if torch.is_tensor(x)
                                  else x for x in a), kw)
                       if keep_args else ()))
                return out
            return wrapped

        fused_sa.sa_extract, fused_sa.sa_fwd_step = map(record, orig)
        hook = model.register_forward_hook(
            lambda mod, a, out: seen.update(mask=out["mask"].cpu()))
        try:
            with _dp_faults(faults, model), SmallStep._keep_mask(keep):
                rows = mesh_lib.local_rows(batch)
                torch.cuda.synchronize()
                _build.reset_launch_counts()
                _, met = step(state, rows)
                torch.cuda.synchronize()
                launches = dict(_build.LAUNCHES)
        finally:
            hook.remove()
            fused_sa.sa_extract, fused_sa.sa_fwd_step = orig
        return {"loss": float(met["total_loss"]),
                "grads": {k: g.cpu() for k, g in _grads(model).items()},
                "mask": seen["mask"],
                "stats": {k: v.detach().cpu().clone()
                          for k, v in model.named_buffers()},
                "launches": launches, "sums": sums}

    def times(self, steps=3):
        """(ms a step, ms a step in collectives): the wall time of
        `steps` steps after one untimed, and the collectives' time in one
        more step with the card synchronised around each."""
        import torch.distributed as dist

        from transferable3d_torch.core import bins as bins_lib
        from transferable3d_torch.parallel import mesh as mesh_lib
        from transferable3d_torch.train import train_loop

        model = self.model()
        state = self.state(model)
        # The dropout masks drawn on the card, as the drivers draw them
        # (a host generator draws 33.5M numbers a step at B=256).
        state.generator = torch.Generator(device=self.device).manual_seed(
            self.spec["keep_seed"])
        rows = mesh_lib.local_rows(self.spec["batch"])
        step = train_loop.make_train_step(bins_lib.SUNRGBD, self.lr,
                                          self.bn)
        step(state, rows)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            step(state, rows)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / steps
        spent = [0.0]

        def timed(fn):
            def wrapped(*a, **kw):
                torch.cuda.synchronize()
                t = time.perf_counter()
                out = fn(*a, **kw)
                torch.cuda.synchronize()
                spent[0] += time.perf_counter() - t
                return out
            return wrapped

        names = ("all_reduce", "broadcast", "all_gather", "reduce_scatter")
        orig = [getattr(dist, n) for n in names]
        for n, fn in zip(names, orig):
            setattr(dist, n, timed(fn))
        try:
            step(state, rows)
        finally:
            for n, fn in zip(names, orig):
                setattr(dist, n, fn)
        return ms, spent[0] * 1e3


# The runs of phase 30's rank processes for (a) and (b): the faults of
# each (none for the sound run, then the controls).
DP_RUNS = {"a": [(), ("local_bn",), ("local_denominators",)],
           "b": [(), ("local_bn",), ("local_denominators",),
                 ("dgamma_twice",)]}


def dp_rank(rank, init_method, tmp, world, specs):
    """A rank process of phase 30 (a, b): its mesh over every card, rank
    r on card r modulo their number (ranks that share a card: gloo; a
    card each: NCCL), every run of `DP_RUNS` and the times under it;
    rank 0 keeps the gradients, every rank its launches and K5-K7's
    sums."""
    from transferable3d_torch.parallel import mesh as mesh_lib
    from transferable3d_torch.train.train_sup import f32_numerics

    f32_numerics()  # as `main` sets them for the 1-rank steps
    mesh = mesh_lib.data_parallel_mesh(
        rank=rank, world_size=world, local_world_size=world,
        init_method=init_method)
    cards = torch.cuda.device_count()
    want = "gloo" if world > cards else "nccl"
    _check(mesh.backend == want, f"{world} ranks on {cards} card(s) "
           f"formed {mesh.backend}, not {want}")
    out = {}
    try:
        with mesh_lib.use(mesh):
            for tag, spec in specs.items():
                one = DPStep(spec, mesh.device)
                runs = []
                for faults in DP_RUNS[tag]:
                    r = one(faults)
                    if rank:
                        r = {"launches": r["launches"], "sums": r["sums"],
                             "loss": r["loss"]}
                    runs.append(r)
                out[tag] = {"runs": runs, "times": one.times()}
    finally:
        mesh_lib.destroy(mesh)
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))


def dp_nccl_rank(rank, init_method, tmp, spec):
    """Phase 30 (d): (a)'s step without a group and in a one-rank NCCL
    group on cuda:0, in one process."""
    from transferable3d_torch.parallel import mesh as mesh_lib
    from transferable3d_torch.train.train_sup import f32_numerics

    f32_numerics()
    step = DPStep(spec)
    alone = step()
    mesh = mesh_lib.data_parallel_mesh(
        ["cuda:0"], rank=0, world_size=1, init_method=init_method)
    try:
        with mesh_lib.use(mesh):
            grouped = step()
    finally:
        mesh_lib.destroy(mesh)
    same = (alone["loss"] == grouped["loss"]
            and all(torch.equal(alone[k][n], grouped[k][n])
                    for k in ("grads", "stats") for n in alone[k]))
    torch.save({"backend": mesh.backend, "same": same,
                "loss": (alone["loss"], grouped["loss"])},
               os.path.join(tmp, "nccl.pt"))


def _spawn(fn, nprocs, *args):
    """`fn(rank, init_method, tmp, *args)` in `nprocs` spawned processes
    (a `file://` rendezvous in `tmp`); returns `tmp`, where they leave
    their results. A rank that fails raises here."""
    import tempfile

    import torch.multiprocessing as mp

    tmp = tempfile.mkdtemp(prefix="t3d_dp_")
    init = "file://" + os.path.join(tmp, "rendezvous")
    mp.start_processes(fn, nprocs=nprocs, join=True, start_method="spawn",
                       args=(init, tmp, *args))
    return tmp


def dp_readings(ref, got, nets=("all", "seg_net", "tnet", "box_net")):
    """Phase 30's gaps of `got` from the 1-rank step `ref`; the gradient
    cosines of `nets` (module prefixes; "all": every parameter)."""
    out = {"loss": abs(got["loss"] - ref["loss"]) / abs(ref["loss"])}
    ga, gb = ref["grads"], got["grads"]
    for net in nets:
        ks = [k for k in ga if net == "all" or k.startswith(net + ".")]
        out[net] = _cos(torch.cat([ga[k].ravel() for k in ks]),
                        torch.cat([gb[k].ravel() for k in ks]))
    out["norm"] = float(
        torch.cat([gb[k].ravel() for k in ga]).double().norm()
        / torch.cat([ga[k].ravel() for k in ga]).double().norm())
    out["stats"] = max(
        float((got["stats"][k].float() - v.float()).abs().max()
              / v.float().abs().max().clamp_min(1e-30))
        for k, v in ref["stats"].items() if v.is_floating_point())
    fused = [k for k in ga if re.search(r"\.sa\d\.mlp(_\d)?\.bn_\d+\.", k)]
    if fused:
        out["fused_bn_norm"] = float(
            torch.cat([gb[k].ravel() for k in fused]).double().norm()
            / torch.cat([ga[k].ravel() for k in fused]).double().norm())
    return out


def dp_fails(r, limits):
    out = []
    for k, lim in limits.items():
        if isinstance(lim, tuple):
            bad = not lim[0] <= r[k] <= lim[1]
        elif k in ("loss", "stats", "box_cot"):
            bad = r[k] > lim
        else:
            bad = r[k] < lim
        if bad:
            out.append(k)
    return out


def dp_judge(what, limits, runs, controls, phase=30):
    """Every run and control with the limits it fails; every run (the
    witness among them) within the limits, every control outside one."""
    print(f"phase {phase} {what}; limits {limits}", flush=True)
    for tag, r in {**runs, **controls}.items():
        print(f"phase {phase}   {tag}: "
              + ", ".join(f"{k} {v:.5g}" for k, v in r.items())
              + f"; fails {dp_fails(r, limits) or 'no limit'}", flush=True)
    for tag, r in runs.items():
        _check(not dp_fails(r, limits), f"phase {phase} {what}: {tag} fails "
               f"{dp_fails(r, limits)}")
    for tag, r in controls.items():
        _check(bool(dp_fails(r, limits)), f"phase {phase} {what}: the "
               f"control {tag} passes every limit")


def data_parallel(args, dev, card: str):
    """Phase 30: data parallelism on two ranks of the one card."""
    with fused_sa_env(None):
        _data_parallel(args, dev, card)


def _dp_spec(name, batch, seed, dev):
    """A phase-30 spec: a fresh bf16 model from `seed` (on the host), the
    batch on the grid, the keep mask's seed and the foreground margin
    (1 + twice the largest logit gap of a train-mode forward)."""
    from transferable3d_torch.core import bins as bins_lib
    from transferable3d_torch.models import registry

    c = batch["points"].shape[-1]
    model = registry.get_model(
        name, bins_lib.SUNRGBD, dtype=torch.bfloat16, device="cpu",
        in_channels=c, generator=torch.Generator().manual_seed(seed))
    spec = {"name": name, "state_dict": model.state_dict(),
            "batch": _grid_batch(batch), "keep_seed": seed + 2}
    probe = DPStep(spec)
    m = probe.model().train()
    with SmallStep._keep_mask(probe.keep()), torch.no_grad():
        logits = m(torch.as_tensor(spec["batch"]["points"], device=dev),
                   torch.as_tensor(spec["batch"]["one_hot"], device=dev),
                   0.5, torch.Generator())["seg_logits"].float()
    spec["margin"] = 1.0 + 2.0 * float(
        (logits[..., 1] - logits[..., 0]).abs().max())
    return spec


def _dp_driver_runs(seed, tmp, tag, world):
    """(c): `train_sup.train` at config5 with `world` ranks, to
    DP_DRIVER_STEPS and resumed to DP_DRIVER_RESUME; then
    `train_semisup.train` at phase 25's configuration with `world` ranks.
    Returns both runs' log directories."""
    from transferable3d_torch.train import config as config_lib
    from transferable3d_torch.train import train_semisup, train_sup

    sup = os.path.join(tmp, f"{tag}_sup")
    cfg = dataclasses.replace(
        config_lib.PRESETS["config5_mesh_large_batch"], num_devices=world,
        synthetic_train=768, synthetic_val=256, eval_every_epochs=2,
        ckpt_every_epochs=2, max_steps=DP_DRIVER_STEPS, log_dir=sup,
        seed=seed)
    train_sup.train(cfg)
    train_sup.train(dataclasses.replace(cfg, max_steps=DP_DRIVER_RESUME))
    semi = os.path.join(tmp, f"{tag}_semi")
    train_semisup.train(dataclasses.replace(
        transfer_cfg(seed, semi), num_devices=world))
    return sup, semi


def _dp_files(log_dir):
    """Every file a run wrote, relative path -> contents: checkpoints
    loaded (a `torch.save` archive holds its file's name), the log's
    lines without their time stamps, rates and the run's own directory,
    other files' bytes. TensorBoard's files, named by host and time, are
    left out."""
    out = {}
    for root, _, files in os.walk(log_dir):
        for f in files:
            path = os.path.join(root, f)
            rel = os.path.relpath(path, log_dir)
            if f.startswith("events.out"):
                continue
            if f == "state.pt":
                out[rel] = torch.load(path, map_location="cpu",
                                      weights_only=False)
            elif f == "log_train.txt":
                with open(path) as fh:
                    out[rel] = [re.sub(r"\([\d.]+ frustums/s\)", "",
                                       line.split("] ", 1)[-1]).replace(
                                           log_dir, "<log_dir>")
                                for line in fh]
            else:
                with open(path, "rb") as fh:
                    out[rel] = fh.read()
    return out


def _same(a, b) -> bool:
    if torch.is_tensor(a):
        return torch.is_tensor(b) and torch.equal(a, b)
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(_same(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(_same(x, y) for x, y in zip(a, b)))
    return a == b


def _dp_sums(ref, rank_runs):
    """Phase 30 (b): K5-K7's statistics and the ranks.

    Split: each of the 1-rank step's 24 K5-K7 launches again on each
    rank's rows of its own arguments (the same pack): the halves' sums
    add up to the whole's within 1e-4 of the sums of their terms'
    magnitudes (sum |z|; sum z^2 itself), FusedChecks' gate for sums
    that cancel. Ranks: the sums the ranks' kernels returned, added,
    against the 1-rank step's: their z differ from it by bf16 roundings
    (the ranks' products run at other shapes in cuBLAS, and the
    statistics they normalise with are added in another order), so the
    limit is 3e-3 of the terms' magnitudes: the sound runs read 2.1e-4
    with two ranks on one card and 9.5e-4 with four on four, the runs
    with the BN statistics left per rank 2.5e-2 and 5.4e-2 (PERF.md
    section 6), and those must fail it."""
    _check(len(ref) == 3 * 8 and all(
        len(runs[0]["sums"]) == len(ref) for runs in rank_runs),
        "phase 30 (b): K5-K7 ran another number of times on a rank than "
        "on one")

    def gap(s, q, s1, q1, mag):
        return max(float(((s - s1).abs() / (mag + 1e-30)).max()),
                   float(((q - q1).abs() / (q1 + 1e-30)).max()))

    split = {"K5": 0.0, "K6/K7": 0.0}
    ranked = {name: {"K5": 0.0, "K6/K7": 0.0}
              for name in ("sound", "local_bn")}
    for i, (s1, q1, mag, fn, a, kw) in enumerate(ref):
        kind = "K5" if i % 3 == 0 else "K6/K7"
        cut = a[0].shape[0] // len(rank_runs)
        parts = []
        for r in range(len(rank_runs)):
            rows = slice(r * cut, (r + 1) * cut)
            sub = (tuple(x[rows].contiguous() for x in a[:4]) + a[4:]
                   if kind == "K5" else (a[0][rows].contiguous(),) + a[1:])
            out = fn(*sub, **kw)
            parts.append((out[1].cpu(), out[2].cpu()))
        split[kind] = max(split[kind], gap(sum(p[0] for p in parts),
                                           sum(p[1] for p in parts),
                                           s1, q1, mag))
        for name, run in (("sound", 0), ("local_bn", 1)):
            got = [runs[run]["sums"][i] for runs in rank_runs]
            ranked[name][kind] = max(ranked[name][kind], gap(
                sum(g[0] for g in got), sum(g[1] for g in got), s1, q1, mag))
    print("phase 30 (b) K5-K7 sums over the sums of their terms' "
          "magnitudes: the 1-rank step's launches split into the ranks' "
          "rows " + ", ".join(f"{k} {v:.3g}" for k, v in split.items())
          + " (limit 1e-4); the ranks' own, added, against the 1-rank "
          "step's " + ", ".join(f"{k} {v:.3g}" for k, v in
                                ranked["sound"].items())
          + ", with the BN statistics left per rank " + ", ".join(
              f"{k} {v:.3g}" for k, v in ranked["local_bn"].items())
          + " (limit 3e-3)", flush=True)
    _check(max(split.values()) <= 1e-4, "phase 30 (b): K5-K7's sums do "
           "not split over the ranks' rows")
    _check(max(ranked["sound"].values()) <= 3e-3, "phase 30 (b): the "
           "ranks' K5-K7 sums do not add up to the 1-rank step's")
    _check(max(ranked["local_bn"].values()) > 3e-3, "phase 30 (b): the "
           "control with per-rank BN statistics passes the sums' limit")


def _data_parallel(args, dev, card: str):
    import shutil
    import tempfile

    from transferable3d_torch.core import bins as bins_lib
    from transferable3d_torch.data import synthetic
    from transferable3d_torch.data.provider import FrustumDataset
    from transferable3d_torch.train import config as config_lib

    t0 = time.perf_counter()
    # The rank processes allocate on the same card: hand back the blocks
    # the earlier phases left in this process's caching allocator.
    torch.cuda.empty_cache()
    cfg5 = config_lib.PRESETS["config5_mesh_large_batch"]
    _check((cfg5.model, cfg5.compute_dtype, cfg5.num_point,
            cfg5.num_channels, cfg5.batch_size)
           == ("frustum_pointnets_v1", "bfloat16", N, 6, DP_V1_B),
           f"config5's widths changed: {cfg5}")
    sun = bins_lib.SUNRGBD
    recs = synthetic.make_dataset(DP_V1_B, sun, seed=args.seed,
                                  extra_channels=3)
    batch_a = FrustumDataset(recs, sun, npoints=N, rotate_to_center=True,
                             seed=args.seed).get_batch(list(range(DP_V1_B)))
    recs = synthetic.make_dataset(DP_V2_B, sun, seed=args.seed + 1,
                                  n_object=600, n_clutter=300)
    batch_b = FrustumDataset(recs, sun, npoints=N, rotate_to_center=True,
                             seed=args.seed).get_batch(list(range(DP_V2_B)))
    specs = {"a": _dp_spec("frustum_pointnets_v1", batch_a, args.seed, dev),
             "b": _dp_spec("frustum_pointnets_v2", batch_b, args.seed + 10,
                           dev)}
    one, witness, times1 = {}, {}, {}
    for tag, spec in specs.items():
        step = DPStep(spec)
        one[tag] = step(keep_args=tag == "b")
        b = len(spec["batch"]["points"])
        halves = np.r_[b // 2:b, 0:b // 2]
        witness[tag] = step(order=halves)
        times1[tag] = step.times()[0]
    world, cards = args.world, torch.cuda.device_count()
    where = (f"{world} ranks on {min(world, cards)} card(s), "
             + ("a card each (NCCL)" if world <= cards else "gloo"))
    tmp = _spawn(dp_rank, world, world, specs)
    ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                        weights_only=False) for r in range(world)]
    shutil.rmtree(tmp, ignore_errors=True)

    # (a) and (b): the step of the ranks against one rank's.
    for tag, limits, what in (
            ("a", DP_V1_LIMITS, f"(a) config5, v1 bf16, B={DP_V1_B} "
             f"({DP_V1_B // world} a rank), C=6, {where}"),
            ("b", DP_V2_LIMITS, f"(b) v2 bf16 fused, B={DP_V2_B} "
             f"({DP_V2_B // world} a rank), C=4, {where}")):
        runs = ranks[0][tag]["runs"]
        sound = runs[0]
        _check(bool(one[tag]["mask"].all()), f"phase 30 {tag}: the "
               "1-rank step's mask is not full (the margin did not pin it)")
        for r in range(world):
            _check(ranks[r][tag]["runs"][0]["loss"] == sound["loss"],
                   f"phase 30 {tag}: the ranks' losses differ")
        dp_judge(what, limits,
                 {f"{world} ranks vs 1 rank": dp_readings(one[tag], sound),
                  "witness: 1 rank on the batch's halves swapped":
                      dp_readings(one[tag], witness[tag])},
                 {f"control: {f[0]}": dp_readings(one[tag], run)
                  for f, run in zip(DP_RUNS[tag][1:], runs[1:])})

    # (b): launches a rank, and K5-K7's sums of the ranks added.
    want = {"fps": 4, **{k: 8 for k, _, _ in FUSED_KERNELS}}
    for r in range(world):
        _expect_launches(ranks[r]["b"]["runs"][0]["launches"], want)
    _expect_launches(one["b"]["launches"], want)
    _expect_launches(ranks[0]["a"]["runs"][0]["launches"], {})
    print(f"phase 30 launches a rank: (a) none, (b) "
          f"{ranks[0]['b']['runs'][0]['launches']}", flush=True)
    _dp_sums(one["b"]["sums"], [ranks[r]["b"]["runs"] for r in
                                 range(world)])

    # (d): a one-rank NCCL group, bit for bit.
    tmp = _spawn(dp_nccl_rank, 1, specs["a"])
    nccl = torch.load(os.path.join(tmp, "nccl.pt"), weights_only=False)
    shutil.rmtree(tmp, ignore_errors=True)
    print(f"phase 30 (d) one rank in a {nccl['backend']} group on cuda:0: "
          f"loss {nccl['loss'][1]:.6f} (without a group "
          f"{nccl['loss'][0]:.6f}), step bit-identical {nccl['same']}",
          flush=True)
    _check(nccl["backend"] == "nccl" and nccl["same"],
           "phase 30 (d): the one-rank NCCL step differs from the step "
           "without a group")

    for tag, name in (("a", "config5 v1 bf16 B=256"),
                      ("b", "v2 bf16 fused B=128")):
        ms2, coll = (ranks[0][tag]["times"][0], ranks[0][tag]["times"][1])
        print(f"times phase 30 {name}: {where}: {ms2:.1f} ms a step "
              f"(rank 0), of which collectives {coll:.1f} ms (the card "
              f"synchronised around each); 1 rank {times1[tag]:.1f} ms a "
              f"step {card}", flush=True)

    # (c): both drivers with `world` ranks, twice from one seed.
    tmp = tempfile.mkdtemp(prefix="t3d_dp_drivers_")
    t1 = time.perf_counter()
    runs = [_dp_driver_runs(args.seed, tmp, f"run{i}", world)
            for i in range(2)]
    t_drivers = time.perf_counter() - t1
    for which, i in (("train_sup", 0), ("train_semisup", 1)):
        files = [_dp_files(r[i]) for r in runs]
        log = files[0]["log_train.txt"]
        configs = sum(1 for line in log if "config: " in line)
        _check(configs == (2 if i == 0 else 1),
               f"phase 30 (c) {which}: {configs} config lines in the log "
               "(a rank other than 0 wrote)")
        stray = [p for p in files[0] if ".tmp-" in p]
        _check(not stray, f"phase 30 (c) {which}: stray files {stray}")
        same = _same(*files)
        print(f"phase 30 (c) {which} with num_devices={world}, twice: "
              f"{len(files[0])} files ({sorted(files[0])[:6]} ...), "
              f"bit-identical {same}", flush=True)
        _check(same, f"phase 30 (c): {which}'s two runs from one seed "
               "differ")
    sup = _dp_files(runs[0][0])
    _check(os.path.join("ckpt", str(DP_DRIVER_RESUME), "state.pt") in sup,
           f"phase 30 (c): no checkpoint at step {DP_DRIVER_RESUME}")
    _check(any(f"resumed from step {DP_DRIVER_STEPS}" in line
               for line in sup["log_train.txt"]),
           "phase 30 (c): the driver did not resume")
    if 1 < world <= cards:
        # Ranks on cards of their own: the driver's rate beside one
        # card's on the same configuration (a reading, no gate).
        from transferable3d_torch.train import train_sup

        solo = os.path.join(tmp, "one_rank")
        train_sup.train(dataclasses.replace(
            config_lib.PRESETS["config5_mesh_large_batch"],
            synthetic_train=768, synthetic_val=256, eval_every_epochs=2,
            ckpt_every_epochs=2, max_steps=DP_DRIVER_STEPS, log_dir=solo,
            seed=args.seed, num_devices=1))
        rates = {}
        for tag, path in ((f"{world} ranks", runs[0][0]), ("1 rank", solo)):
            with open(os.path.join(path, "log_train.txt")) as f:
                rates[tag] = [float(r) for r in re.findall(
                    r"\(([0-9.]+) frustums/s\)", f.read())][:4]
        print(f"times phase 30 config5 driver, train frustums/s by epoch "
              f"from its log (its first {DP_DRIVER_STEPS} steps): "
              + "; ".join(f"{k} {v}" for k, v in rates.items())
              + f" {card}", flush=True)
    shutil.rmtree(tmp, ignore_errors=True)
    print(f"phase 30 data parallel: {time.perf_counter() - t0:.1f} s "
          f"(drivers {t_drivers:.1f} s) {card}", flush=True)


# Phase 31: points-axis sharding (`data_points_mesh`), D x P ranks on the
# one card over gloo (a card each over NCCL where the machine has as many
# cards): (a) (a)'s step of phase 30 on (2, 2); (b) (b)'s on (1, 2) and
# (2, 2); (c) a v2 predict step on (1, 2). The runs of (a) and (b): the
# sound step, then the controls (`_dp_faults`).
PP_RUNS = [(), ("local_pool",), ("local_bn",), ("local_masking",),
           ("box_grads_everywhere",)]
PP_V1_LIMITS = DP_V1_LIMITS
PP_V2_LIMITS = {**DP_V2_LIMITS, "norm": (0.9, 1.1)}


def _pp_predict_spec(seed, dev):
    """(c): a v2 bf16 model from `seed` with its BN running statistics
    perturbed and its foreground logit shifted so that about half the
    points are masked (as phase 3), and B seeded frustums."""
    from transferable3d_torch.core import bins as bins_lib
    from transferable3d_torch.models import registry

    gen = torch.Generator().manual_seed(seed)
    model = registry.get_model("frustum_pointnets_v2", bins_lib.SUNRGBD,
                               dtype=torch.bfloat16, device="cpu",
                               generator=gen).eval()
    _perturb_bn(model, gen)
    batch = SyntheticFrustums(B, bins_lib.SUNRGBD, seed).get_batch(
        list(range(B)))
    card = copy.deepcopy(model).to(dev)
    with torch.no_grad():
        logits = card.seg_net(torch.as_tensor(batch["points"], device=dev),
                              torch.as_tensor(batch["one_hot"], device=dev))
        gap = (logits[..., 1] - logits[..., 0]).float().cpu()
        model.seg_net.seg_out.bias[1] -= gap.median()
    return {"state_dict": model.state_dict(), "batch": batch,
            "pin": 1.0 + 4.0 * float(gap.abs().max())}


def pp_predict(spec, device, faults=(), capture=None, pinned=False):
    """(c): `make_predict_step` of the spec's model on `device`, on this
    rank's block of the current mesh (none: the whole batch), with the
    counters zeroed just before it; `pinned`: the foreground logit raised
    by the spec's `pin`, so every point is masked. Returns the detections,
    the rank's seg logits and the whole frustums' masks on the host, the
    launches and (sound and unpinned) the step's ms after one untimed
    call."""
    from transferable3d_torch.core import bins as bins_lib
    from transferable3d_torch.models import registry
    from transferable3d_torch.ops import _build
    from transferable3d_torch.parallel import mesh as mesh_lib
    from transferable3d_torch.train import train_loop

    model = registry.get_model("frustum_pointnets_v2", bins_lib.SUNRGBD,
                               dtype=torch.bfloat16, device=device)
    model.load_state_dict(spec["state_dict"])
    if pinned:
        with torch.no_grad():
            model.seg_net.seg_out.bias[1] += spec["pin"]
    predict = train_loop.make_predict_step(model, bins_lib.SUNRGBD)
    rows = mesh_lib.local_rows(spec["batch"])
    seen = {}
    hook = model.register_forward_hook(lambda mod, a, out: seen.update(
        logits=out["seg_logits"].float().cpu(), mask=out["mask"].cpu()))
    with _dp_faults(faults, model):
        if capture:
            capture(0, ())
        try:
            torch.cuda.synchronize()
            _build.reset_launch_counts()
            out = predict(rows)
            torch.cuda.synchronize()
            launches = dict(_build.LAUNCHES)
        finally:
            hook.remove()
            if capture:
                capture(0, None)
    timed = not faults and not pinned and capture is None
    return {"dets": {k: v.cpu() for k, v in out.items()}, **seen,
            "launches": launches,
            "ms": _time_ms(lambda: predict(rows), 1, 5) if timed else None}


def pp_rank(rank, init_method, tmp, stages):
    """A rank process of phase 31. For each stage (world, points, jobs,
    check_kernels) that it belongs to (rank < world), in turn: its
    (world / points, points) mesh over every card (ranks that share a
    card: gloo; a card each: NCCL), then for each job the train step's
    runs of `PP_RUNS` and their times, or the predict step sound, with a
    per-shard pool and with every point masked (`pp_predict`). The last
    rank of a stage keeps every run; the others their launches, losses
    and the sound run's gradients. With `check_kernels`, the last rank
    also holds K1, K5-K9 of one more sound train step and K1, K2 of one
    predict step, at its own shapes, to their plain twins
    (`_study_kernels`). One set of processes serves every stage: a
    process reaches the card once."""
    from transferable3d_torch.train.train_sup import f32_numerics

    f32_numerics()  # as `main` sets them for the 1-rank steps
    outs = []
    for i, (world, points, jobs, check) in enumerate(stages):
        if rank >= world:
            break
        outs.append(_pp_stage(rank, f"{init_method}-{i}", world, points,
                              jobs, check))
    torch.save(outs, os.path.join(tmp, f"rank{rank}.pt"))


def _pp_stage(rank, init_method, world, points, jobs, check_kernels):
    from transferable3d_torch.models import pointnet2
    from transferable3d_torch.ops import fused_sa
    from transferable3d_torch.parallel import mesh as mesh_lib

    mesh = mesh_lib.data_points_mesh(
        world // points, points, rank=rank, world_size=world,
        local_world_size=world, init_method=init_method)
    cards = torch.cuda.device_count()
    want = "gloo" if world > cards else "nccl"
    _check(mesh.backend == want, f"{world} ranks on {cards} card(s) "
           f"formed {mesh.backend}, not {want}")
    last = rank == world - 1
    out, t0 = {"seconds": {}}, time.perf_counter()
    try:
        with mesh_lib.use(mesh):
            for tag, (kind, spec) in jobs.items():
                out["seconds"][tag] = time.perf_counter() - t0
                if kind == "predict":
                    out[tag] = [pp_predict(spec, mesh.device),
                                pp_predict(spec, mesh.device,
                                           ("local_pool",)),
                                pp_predict(spec, mesh.device, pinned=True)]
                    continue
                one = DPStep(spec, mesh.device)
                runs = []
                for faults in PP_RUNS:
                    r = one(faults)
                    if not last:
                        r = {"launches": r["launches"], "loss": r["loss"],
                             **({} if faults else {"grads": r["grads"]})}
                    runs.append(r)
                out[tag] = {"runs": runs, "times": one.times(steps=2)}
            out["seconds"]["end"] = time.perf_counter() - t0
            if check_kernels:
                step_cap = _Capture(0, (
                    (pointnet2, "farthest_point_sample"),
                    (fused_sa, "sa_extract_cuda"),
                    (fused_sa, "sa_fwd_step_cuda"),
                    (fused_sa, "sa_bwd_step_cuda"),
                    (fused_sa, "sa_bwd_step0_cuda")))
                eval_cap = _Capture(0, (
                    (pointnet2, "farthest_point_sample"),
                    (fused_sa, "sa_infer")))
                train_spec = next(sp for k, sp in jobs.values()
                                  if k == "train" and "v2" in sp["name"])
                step_cap(0, ())
                try:
                    launches = DPStep(train_spec, mesh.device)()["launches"]
                finally:
                    step_cap(0, None)
                pp_predict(next(sp for k, sp in jobs.values()
                                if k == "predict"), mesh.device,
                           capture=eval_cap)
                if last:
                    _study_kernels(step_cap, eval_cap, launches, phase=31)
                out["seconds"]["kernels"] = time.perf_counter() - t0
    finally:
        mesh_lib.destroy(mesh)
    return out


# (c)'s limits against the 1-rank step. The seg logits: the share that
# is the same bits, and max |diff| over max |logit| (phase 5's limit
# between the card and the CPU): a product at another shape rounds a
# bf16 step otherwise here and there, and where that moves a frustum's
# global max-pool every logit of the frustum moves (the card's first
# readings: the ranks 0.9585 and 2.3-2.7e-2, the witness in two calls of
# B / 2 the same, a per-shard pool 0.0000 and 3.2-3.4e-2). The masks:
# the share of points that agree (0.99982; a per-shard pool 0.9931).
PP_PREDICT_LIMITS = {"logits_same": 0.9, "logits": 0.03, "mask_agree": 0.999,
                     "seg_conf": 0.01}


def pp_predict_gate(ref, got, p, points, box_stages=True):
    """(c)'s gate on rank p of the points axis against the 1-rank step
    (`PP_PREDICT_LIMITS`): its seg logits against the 1-rank step's at its
    point slice, the whole frustums' masks, `seg_conf` (a mean of the seg
    probabilities) and, with `box_stages` (off for a witness whose box
    stages run at other shapes), every other detection of a frustum whose
    mask is the 1-rank step's bit-identical: the box stages see the same
    object points at the same shapes. Returns the failing checks and the
    readings."""
    n = ref["logits"].shape[1] // points
    lr = ref["logits"][:, p * n:(p + 1) * n]
    conf = ref["dets"]["seg_conf"]
    same = (got["mask"] == ref["mask"]).all(dim=1)
    read = {"logits_same": float((got["logits"] == lr).float().mean()),
            "logits": float((got["logits"] - lr).abs().max()
                            / lr.abs().max()),
            "mask_agree": float((got["mask"] == ref["mask"]).float().mean()),
            "seg_conf": float((got["dets"]["seg_conf"] - conf).abs().max()
                              / conf.abs().max()),
            "frustums_same_mask": int(same.sum()),
            "dets_differ": [k for k, v in ref["dets"].items()
                            if k != "seg_conf" and not torch.equal(
                                got["dets"][k][same], v[same])]}
    lim = PP_PREDICT_LIMITS
    bad = [k for k in lim if (read[k] < lim[k] if k in ("logits_same",
                                                        "mask_agree")
                              else read[k] > lim[k])]
    if box_stages and (read["dets_differ"] or not same.any()):
        bad.append("dets")
    return bad, read


def points_parallel(args, dev, card: str):
    """Phase 31: points-axis sharding on the one card."""
    with fused_sa_env(None):
        _points_parallel(args, dev, card)


def _points_parallel(args, dev, card: str):
    import shutil

    from transferable3d_torch.core import bins as bins_lib
    from transferable3d_torch.data import synthetic
    from transferable3d_torch.data.provider import FrustumDataset

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    sun = bins_lib.SUNRGBD
    recs = synthetic.make_dataset(DP_V1_B, sun, seed=args.seed,
                                  extra_channels=3)
    batch_a = FrustumDataset(recs, sun, npoints=N, rotate_to_center=True,
                             seed=args.seed).get_batch(list(range(DP_V1_B)))
    recs = synthetic.make_dataset(DP_V2_B, sun, seed=args.seed + 1,
                                  n_object=600, n_clutter=300)
    batch_b = FrustumDataset(recs, sun, npoints=N, rotate_to_center=True,
                             seed=args.seed).get_batch(list(range(DP_V2_B)))
    specs = {"a": _dp_spec("frustum_pointnets_v1", batch_a, args.seed, dev),
             "b": _dp_spec("frustum_pointnets_v2", batch_b, args.seed + 10,
                           dev),
             "c": _pp_predict_spec(args.seed + 20, dev)}
    one, witness, times1 = {}, {}, {}
    for tag in ("a", "b"):
        step = DPStep(specs[tag])
        one[tag] = step()
        b = len(specs[tag]["batch"]["points"])
        witness[tag] = step(order=np.r_[b // 2:b, 0:b // 2])
        times1[tag] = step.times()
    one["c"] = pp_predict(specs["c"], dev)
    one["c pinned"] = pp_predict(specs["c"], dev, pinned=True)
    print(f"phase 31 one rank's steps: {time.perf_counter() - t0:.1f} s",
          flush=True)
    cards = torch.cuda.device_count()
    stages = [(4, 2, {"a": ("train", specs["a"]), "b": ("train", specs["b"])},
               False),
              (2, 2, {"b": ("train", specs["b"]),
                      "c": ("predict", specs["c"])}, True)]
    t1 = time.perf_counter()
    tmp = _spawn(pp_rank, 4, stages)
    outs = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
            for r in range(4)]
    shutil.rmtree(tmp, ignore_errors=True)
    meshes = {}
    for i, (world, points, jobs, check) in enumerate(stages):
        meshes[(world // points, points)] = [outs[r][i] for r in range(world)]
        also = ", the kernels against their twins" if check else ""
        print(f"phase 31 the ({world // points}, {points}) mesh "
              f"({sorted(jobs)}{also}): the last rank's seconds after "
              "forming it: " + ", ".join(
                  f"{k} {v:.1f}" for k, v in outs[world - 1][i][
                      "seconds"].items()), flush=True)
    print(f"phase 31 the ranks' processes: {time.perf_counter() - t1:.1f} s",
          flush=True)

    def where(world):
        return (f"{world} ranks on {min(world, cards)} card(s), "
                + ("a card each (NCCL)" if world <= cards else "gloo"))

    # (a), (b): the step of the ranks against one rank's.
    for tag, shape, limits, what in (
            ("a", (2, 2), PP_V1_LIMITS, f"(a) config5, v1 bf16, "
             f"B={DP_V1_B}, C=6"),
            ("b", (1, 2), PP_V2_LIMITS, f"(b) v2 bf16 fused, B={DP_V2_B}, "
             "C=4"),
            ("b", (2, 2), PP_V2_LIMITS, f"(b) v2 bf16 fused, B={DP_V2_B}, "
             "C=4")):
        ranks = meshes[shape]
        world = len(ranks)
        runs = ranks[-1][tag]["runs"]
        _check(bool(one[tag]["mask"].all()), f"phase 31 {tag}: the 1-rank "
               "step's mask is not full (the margin did not pin it)")
        _check(bool(runs[0]["mask"].all()), f"phase 31 {tag} {shape}: the "
               "whole frustum's mask is not full")
        for r in range(world):
            _check(ranks[r][tag]["runs"][0]["loss"] == runs[0]["loss"],
                   f"phase 31 {tag} {shape}: the ranks' losses differ")
            same = all(torch.equal(g, runs[0]["grads"][k]) for k, g in
                       ranks[r][tag]["runs"][0]["grads"].items())
            _check(same, f"phase 31 {tag} {shape}: rank {r} holds another "
                   "gradient than the last rank")
        dp_judge(f"{what} on a {shape} mesh, {where(world)}", limits,
                 {f"{shape} vs 1 rank": dp_readings(one[tag], runs[0]),
                  "witness: 1 rank on the batch's halves swapped":
                      dp_readings(one[tag], witness[tag])},
                 {f"control: {f[0]}": dp_readings(one[tag], run)
                  for f, run in zip(PP_RUNS[1:], runs[1:])}, phase=31)
        want = {} if tag == "a" else {
            "fps": 4, **{k: 8 for k, _, _ in FUSED_KERNELS}}
        for r in range(world):
            _expect_launches(ranks[r][tag]["runs"][0]["launches"], want)
        ms, coll = ranks[0][tag]["times"]
        print(f"times phase 31 {what} on a {shape} mesh, {where(world)}: "
              f"{ms:.1f} ms a step (rank 0), of which collectives "
              f"{coll:.1f} ms (the card synchronised around each); 1 rank "
              f"{times1[tag][0]:.1f} ms a step {card}", flush=True)
    _expect_launches(one["b"]["launches"], {"fps": 4, **{
        k: 8 for k, _, _ in FUSED_KERNELS}})

    # (c): the predict step on (1, 2) against one rank's: half the points
    # masked (phase 3's setting), then every point; the witness is one
    # rank on the batch in two calls of B / 2 (other product shapes).
    ranks = meshes[(1, 2)]
    _expect_launches(one["c"]["launches"], {"fps": 4, "sa_infer": 8})
    _check(bool(one["c pinned"]["mask"].all()), "phase 31 (c): the pinned "
           "1-rank step's mask is not full")
    halves = [pp_predict({**specs["c"], "batch": {
        k: v[i * B // 2:(i + 1) * B // 2] for k, v in
        specs["c"]["batch"].items()}}, dev) for i in range(2)]
    witness = {"dets": {k: torch.cat([h["dets"][k] for h in halves])
                        for k in one["c"]["dets"]},
               **{k: torch.cat([h[k] for h in halves])
                  for k in ("logits", "mask")}}
    results = []
    for r, res in enumerate(ranks):
        sound, local, pinned = res["c"]
        for run in (sound, pinned):
            _expect_launches(run["launches"], {"fps": 4, "sa_infer": 8})
        for what, ref, got, control in (
                ("half the points masked", one["c"], sound, False),
                ("control local_pool", one["c"], local, True),
                ("every point masked", one["c pinned"], pinned, False)):
            results.append((f"rank {r}, {what}", control,
                            *pp_predict_gate(ref, got, r, len(ranks))))
    results.append(("witness: 1 rank in two calls of B / 2 (its box "
                    "stages at B / 2)", False,
                    *pp_predict_gate(one["c"], witness, 0, 1, False)))
    print(f"phase 31 (c) limits {PP_PREDICT_LIMITS}", flush=True)
    for what, control, bad, read in results:
        print(f"phase 31 (c) v2 predict B={B} vs 1 rank, {what}: seg "
              f"logits max|diff|/max {read['logits']:.4g} (bit-identical "
              f"{read['logits_same']:.4f}), masks agree "
              f"{read['mask_agree']:.5f}, {read['frustums_same_mask']} of "
              f"{B} frustums with the same mask, their detections differ "
              f"in {read['dets_differ']}, seg_conf {read['seg_conf']:.3g}; "
              f"fails {bad}", flush=True)
    for what, control, bad, read in results:
        _check(bool(bad) == control, f"phase 31 (c) {what}: "
               + (f"fails {bad}" if bad else "passes the gate"))
        if what.endswith("every point masked"):
            _check(read["frustums_same_mask"] == B, f"phase 31 (c) {what}: "
                   "the masks are not the 1-rank step's")
    print(f"times phase 31 (c) v2 predict B={B} on a (1, 2) mesh, "
          f"{where(2)}: {ranks[0]['c'][0]['ms']:.1f} ms a step (rank 0); "
          f"1 rank {one['c']['ms']:.1f} ms {card}", flush=True)
    print(f"phase 31 points parallel: {time.perf_counter() - t0:.1f} s "
          f"{card}", flush=True)


# Phase 32: the rest of the points mesh, D x P ranks on the one card over
# gloo (a card each over NCCL where the machine has as many): (a) the
# BoxPC step at config 4's widths, (b) the phase-B step through phase
# 25's model (v2 bf16 fused) at config 4's widths, each on (1, 2) and
# (2, 2), (c) `BoxEstimationOnly` at config 1's widths on (2, 2), and a
# v1 bf16 step at a large N on (1, 4). The runs of (a)-(c): the sound
# step, then the controls (`_dp_faults`).
PT_B = 32
PT_RUNS = {"a": [(), ("local_pool",), ("local_bn",)],
           "b": [(), ("local_pool",), ("local_bn",),
                 ("box_cotangent_unsummed",)],
           "c": [(), ("local_pool",), ("local_bn",)]}
# The large N: v1 bf16, B=32, C=6, N points a frustum, (1, 4): a rank
# holds N / 4 points a frustum.
PT_LARGE_N = 16384
# Each kind's nets (module prefixes; "all" the whole gradient).
PT_NETS = {"a": ("all", "mlp", "head"),
           "b": ("all", "seg_net", "tnet", "box_net"),
           "c": ("all", "box_net.mlp", "box_net.head")}
# Limits of the points mesh's step against the 1-rank step (set from the
# card's readings, PERF.md section 6): the loss (relative), the gradient
# cosines of the whole model and of each net, the BN buffers and the
# whole gradient's norm. (a) and (c) are float32: their sound runs and
# witnesses read cosines of 1 to 5 digits, losses within 3e-7, buffers
# within 6e-6 (an NVIDIA H100 80GB HBM3 at 700 W), the controls cosines
# of 0.18-0.97. (b) is bf16, and the weak losses, through an untrained
# BoxPC whose gradient in the box routes through near-tied maxima, move
# with every bf16 rounding of the predicted box: the card read (2, 2)
# all 0.933, T-Net 0.727, box net 0.944, norm 0.950, the witness 0.972,
# 0.752, 0.984, 0.964, below phase 31's (b) (the float32 phase-B step of
# v2 on (2, 2) matches one rank to a loss gap of 4e-7 on the CPU,
# tests/test_torch_points_transfer.py). Its seg net (0.9955 sound,
# 0.85-0.88 the controls) and buffers (4e-3 sound, 0.16-0.38 the
# controls) tell the controls apart; the rest bounds the chaos.
PT_LIMITS = {
    "a": {"loss": 1e-5, "all": 0.99999, "mlp": 0.99999, "head": 0.99999,
          "stats": 1e-4, "norm": (1 - 1e-4, 1 + 1e-4)},
    "b": {"loss": 0.02, "all": 0.85, "seg_net": 0.985, "tnet": 0.5,
          "box_net": 0.85, "stats": 5e-2, "fused_bn_norm": (0.9, 1.1),
          "norm": (0.9, 1.1)},
    "c": {"loss": 1e-5, "all": 0.99999, "box_net.mlp": 0.99999,
          "box_net.head": 0.99999, "stats": 1e-4,
          "norm": (1 - 1e-4, 1 + 1e-4)}}
# (b) on (1, 2), where the box stages see the 1-rank step's exact inputs:
# the cotangent of the predicted box from the weak losses (`box_cot`,
# relative L2 on the rank's rows; the card read 8.2e-8, the witness
# 2.2e-8, the share left unsummed 0.66). On (2, 2) the bf16 box stages
# differ from one rank's by more than a missing share moves it (0.34
# sound, 0.19 the witness), so it is read there and not judged.
PT_BOX_LIMITS = {"box_cot": 1e-3}
# The weak losses' trust gate held open (its thresholds far beyond a
# random BoxPC's deltas), so that the fit and refine terms reach the
# detector through BoxPC on every frustum.
PT_OPEN_GATE = dict(trust_center=10.0, trust_size=10.0, trust_heading=10.0,
                    trust_prior_logsize=10.0)


@contextlib.contextmanager
def _keep_masks(masks):
    """`layers.dropout_keep_mask` returns `masks` (whole-batch masks) in
    turn; every one must be drawn."""
    from transferable3d_torch.models import layers

    queue = list(masks)
    orig = layers.dropout_keep_mask
    layers.dropout_keep_mask = lambda shape, rate, gen: queue.pop(0)
    try:
        yield
    finally:
        layers.dropout_keep_mask = orig
    _check(not queue, "phase 32: a keep mask was not drawn")


@contextlib.contextmanager
def _box_cotangent(out):
    """`out["cotangent"]`: the cotangent [rows, 7] of the predicted box
    (center, size, heading) that the weak losses read, on the host, once
    the step's backward has run."""
    from transferable3d_torch.train import semisup

    orig, parts = semisup.differentiable_box, {}

    def hooked(*a, **kw):
        box = orig(*a, **kw)
        for i, t in enumerate(box):
            t.register_hook(lambda g, i=i: parts.__setitem__(i, g))
        return box
    semisup.differentiable_box = hooked
    try:
        yield
    finally:
        semisup.differentiable_box = orig
    out["cotangent"] = torch.cat([parts[0], parts[1], parts[2][:, None]],
                                 dim=1).float().cpu()


@contextlib.contextmanager
def _weak_points_in(order):
    """The weak losses read each weak frustum's points in `order` (a
    no-op without one): they are a function of the frustum's point set,
    so only their sums over points change order."""
    from transferable3d_torch.train import semisup

    if order is None:
        yield
        return
    orig = semisup.weak_losses

    def weak_losses(end_points, batch, *a, **kw):
        idx = torch.as_tensor(order, device=batch["points"].device)
        return orig(end_points, {**batch, "points": batch["points"][:, idx]},
                    *a, **kw)
    semisup.weak_losses = weak_losses
    try:
        yield
    finally:
        semisup.weak_losses = orig


class PTStep:
    """One step of phase 32 on `device` (default cuda:0) from a spec: kind
    "a" (`make_boxpc_train_step` of a float32 BoxPC), "b"
    (`make_semisup_train_step` of a detector with a frozen BoxPC) or "c"
    (`make_train_step` of `BoxEstimationOnly`, float32), on this rank's
    block of the current mesh (none: one rank, the whole batch), the
    frustums in `order` and their points in `points_order`, with the
    counters zeroed just before it. (b)'s batches lie on the 1/256 grid,
    its foreground logit is raised by the margin and its box net's input
    snapped (`_snap_to_grid`), its dropout masks drawn once and
    injected; (a) draws from a CPU generator of one seed on every rank."""

    def __init__(self, spec, device=None):
        self.spec, self.device = spec, device or "cuda:0"

    def models(self):
        from transferable3d_torch.core import bins as bins_lib
        from transferable3d_torch.models import registry

        s, sun = self.spec, bins_lib.SUNRGBD
        if s["kind"] == "a":
            m = registry.get_model("boxpc_fit", sun, device=self.device)
            m.load_state_dict(s["state_dict"])
            return m, None
        kw = ({} if s["name"] == "box_estimation_v1" else
              dict(in_channels=s["batch"]["points"].shape[-1]))
        m = registry.get_model(s["name"], sun, dtype=s["dtype"],
                               device=self.device, **kw)
        m.load_state_dict(s["state_dict"])
        if s["kind"] == "c":
            return m, None
        with torch.no_grad():
            m.seg_net.seg_out.bias[1] += s["margin"]
        m.box_net.register_forward_pre_hook(_snap_to_grid)
        bp = registry.get_model("boxpc_fit", sun, device=self.device)
        bp.load_state_dict(s["boxpc"])
        return m, bp

    def step(self, model, boxpc):
        """(step, state, the metric that is the step's loss)."""
        from transferable3d_torch.core import bins as bins_lib
        from transferable3d_torch.train import schedules, semisup, train_loop

        s, sun = self.spec, bins_lib.SUNRGBD
        b = len(s["batch"]["points"])
        lr = schedules.exponential_staircase_lr(base_lr=1e-3, batch_size=b)
        bn = schedules.bn_momentum_schedule(batch_size=b)
        gen = torch.Generator().manual_seed(s["seed"])
        state = train_loop.create_train_state(
            model, train_loop.make_optimizer(lr), generator=gen)
        if s["kind"] == "a":
            return (semisup.make_boxpc_train_step(sun, bn,
                                                  aniso_aug=s["aniso"]),
                    state, "total_loss")
        if s["kind"] == "c":
            return train_loop.make_train_step(sun, lr, bn), state, \
                "total_loss"
        return (semisup.make_semisup_train_step(
            sun, lr, bn, weights=semisup.WeakLossWeights(**PT_OPEN_GATE)),
            semisup.SemisupState(state, boxpc), "combined_loss")

    def batches(self, order=None, points_order=None):
        s = self.spec
        out = [s["batch"]] + ([s["weak"]] if s["kind"] == "b" else [])
        keep = list(s.get("keep", ()))
        if order is not None:
            out = [{k: v[order] for k, v in b.items()} for b in out]
            keep = [m[torch.from_numpy(order)] for m in keep]
        if points_order is not None:
            out = [{k: v[:, points_order] if k in ("points", "seg") else v
                    for k, v in b.items()} for b in out]
            keep = [m[:, torch.from_numpy(points_order)] for m in keep]
        return out, keep

    def __call__(self, faults=(), order=None, points_order=None,
                 weak_points_order=None):
        """`weak_points_order`: (b)'s weak losses read each weak frustum's
        points in that order (the detector the batch's)."""
        from transferable3d_torch.ops import _build
        from transferable3d_torch.parallel import mesh as mesh_lib

        model, boxpc = self.models()
        step, state, key = self.step(model, boxpc)
        batches, keep = self.batches(order, points_order)
        box = {}
        with contextlib.ExitStack() as stack:
            stack.enter_context(_dp_faults(faults, model))
            if boxpc is not None:  # (b): its masks, the box's cotangent
                stack.enter_context(_keep_masks(keep))
                stack.enter_context(_box_cotangent(box))
                stack.enter_context(_weak_points_in(weak_points_order))
            rows = [mesh_lib.local_rows(b) for b in batches]
            torch.cuda.synchronize()
            _build.reset_launch_counts()
            _, met = step(state, *rows)
            torch.cuda.synchronize()
            launches = dict(_build.LAUNCHES)
        return {"loss": float(met[key]),
                "grads": {k: g.cpu() for k, g in _grads(model).items()},
                "stats": {k: v.detach().cpu().clone()
                          for k, v in model.named_buffers()},
                "launches": launches, "box_cot": box.get("cotangent")}

    def times(self, steps=2):
        """ms a step: the wall time of `steps` steps after one untimed."""
        from transferable3d_torch.parallel import mesh as mesh_lib

        model, boxpc = self.models()
        step, state, _ = self.step(model, boxpc)
        rows = [mesh_lib.local_rows(b) for b in self.batches()[0]]
        if self.spec["kind"] == "b":  # the masks drawn on the card
            state.detector.generator = torch.Generator(
                device=self.device).manual_seed(self.spec["seed"])
        step(state, *rows)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            step(state, *rows)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / steps


def pt_readings(ref, got, nets, rows=slice(None), order=None):
    """`dp_readings` over `nets` (module prefixes; "all": every
    parameter), and in (b) `box_cot`: the relative L2 gap of the predicted
    box's cotangent on `got`'s rows (`rows` of `ref`'s; `order`: `got`
    ran on the frustums in that order)."""
    out = dp_readings(ref, got, nets)
    if ref.get("box_cot") is not None:
        want, have = ref["box_cot"][rows], got["box_cot"]
        if order is not None:
            have = have[torch.from_numpy(np.argsort(order))]
        out["box_cot"] = float((have - want).norm() / want.norm())
    return out


def _pt_large(spec, device=None, whole=True):
    """The large-N step on this rank: its result (without `whole`, only
    its loss and launches), its step's ms (one untimed step first) and
    its peak device memory above what the process held before it."""
    step = DPStep(spec, device)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    res = step()
    peak = torch.cuda.max_memory_allocated() - before
    ms = step.times(steps=1)[0]
    if not whole:
        res = {"loss": res["loss"], "launches": res["launches"]}
    return {**res, "ms": ms, "peak_gib": peak / 2 ** 30}


def pt_rank(rank, init_method, tmp, stages):
    """A rank process of phase 32. For each stage (world, points, jobs,
    check_kernels) that it belongs to, in turn: its (world / points,
    points) mesh over every card (ranks that share a card: gloo; a card
    each: NCCL; None for a stage it is not in), then for each job the
    runs of `PT_RUNS` and the step's
    ms, or (job "large") the large-N step with its peak memory. The last
    rank keeps every run; the others the sound run's loss, gradient and
    launches and the controls' losses and launches. With
    `check_kernels`, the last rank also holds K1, K5-K9 of one more
    sound (b) step and K1, K2 of a predict step of (b)'s detector on its
    weak block, at its own shapes, to their plain twins
    (`_study_kernels`)."""
    from transferable3d_torch.train.train_sup import f32_numerics

    f32_numerics()  # as `main` sets them for the 1-rank steps
    outs = [_pt_stage(rank, f"{init_method}-{i}", world, points, jobs, check)
            if rank < world else None
            for i, (world, points, jobs, check) in enumerate(stages)]
    torch.save(outs, os.path.join(tmp, f"rank{rank}.pt"))


def _pt_stage(rank, init_method, world, points, jobs, check_kernels):
    from transferable3d_torch.core import bins as bins_lib
    from transferable3d_torch.models import pointnet2
    from transferable3d_torch.ops import fused_sa
    from transferable3d_torch.parallel import mesh as mesh_lib
    from transferable3d_torch.train import train_loop

    mesh = mesh_lib.data_points_mesh(
        world // points, points, rank=rank, world_size=world,
        local_world_size=world, init_method=init_method)
    cards = torch.cuda.device_count()
    want = "gloo" if world > cards else "nccl"
    _check(mesh.backend == want, f"{world} ranks on {cards} card(s) "
           f"formed {mesh.backend}, not {want}")
    last = rank == world - 1
    out, t0 = {"seconds": {}}, time.perf_counter()
    try:
        with mesh_lib.use(mesh):
            for tag, spec in jobs.items():
                out["seconds"][tag] = time.perf_counter() - t0
                if tag == "large":
                    out[tag] = _pt_large(spec, mesh.device, last)
                    continue
                one = PTStep(spec, mesh.device)
                runs = []
                for faults in PT_RUNS[tag]:
                    r = one(faults)
                    if not last:
                        r = {"launches": r["launches"], "loss": r["loss"],
                             **({} if faults else {"grads": r["grads"]})}
                    runs.append(r)
                out[tag] = {"runs": runs, "ms": one.times()}
            out["seconds"]["end"] = time.perf_counter() - t0
            if check_kernels:
                step_cap = _Capture(0, (
                    (pointnet2, "farthest_point_sample"),
                    (fused_sa, "sa_extract_cuda"),
                    (fused_sa, "sa_fwd_step_cuda"),
                    (fused_sa, "sa_bwd_step_cuda"),
                    (fused_sa, "sa_bwd_step0_cuda")))
                eval_cap = _Capture(0, (
                    (pointnet2, "farthest_point_sample"),
                    (fused_sa, "sa_infer")))
                step = PTStep(jobs["b"], mesh.device)
                step_cap(0, ())
                try:
                    launches = step()["launches"]
                finally:
                    step_cap(0, None)
                det = step.models()[0]
                predict = train_loop.make_predict_step(det, bins_lib.SUNRGBD)
                eval_cap(0, ())
                try:
                    predict(mesh_lib.local_rows(jobs["b"]["weak"]))
                finally:
                    eval_cap(0, None)
                if last:
                    _study_kernels(step_cap, eval_cap, launches, phase=32)
                out["seconds"]["kernels"] = time.perf_counter() - t0
    finally:
        mesh_lib.destroy(mesh)
    return out


def points_transfer(args, dev, card: str):
    """Phase 32: the transfer loop's steps, `BoxEstimationOnly` and a
    large N on a points mesh of the one card."""
    with fused_sa_env(None):
        _points_transfer(args, dev, card)


def _pt_specs(args, dev):
    """The specs of (a)-(c) and of the large-N step."""
    from transferable3d_torch.core import bins as bins_lib
    from transferable3d_torch.data import synthetic
    from transferable3d_torch.data.provider import FrustumDataset
    from transferable3d_torch.models import layers, registry
    from transferable3d_torch.train import config as config_lib
    from transferable3d_torch.train import train_semisup, train_sup

    sun = bins_lib.SUNRGBD
    cfg4 = transfer_cfg(args.seed, "")
    _check((cfg4.num_point, cfg4.num_channels, cfg4.batch_size)
           == (N, 6, PT_B), f"config 4's widths changed: {cfg4}")
    strong_ds, weak_ds, _ = train_semisup.build_semisup_datasets(cfg4)
    strong = strong_ds.get_batch(list(range(PT_B)))
    weak = weak_ds.get_batch(list(range(PT_B)))
    for k in ("calib_p", "has_calib", "box2d", "frustum_angle"):
        weak.pop(k)  # as the device-drawn weak batches: the angular spans
    gen = torch.Generator().manual_seed(args.seed + 30)
    boxpc = registry.get_model("boxpc_fit", sun, device="cpu", generator=gen)
    _perturb_bn(boxpc, gen)
    specs = {"a": {"kind": "a", "state_dict": boxpc.state_dict(),
                   "batch": strong, "seed": args.seed + 31,
                   "aniso": cfg4.boxpc_aniso_aug}}
    det = registry.get_model(
        cfg4.model, sun, dtype=torch.bfloat16, device="cpu",
        in_channels=cfg4.num_channels,
        generator=torch.Generator().manual_seed(args.seed + 32))
    _perturb_bn(det, gen)  # for the (1, 2) rank's predict step (K2)
    b = {"kind": "b", "name": cfg4.model, "dtype": torch.bfloat16,
         "state_dict": det.state_dict(), "boxpc": boxpc.state_dict(),
         "batch": _grid_batch(strong), "weak": _grid_batch(weak),
         "seed": args.seed + 33, "margin": 0.0}
    b["keep"] = [layers.dropout_keep_mask((PT_B, N, 128), 0.5, gen)
                 for _ in range(2)]
    probe = PTStep(b, dev)
    m = probe.models()[0].train()
    gaps = []
    for batch, keep in zip((b["batch"], b["weak"]), b["keep"]):
        with _keep_masks([keep]), torch.no_grad():
            logits = m(torch.as_tensor(batch["points"], device=dev),
                       torch.as_tensor(batch["one_hot"], device=dev), 0.5,
                       torch.Generator())["seg_logits"].float()
        gaps.append(float((logits[..., 1] - logits[..., 0]).abs().max()))
    b["margin"] = 1.0 + 2.0 * max(gaps)
    specs["b"] = b
    cfg1 = dataclasses.replace(config_lib.PRESETS["config1_boxonly_chair"],
                               synthetic_train=PT_B, synthetic_val=PT_B,
                               seed=args.seed)
    _check((cfg1.num_point, cfg1.classes, cfg1.batch_size)
           == (512, ("chair",), PT_B), f"config 1's widths changed: {cfg1}")
    box_only = registry.get_model(
        cfg1.model, sun, device="cpu",
        generator=torch.Generator().manual_seed(args.seed + 34))
    _perturb_bn(box_only, gen)
    specs["c"] = {"kind": "c", "name": cfg1.model, "dtype": torch.float32,
                  "state_dict": box_only.state_dict(),
                  "batch": train_sup.build_datasets(cfg1)[0].get_batch(
                      list(range(PT_B))), "seed": args.seed + 35}
    recs = synthetic.make_dataset(PT_B, sun, seed=args.seed + 36,
                                  extra_channels=3, n_object=12000,
                                  n_clutter=6000)
    large = FrustumDataset(recs, sun, npoints=PT_LARGE_N,
                           rotate_to_center=True, seed=args.seed).get_batch(
                               list(range(PT_B)))
    specs["large"] = _dp_spec("frustum_pointnets_v1", large, args.seed + 37,
                              dev)
    return specs


def _points_transfer(args, dev, card: str):
    import shutil

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    specs = _pt_specs(args, dev)
    print(f"phase 32 specs: {time.perf_counter() - t0:.1f} s", flush=True)
    one, witness, ms1 = {}, {}, {}
    halves_b = np.r_[PT_B // 2:PT_B, 0:PT_B // 2]
    for tag in ("a", "b", "c"):
        step = PTStep(specs[tag])
        one[tag] = step()
        if tag == "b":  # v2's FPS starts at point 0: swap the frustums
            witness[tag] = step(order=halves_b)
            n = specs[tag]["weak"]["points"].shape[1]
            witness["b weak"] = step(weak_points_order=np.r_[n // 2:n,
                                                             0:n // 2])
        else:  # a function of each frustum's point set
            n = specs[tag]["batch"]["points"].shape[1]
            witness[tag] = step(points_order=np.r_[n // 2:n, 0:n // 2])
        ms1[tag] = step.times()
    one["large"] = _pt_large(specs["large"])
    print(f"phase 32 one rank's steps: {time.perf_counter() - t0:.1f} s",
          flush=True)
    torch.cuda.empty_cache()
    stages = [(4, 2, {k: specs[k] for k in ("a", "b", "c")}, False),
              (2, 2, {k: specs[k] for k in ("a", "b")}, True),
              (4, 4, {"large": specs["large"]}, False)]
    t1 = time.perf_counter()
    tmp = _spawn(pt_rank, 4, stages)
    outs = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
            for r in range(4)]
    shutil.rmtree(tmp, ignore_errors=True)
    cards = torch.cuda.device_count()
    meshes = {}
    for i, (world, points, jobs, check) in enumerate(stages):
        meshes[(world // points, points)] = [outs[r][i] for r in range(world)]
        also = ", the kernels against their twins" if check else ""
        print(f"phase 32 the ({world // points}, {points}) mesh "
              f"({sorted(jobs)}{also}): the last rank's seconds after "
              "forming it: " + ", ".join(
                  f"{k} {v:.1f}" for k, v in outs[world - 1][i][
                      "seconds"].items()), flush=True)
    print(f"phase 32 the ranks' processes: {time.perf_counter() - t1:.1f} s",
          flush=True)

    def where(world):
        return (f"{world} ranks on {min(world, cards)} card(s), "
                + ("a card each (NCCL)" if world <= cards else "gloo"))

    want_b = {"fps": 8, "sa_extract": 16, "sa_fwd_step": 16,
              "sa_fwd_last": 16, "sa_bwd_step": 10, "sa_bwd_step0": 10}
    _expect_launches(one["b"]["launches"], want_b)
    for tag in ("a", "c"):
        _expect_launches(one[tag]["launches"], {})
    for tag, shape, what in (
            ("a", (1, 2), f"(a) BoxPC f32, config 4's widths, B={PT_B}"),
            ("a", (2, 2), f"(a) BoxPC f32, config 4's widths, B={PT_B}"),
            ("b", (1, 2), f"(b) phase B, v2 bf16 fused, config 4's widths, "
             f"B={PT_B} + {PT_B}"),
            ("b", (2, 2), f"(b) phase B, v2 bf16 fused, config 4's widths, "
             f"B={PT_B} + {PT_B}"),
            ("c", (2, 2), f"(c) BoxEstimationOnly f32, config 1's widths, "
             f"B={PT_B}")):
        ranks = meshes[shape]
        world, d = len(ranks), shape[0]
        runs = ranks[-1][tag]["runs"]
        for r in range(world):
            _check(ranks[r][tag]["runs"][0]["loss"] == runs[0]["loss"],
                   f"phase 32 {tag} {shape}: the ranks' losses differ")
            same = all(torch.equal(g, runs[0]["grads"][k]) for k, g in
                       ranks[r][tag]["runs"][0]["grads"].items())
            _check(same, f"phase 32 {tag} {shape}: rank {r} holds another "
                   "gradient than the last rank")
            for run in ranks[r][tag]["runs"]:
                _expect_launches(run["launches"],
                                 want_b if tag == "b" else {})
        rows = slice((d - 1) * PT_B // d, PT_B)  # the last rank's rows
        nets = PT_NETS[tag]
        read = {f"{shape} vs 1 rank": pt_readings(one[tag], runs[0], nets,
                                                  rows),
                "witness: 1 rank on the "
                + ("batch's halves swapped" if tag == "b" else
                   "point halves swapped"):
                    pt_readings(one[tag], witness[tag], nets,
                                order=halves_b if tag == "b" else None)}
        controls = {f"control: {f[0]}": pt_readings(one[tag], run, nets,
                                                    rows)
                    for f, run in zip(PT_RUNS[tag][1:], runs[1:])}
        unsummed = controls.pop("control: box_cotangent_unsummed", None)
        dp_judge(f"{what} on a {shape} mesh, {where(world)}",
                 PT_LIMITS[tag], read, controls, phase=32)
        if unsummed is not None and shape == (1, 2):
            dp_judge(f"{what} on a {shape} mesh, the predicted box's "
                     "cotangent from the weak losses", PT_BOX_LIMITS,
                     {f"{shape} vs 1 rank": read[f"{shape} vs 1 rank"],
                      "witness: 1 rank, the weak losses on each weak "
                      "frustum's point halves swapped": pt_readings(
                          one[tag], witness["b weak"], nets)},
                     {"control: box_cotangent_unsummed": unsummed},
                     phase=32)
        elif unsummed is not None:
            print(f"phase 32 {what} on a {shape} mesh: box_cot (read, not "
                  f"judged) {read[f'{shape} vs 1 rank']['box_cot']:.5g}, "
                  f"without the points-group sum {unsummed['box_cot']:.5g}",
                  flush=True)
        print(f"times phase 32 {what} on a {shape} mesh, {where(world)}: "
              f"{ranks[0][tag]['ms']:.1f} ms a step (rank 0); 1 rank "
              f"{ms1[tag]:.1f} ms a step {card}", flush=True)

    # The large N: the (1, 4) ranks' step against one rank's, at phase
    # 31's v1 limits, and each rank's peak memory and step time.
    ranks = meshes[(1, 4)]
    big = ranks[-1]["large"]
    _check(bool(one["large"]["mask"].all()) and bool(big["mask"].all()),
           "phase 32 large N: a mask is not full (the margin did not pin it)")
    for r in range(4):
        _check(ranks[r]["large"]["loss"] == big["loss"],
               "phase 32 large N: the ranks' losses differ")
        _expect_launches(ranks[r]["large"]["launches"], {})
    dp_judge(f"large N: v1 bf16, B={PT_B}, N={PT_LARGE_N}, C=6 on a (1, 4) "
             f"mesh, {where(4)}", PP_V1_LIMITS,
             {"(1, 4) vs 1 rank": dp_readings(one["large"], big)}, {},
             phase=32)
    print(f"times phase 32 large N (v1 bf16, B={PT_B}, N={PT_LARGE_N}, "
          f"C=6): 1 rank {one['large']['ms']:.1f} ms a step, peak "
          f"{one['large']['peak_gib']:.3f} GiB; (1, 4) mesh, {where(4)}, "
          f"{PT_LARGE_N // 4} points a frustum a rank: " + "; ".join(
              f"rank {r} {ranks[r]['large']['ms']:.1f} ms, peak "
              f"{ranks[r]['large']['peak_gib']:.3f} GiB" for r in range(4))
          + f" {card}", flush=True)
    print(f"phase 32 points transfer: {time.perf_counter() - t0:.1f} s "
          f"{card}", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--data_parallel_only", action="store_true",
                    help="phases 1, 2 and 30 only (no kernels line)")
    ap.add_argument("--points_parallel_only", action="store_true",
                    help="phases 1, 2 and 31 only (no kernels line)")
    ap.add_argument("--points_transfer_only", action="store_true",
                    help="phases 1, 2 and 32 only (no kernels line)")
    ap.add_argument("--world", type=int, default=DP_WORLD,
                    help="phase 30's ranks (on a machine with that many "
                    "cards: one a card, over NCCL)")
    args = ap.parse_args()
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is false: this smoke run needs an "
              "NVIDIA GPU")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from transferable3d_torch.ops import _build

    # Products accumulate in f32, as in the JAX package: no TF32, and no
    # bf16 partial sums in cuBLAS's split reductions (the rank processes
    # of phases 30-31 set the same).
    from transferable3d_torch.train.train_sup import f32_numerics

    f32_numerics()
    dev = torch.device("cuda:0")

    # 1. the card
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    card = f"[{smi}]"
    print(f"phase 1 device: {kind}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}, count {torch.cuda.device_count()}",
          flush=True)
    print(smi, flush=True)

    # 2. build
    t0 = time.perf_counter()
    _build.library()
    print(f"phase 2 build: kernels ready in "
          f"{time.perf_counter() - t0:.2f} s (nvcc "
          f"{'ran' if _build.build_seconds is not None else 'cached'})",
          flush=True)

    if args.data_parallel_only:
        data_parallel(args, dev, card)
        return
    if args.points_parallel_only:
        points_parallel(args, dev, card)
        return
    if args.points_transfer_only:
        points_transfer(args, dev, card)
        return
    keep = {}
    with torch.no_grad():
        kernels = serve(args, dev, card, keep)
    unfused_kernels, ctx = train(args, dev, card)
    kernels += unfused_kernels + train_fused(args, dev, card, ctx)
    kernels += e2e(args, dev, card, ctx)
    driver(args, dev, card)
    transfer(args, dev, card)
    repro(args, dev, card)
    study(args, dev, card)
    tools(args, dev, card, keep)
    data_parallel(args, dev, card)
    points_parallel(args, dev, card)
    points_transfer(args, dev, card)

    print(f"times whole run: {time.perf_counter() - t_start:.1f} s {card}",
          flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
