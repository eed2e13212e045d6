"""Port of data/frustum_jit.py against the JAX package on the CPU.

The port's plain twin of the fetch (K15's) is held against the Pallas
kernel in interpret mode and against the XLA form, as
tests/test_frustum_jit.py runs them: the same point index, and the JAX
output equal bit for bit to the bf16 hi + lo split of the port's exact
f32 point. The sampling properties of tests/test_frustum_jit.py are
repeated on the port with its own generator.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from transferable3d_tpu.data import frustum_jit as jfj
from transferable3d_torch.core.geometry import rotate_points_y_np
from transferable3d_torch.data import frustum_jit as tfj

K = np.array([[500.0, 0, 320.0], [0, 500.0, 240.0], [0, 0, 1]], np.float32)


def hi_lo(x: np.ndarray) -> np.ndarray:
    """hi + lo of the exact bf16 split of f32 x, in numpy
    (core/numerics.exact_hi_lo)."""
    hi = x.astype(ml_dtypes.bfloat16).astype(np.float32)
    lo = (x - hi).astype(ml_dtypes.bfloat16).astype(np.float32)
    return hi + lo


def jax_phases(rng, nbox):
    """The phases `_sample_batch` draws from `rng` (frustum_jit.py:270)."""
    return np.array(jax.vmap(lambda r: jax.random.uniform(r, ()))(
        jax.random.split(rng, nbox)))


def assert_points_close(got, jax_points, unrotated, angle):
    """Port points against JAX's. Loose: within 1.6e-5 of the point's
    norm (the JAX fetch returns each coordinate's bf16 hi + lo split,
    2^-17 relative, which the rotation mixes) plus 1e-6. Sharp: JAX's
    points are the port's rotation of hi_lo(the port's unrotated points)
    within 2e-6 (sin and cos differ in the last place)."""
    got, jax_points = np.asarray(got), np.asarray(jax_points)
    norm = np.linalg.norm(got[..., :3], axis=-1, keepdims=True)
    assert (np.abs(got - jax_points) <= 1.6e-5 * norm + 1e-6).all()
    split = hi_lo(np.asarray(unrotated))
    want = rotate_points_y_np(split[..., :3], np.asarray(angle))
    np.testing.assert_allclose(jax_points[..., :3], want, atol=2e-6, rtol=0)
    np.testing.assert_array_equal(jax_points[..., 3:], split[..., 3:])


def test_depth_to_camera_points_matches_jax():
    rng = np.random.RandomState(0)
    depth = rng.uniform(0.5, 9.0, (48, 64)).astype(np.float32)
    depth[rng.rand(48, 64) < 0.2] = 0.0
    k = np.array([[130.0, 0, 31.5], [0, 127.0, 24.25], [0, 0, 1]], np.float32)
    jp, jv = jax.jit(jfj.depth_to_camera_points)(jnp.asarray(depth),
                                                 jnp.asarray(k))
    tp, tv = tfj.depth_to_camera_points(torch.from_numpy(depth),
                                        torch.from_numpy(k))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    # Tolerance 0: three elementwise f32 ops in the same order.
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    # Batched over frames: the same values per frame.
    tp2, tv2 = tfj.depth_to_camera_points(
        torch.from_numpy(np.stack([depth, depth[::-1]])),
        torch.from_numpy(k))
    np.testing.assert_array_equal(tp2[0].numpy(), tp.numpy())
    assert tp2.shape == (2, 48 * 64, 3) and tv2.shape == (2, 48 * 64)


def _masks(rng, counts, n):
    inside = np.zeros((len(counts), n), bool)
    for i, c in enumerate(counts):
        inside[i, rng.permutation(n)[:c]] = True
    return inside


@pytest.mark.parametrize("npoints", [64, 256, 1000, 1024])
@pytest.mark.parametrize("kind", ["zero", "ten", "fewer", "more"])
def test_want_and_count_match_select_prelude(npoints, kind):
    """Exact: the ranks are integers computed in f32 in the same order.
    npoints 1000 is not a power of two, so the division rounds."""
    rng = np.random.RandomState(npoints + len(kind))
    n, b = 4096, 6
    counts = {"zero": [0] * b, "ten": [10] * b,
              "fewer": list(rng.randint(1, npoints, b)),
              "more": list(rng.randint(npoints, n + 1, b))}[kind]
    inside = _masks(rng, counts, n)
    us = rng.rand(b).astype(np.float32)
    us[0] = 0.0
    us[1] = np.float32(1.0) - np.float32(2.0 ** -24)  # largest phase < 1
    _, _, _, jwant, jcount = jax.jit(jax.vmap(
        lambda i, u: jfj._select_prelude(i, npoints, u)))(
            jnp.asarray(inside), jnp.asarray(us))
    u = torch.from_numpy(us)[None]
    pts = torch.zeros(1, n, 1)
    _, _, count = tfj.fetch_select_plain(pts, torch.from_numpy(inside)[None],
                                         u, npoints)
    np.testing.assert_array_equal(count[0].numpy(),
                                  np.asarray(jcount).astype(np.int32))
    want = tfj.want_ranks(u, count.float(), npoints)[0].numpy()
    np.testing.assert_array_equal(want, np.asarray(jwant))
    assert want.min() >= 1 and (want.max(axis=1)
                                <= np.maximum(counts, 1)).all()


@pytest.mark.parametrize("npoints", [256, 1000])
def test_fetch_twin_matches_jax_kernel_and_xla(npoints):
    """The index is the same and the JAX coordinates are the bf16 hi + lo
    split of the port's exact f32 point, bit for bit; an empty frustum
    gives zeros. The Pallas kernel takes npoints that are a multiple of
    128 only; the XLA form takes any."""
    rng = np.random.RandomState(3)
    n, c, b = 1024, 3, 6
    pts = rng.uniform(-4, 9, (n, c)).astype(np.float32)
    inside = rng.rand(b, n) < 0.2
    inside[4] = False                       # an empty frustum
    inside[5, 40:] = False                  # fewer than npoints: wraps
    us = rng.rand(b).astype(np.float32)
    lrank, ts, te, want, count = jax.vmap(
        lambda i, u: jfj._select_prelude(i, npoints, u))(
            jnp.asarray(inside), jnp.asarray(us))
    xla = np.asarray(jax.vmap(
        lambda l, s, e, w: jfj._fetch_select_xla(
            jnp.asarray(pts), l, s, e, w, npoints))(lrank, ts, te, want))
    sampled, idx, cnt = tfj.fetch_select(
        torch.from_numpy(pts)[None], torch.from_numpy(inside)[None],
        torch.from_numpy(us)[None], npoints)
    sampled, idx, cnt = sampled[0].numpy(), idx[0].numpy(), cnt[0].numpy()
    np.testing.assert_array_equal(cnt, np.asarray(count).astype(np.int32))
    assert (idx[4] == -1).all() and (sampled[4] == 0).all()
    assert (xla[4] == 0).all()
    full = [0, 1, 2, 3, 5]
    # The port gathers the exact point of the index it reports ...
    np.testing.assert_array_equal(sampled[full], pts[idx[full]])
    # ... which is the `want`-th in-box point in index order ...
    for i in full:
        np.testing.assert_array_equal(
            idx[i], np.flatnonzero(inside[i])[
                np.asarray(want[i]).astype(np.int64) - 1])
    # ... and JAX returns hi + lo of that point.
    np.testing.assert_array_equal(xla, hi_lo(sampled))
    if npoints % 128 == 0:
        pallas = np.asarray(jfj._fetch_select_pallas(
            jnp.asarray(pts), lrank, ts, te, want, npoints, interpret=True))
        np.testing.assert_array_equal(pallas, hi_lo(sampled))
    assert len(np.unique(idx[5])) == int(cnt[5])  # every point, cyclically


# K15's launch shapes: masks from 1 point to the largest the kernel
# takes, one frustum to a thousand.
PLAN_SHAPES = [(n, fr) for n in (1, 31, 32, 33, 100, 12288, 20000, 307200,
                                 386900, 900000, tfj.FETCH_MAX_POINTS)
               for fr in (1, 16, 128, 1024)]


@pytest.mark.parametrize("n,frustums", PLAN_SHAPES)
def test_fetch_select_plan_gives_every_word_one_block(n, frustums):
    """Block k of the launch serves frustum k // group and owns the words
    [g * span, (g + 1) * span) of it, g = k % group: every word of every
    frustum has exactly one owner, every block at least one word; the
    group is a portable cluster (at most 8 blocks); shared memory, 8 bytes
    a word, stays within the 227 KB a block can have; the loads divide
    N."""
    plan = tfj.fetch_select_plan(n, frustums)
    nwords = -(-n // 32)
    blocks = np.arange(frustums * plan.group)
    b, g = blocks // plan.group, blocks % plan.group
    np.testing.assert_array_equal(np.bincount(b, minlength=frustums),
                                  plan.group)
    # Each frustum's blocks are ranks 0..group-1, so its words' owners:
    lo = np.arange(plan.group) * plan.span
    hi = np.minimum(lo + plan.span, nwords)
    assert (hi > lo).all()
    owners = np.zeros(nwords + 1, np.int64)
    np.add.at(owners, lo, 1)
    np.add.at(owners, hi, -1)
    assert (np.cumsum(owners)[:nwords] == 1).all()
    assert 1 <= plan.group <= tfj.FETCH_MAX_GROUP == 8
    assert plan.smem == 8 * plan.span <= 232_448
    assert plan.vec in (1, 4, 16) and n % plan.vec == 0
    assert tfj.fetch_select_plan(n, frustums) is plan   # computed once


def test_fetch_select_plan_fills_the_card_at_full_resolution_only():
    """One block a frustum at the 96x128 e2e shape (384 words, 128
    frustums); more at 480x640, where 16 frustums alone would leave most
    of the card idle; the plan refuses masks beyond FETCH_MAX_POINTS."""
    assert tfj.fetch_select_plan(96 * 128, 128).group == 1
    assert tfj.fetch_select_plan(480 * 640, 16).group > 1
    assert tfj.fetch_select_plan(480 * 640, 128).group > 1
    assert tfj.FETCH_MAX_POINTS >= 900_000
    with pytest.raises(ValueError, match="exceeds"):
        tfj.fetch_select_plan(tfj.FETCH_MAX_POINTS + 32, 1)


def test_fetch_select_refuses_bad_arguments():
    pts = torch.zeros(1, 64, 3)
    inside = torch.zeros(1, 2, 64, dtype=torch.bool)
    u = torch.zeros(1, 2)
    with pytest.raises(ValueError, match="float32"):
        tfj.fetch_select(pts, inside.to(torch.uint8), u, 16)
    with pytest.raises(ValueError, match="takes pts"):
        tfj.fetch_select(pts, inside[:, :, :32], u, 16)
    with pytest.raises(ValueError, match="CUDA"):
        tfj.fetch_select_cuda(pts, inside, u, 16)


def _scene():
    rng = np.random.RandomState(5)
    depth = rng.uniform(2.0, 6.0, (120, 160)).astype(np.float32)
    depth[rng.rand(120, 160) < 0.1] = 0.0
    k = np.array([[130.0, 0, 80.0], [0, 130.0, 60.0], [0, 0, 1]], np.float32)
    boxes = np.array([[20, 10, 90, 100], [100, 30, 150.5, 80.25],
                      [5, 5, 12, 9], [40, 40, 40, 40]], np.float32)
    return depth, k, boxes


@pytest.mark.parametrize("npoints", [256, 1000])
def test_lift_depth_frustums_matches_jax(npoints):
    """Whole pass with the phases JAX drew: count exact, angle 1e-6
    (atan2), the rotated points as `assert_points_close` states."""
    depth, k, boxes = _scene()
    key = jax.random.PRNGKey(4)
    jout = jfj.lift_depth_frustums(jnp.asarray(depth), jnp.asarray(k),
                                   jnp.asarray(boxes), npoints, key)
    tout = tfj.lift_depth_frustums(depth, k, boxes, npoints,
                                   jax_phases(key, len(boxes)), device="cpu")
    np.testing.assert_array_equal(tout.count.numpy(), np.asarray(jout.count))
    assert tout.count[3] == 0 and tout.count[2] < npoints < tout.count[0]
    np.testing.assert_allclose(tout.frustum_angle.numpy(),
                               np.asarray(jout.frustum_angle), atol=1e-6)
    grid, _ = tfj.depth_to_camera_points(torch.from_numpy(depth),
                                         torch.from_numpy(k))
    unrot = grid.numpy()[tout.idx.clamp(min=0).numpy()]
    unrot[tout.idx.numpy() < 0] = 0
    assert_points_close(tout.points, jout.points, unrot, tout.frustum_angle)
    assert tout.points.shape == (4, npoints, 3)
    assert tout.idx.shape == (4, npoints) and tout.idx.dtype == torch.int32
    # The batched form gives the same frustums frame by frame.
    both = tfj.lift_depth_frustums(
        np.stack([depth, depth]), k, np.stack([boxes, boxes[::-1]]), npoints,
        np.stack([jax_phases(key, 4), jax_phases(key, 4)[::-1]]),
        device="cpu")
    np.testing.assert_array_equal(both.points[0].numpy(),
                                  tout.points.numpy())
    np.testing.assert_array_equal(both.idx[1].numpy()[::-1],
                                  tout.idx.numpy())


@pytest.mark.parametrize("h,w", [(480, 640), (530, 730)])
def test_lift_depth_frustums_matches_jax_at_sensor_resolution(h, w):
    """SUN RGB-D's depth resolutions (Kinect v1 and Xtion; Kinect v2),
    3 boxes, 1,024 points, with the phases JAX drew. 530 x 730 = 386,900
    points is not a multiple of 32 (the port's last word is ragged) and
    JAX pads it to 128. count exact; idx the JAX ranks' points exactly;
    angle 1e-6; the points as `assert_points_close` states."""
    rng = np.random.RandomState(h)
    depth = rng.uniform(0.5, 8.0, (h, w)).astype(np.float32)
    depth[rng.rand(h, w) < 0.1] = 0.0
    k = np.array([[520.0, 0, w / 2], [0, 520.0, h / 2], [0, 0, 1]],
                 np.float32)
    # A large box, a box in the last rows and columns, and one with fewer
    # points than slots (it wraps).
    boxes = np.array([[100, 80, 420.5, 330.25], [w - 61.5, h - 40.25, w, h],
                      [10, 10, 40, 35]], np.float32)
    npoints, key = 1024, jax.random.PRNGKey(h)
    jout = jfj.lift_depth_frustums(jnp.asarray(depth), jnp.asarray(k),
                                   jnp.asarray(boxes), npoints, key)
    phases = jax_phases(key, len(boxes))
    tout = tfj.lift_depth_frustums(depth, k, boxes, npoints, phases,
                                   device="cpu")
    np.testing.assert_array_equal(tout.count.numpy(), np.asarray(jout.count))
    assert tout.count[2] < npoints < tout.count[1] < tout.count[0]
    # JAX's own ranks over its (padded) mask name the port's points.
    n = h * w
    pad = -n % 128
    vs, us = np.divmod(np.arange(n + pad), w)
    valid = np.concatenate([depth.reshape(-1) > 1e-6, np.zeros(pad, bool)])
    inside = (valid & (us >= boxes[:, None, 0]) & (us < boxes[:, None, 2])
              & (vs >= boxes[:, None, 1]) & (vs < boxes[:, None, 3]))
    _, _, _, want, _ = jax.vmap(
        lambda i, u: jfj._select_prelude(i, npoints, u))(
            jnp.asarray(inside), jnp.asarray(phases))
    want = np.asarray(want).astype(np.int64)
    for i in range(len(boxes)):
        np.testing.assert_array_equal(
            tout.idx[i].numpy(), np.flatnonzero(inside[i])[want[i] - 1])
    np.testing.assert_allclose(tout.frustum_angle.numpy(),
                               np.asarray(jout.frustum_angle), atol=1e-6)
    grid, _ = tfj.depth_to_camera_points(torch.from_numpy(depth),
                                         torch.from_numpy(k))
    assert_points_close(tout.points, jout.points,
                        grid.numpy()[tout.idx.numpy()], tout.frustum_angle)


def test_crop_point_frustums_matches_jax():
    """2,000 points with an extra channel (N not a multiple of 128, which
    the JAX code pads): count exact, points as `assert_points_close`
    states, the channel carried through."""
    rng = np.random.RandomState(3)
    pts = rng.uniform(-5, 5, (2000, 4)).astype(np.float32)
    pts[:, 2] = np.abs(pts[:, 2]) + 2.0
    pts[:17, 2] = -1.0                                   # behind the camera
    boxes = np.array([[250.0, 180.0, 400.0, 300.0], [0, 0, 640, 480]],
                     np.float32)
    key = jax.random.PRNGKey(0)
    jout = jfj.crop_point_frustums(jnp.asarray(pts), jnp.asarray(K),
                                   jnp.asarray(boxes), 128, key)
    tout = tfj.crop_point_frustums(pts, K, boxes, 128, jax_phases(key, 2),
                                   device="cpu")
    np.testing.assert_array_equal(tout.count.numpy(), np.asarray(jout.count))
    np.testing.assert_allclose(tout.frustum_angle.numpy(),
                               np.asarray(jout.frustum_angle), atol=1e-6)
    assert_points_close(tout.points, jout.points, pts[tout.idx.numpy()],
                        tout.frustum_angle)
    assert tout.points.shape == (2, 128, 4)
    np.testing.assert_array_equal(tout.points[..., 3].numpy(),
                                  pts[tout.idx.numpy(), 3])


# The properties of tests/test_frustum_jit.py, on the port with its own
# generator.

def _lift(depth, boxes, npoints, seed):
    return tfj.lift_depth_frustums(
        depth, K, np.asarray(boxes, np.float32), npoints,
        torch.Generator().manual_seed(seed), device="cpu")


def test_sampling_without_replacement_when_enough():
    depth = np.zeros((100, 100), np.float32)
    depth[10:90, 10:90] = 5.0
    out = _lift(depth, [[0, 0, 100, 100]], 512, 1)
    assert int(out.count[0]) == 6400
    assert len(np.unique(out.idx[0].numpy())) == 512


def test_wrap_when_too_few_and_empty_box():
    depth = np.zeros((100, 100), np.float32)
    depth[50, 50:60] = 5.0  # 10 valid pixels
    out = _lift(depth, [[0, 0, 100, 100], [0, 0, 50, 50]], 64, 2)
    assert out.count.tolist() == [10, 0]
    assert sorted(np.unique(out.idx[0].numpy())) == list(
        range(50 * 100 + 50, 50 * 100 + 60))
    assert (out.idx[1] == -1).all() and (out.points[1] == 0).all()


def test_mask_is_half_open_and_depth_valid():
    depth = np.full((20, 20), 3.0, np.float32)
    depth[5, 5] = 0.0
    out = _lift(depth, [[4, 4, 8, 7]], 32, 0)
    assert int(out.count[0]) == 4 * 3 - 1  # u in [4, 8), v in [4, 7)
    v, u = np.divmod(out.idx[0].numpy(), 20)
    assert u.min() == 4 and u.max() == 7 and v.min() == 4 and v.max() == 6


def test_systematic_sampler_marginals_and_phase():
    depth = np.zeros((100, 100), np.float32)
    depth[20:84, 20:84] = 5.0  # 4096 valid pixels
    gen = torch.Generator().manual_seed(0)
    seen, subsets = {}, []
    for _ in range(20):
        out = tfj.lift_depth_frustums(
            depth, K, np.array([[0, 0, 100, 100]], np.float32), 256, gen,
            device="cpu")
        keys = set(out.idx[0].tolist())
        subsets.append(frozenset(keys))
        for k in keys:
            seen[k] = seen.get(k, 0) + 1
    assert len(set(subsets)) > 1
    counts = np.asarray(list(seen.values()))
    assert len(seen) >= 2048 and counts.max() <= 4


def test_output_slots_not_scan_ordered():
    depth = np.zeros((480, 640), np.float32)
    depth[100:400, 200:500] = 5.0
    box = [200, 100, 500, 400]
    out = _lift(depth, [box, box], 1024, 7)
    rows = out.idx.numpy() // 640
    med = np.median(rows[0])
    for lo in range(0, 1024, 256):
        frac_top = (rows[0, lo:lo + 256] < med).mean()
        assert 0.25 < frac_top < 0.75, (lo, frac_top)
    # Different frustums get different slot orders (the cyclic offset).
    assert not np.array_equal(rows[0], rows[1])


def test_angle_and_rotation_center_the_frustum():
    rng = np.random.RandomState(0)
    depth = np.zeros((480, 640), np.float32)
    depth[200:280, 300:400] = rng.uniform(3.0, 4.0, (80, 100))
    out = _lift(depth, [[300, 200, 400, 280]], 256, 0)
    pts = out.points[0].numpy()
    assert abs(pts[:, 0].mean()) < 0.2
    want = -np.arctan2((350.0 - 320.0) / 500.0, 1.0)
    assert abs(float(out.frustum_angle[0]) - want) < 1e-6
    # Rotating back gives the lifted pixels.
    grid, _ = tfj.depth_to_camera_points(torch.from_numpy(depth),
                                         torch.from_numpy(K))
    back = rotate_points_y_np(pts[None], -out.frustum_angle[:1].numpy())[0]
    np.testing.assert_allclose(back, grid.numpy()[out.idx[0].numpy()],
                               atol=1e-5)


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tfj.lift_depth_frustums(np.ones((4, 4), np.float32), K,
                                np.zeros((1, 4), np.float32), 8,
                                torch.Generator())
