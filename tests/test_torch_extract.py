"""Ball-query extraction (kernels K3/K4): the port's plain twins against
the JAX `ball_query_extract` (Pallas kernels in interpret mode) and its
VJP, on the CPU.

K3's twin must equal the kernel bit for bit (rows and counts): both take
the direct-form distance, so random coordinates off any grid are fine.
K4's twin must equal the VJP exactly on integer-valued cotangents (every
f32 partial sum is then exact) and within 1 bf16 ulp on continuous ones
(f32 sums in another order, rounded to bf16 once on both sides). On the
CPU the twin adds each point's slots in ascending (s, k), the order the
card's K4 keeps, and K4's membership (`extract_members_plain`) gives back
the JAX kernel's slots.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import n, t
from transferable3d_tpu.ops import grouping as jgrp
from transferable3d_torch.ops import grouping as tgrp

# (B, S, N, C, K, radius): short and overfull balls at radius 0.5; a
# cluster of exactly K points 50 m away around centroid 0 (full balls);
# K > N; half the centroids moved 100 m away (empty balls).
CASES = {
    "mixed": (2, 32, 256, 16, 32, 0.5),
    "full": (2, 32, 256, 16, 24, 0.5),
    "k_gt_n": (2, 16, 48, 8, 64, 0.9),
    "empty": (2, 32, 256, 16, 16, 0.3),
}


def _inputs(case, seed):
    b, s, npt, c, k, r = CASES[case]
    rng = np.random.RandomState(seed)
    xyz = rng.normal(0, 0.6, (b, npt, 3)).astype(np.float32)
    if case == "full":
        xyz[:, s:s + k] = 50.0 + rng.uniform(-r / 3, r / 3, (b, k, 3))
    cent = (xyz[:, :s] + rng.normal(0, 0.05, (b, s, 3))).astype(np.float32)
    if case == "full":
        cent[:, 0] = 50.0
    if case == "empty":
        cent[:, ::2] += 100.0
    pay = jnp.asarray(rng.uniform(-2, 2, (b, npt, c)).astype(np.float32)
                      ).astype(jnp.bfloat16)
    return rng, cent, xyz, pay, k, r


def _ball_shares(cent, xyz, r, k):
    d2 = ((cent[:, :, None] - xyz[:, None]) ** 2).sum(-1)
    cnt = (d2 <= np.float32(r * r)).sum(-1)
    return {"empty": (cnt == 0).mean(), "short": ((cnt > 0) & (cnt < k)).mean(),
            "full": (cnt == k).mean(), "overfull": (cnt > k).mean()}


@pytest.mark.parametrize("case", sorted(CASES))
def test_extract_fwd_plain_equals_jax_kernel(case):
    _, cent, xyz, pay, k, r = _inputs(case, 1)
    shares = _ball_shares(cent, xyz, r, k)
    if case == "empty":
        assert shares["empty"] >= 0.5
    elif case == "mixed":
        assert shares["short"] > 0 and shares["overfull"] > 0
    elif case == "full":
        assert shares["full"] > 0
    ref, cref = jgrp.ball_query_extract(jnp.asarray(cent), jnp.asarray(xyz),
                                        pay, r, k, True)
    got, cnt = tgrp.extract_fwd_plain(torch.from_numpy(cent),
                                      torch.from_numpy(xyz), t(pay), r, k)
    assert got.dtype == torch.bfloat16 and cnt.dtype == torch.int32
    np.testing.assert_array_equal(n(cnt), np.asarray(cref))
    np.testing.assert_array_equal(n(got), n(ref))


def _bf16_ulp(x):
    """One bf16 unit in the last place of each value of x (float32)."""
    m, e = np.frexp(np.abs(x))
    return np.where(x == 0, 0.0, np.ldexp(1.0, e - 8))


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("integer", [True, False])
def test_extract_bwd_plain_equals_jax_vjp(case, integer):
    rng, cent, xyz, pay, k, r = _inputs(case, 2)
    b, s = cent.shape[:2]
    shape = (b, s, k, pay.shape[-1])
    dg = (rng.randint(-4, 5, shape) if integer
          else rng.normal(0, 1, shape)).astype(np.float32)
    dg = jnp.asarray(dg).astype(jnp.bfloat16)
    _, vjp = jax.vjp(lambda c_, x_, p_: jgrp.ball_query_extract(
        c_, x_, p_, r, k, True)[0], jnp.asarray(cent), jnp.asarray(xyz), pay)
    dc, dx, dp_ref = vjp(dg)
    assert float(jnp.abs(dc).max()) == 0 and float(jnp.abs(dx).max()) == 0
    got = tgrp.extract_bwd_plain(torch.from_numpy(cent),
                                 torch.from_numpy(xyz), t(dg), r, k,
                                 xyz.shape[1])
    want, have = n(dp_ref), n(got)
    if integer:
        np.testing.assert_array_equal(have, want)
    else:
        assert (np.abs(have - want) <= _bf16_ulp(want)).all()


@pytest.mark.parametrize("integer", [True, False])
def test_grouped_payload_cpu_vjp_equals_jax(integer):
    """The CPU path of `grouped_payload` (expanded-form gather) against
    `jax.vjp` of the JAX CPU path (`_onehot_select` and its custom VJP)
    in bf16: both sum the payload cotangent in f32 and round once. The
    integer cotangents reach sums past 256, where a bf16 running sum
    would round; coordinates lie on a 1/64 grid so that the two
    expanded-form distances are exact."""
    rng, cent, xyz, pay, k, r = _inputs("mixed", 4)
    cent, xyz = np.round(cent * 64) / 64, np.round(xyz * 64) / 64
    shape = (*cent.shape[:2], k, pay.shape[-1])
    dg = (rng.randint(-100, 101, shape) if integer
          else rng.normal(0, 1, shape)).astype(np.float32)
    dg = jnp.asarray(dg).astype(jnp.bfloat16)
    (ref, cref), vjp = jax.vjp(lambda p_: jgrp.grouped_payload(
        jnp.asarray(cent), jnp.asarray(xyz), p_, r, k), pay)
    (dp_ref,) = vjp((dg, np.zeros(cref.shape, jax.dtypes.float0)))
    tp = t(pay).requires_grad_(True)
    got, cnt = tgrp.grouped_payload(torch.from_numpy(cent),
                                    torch.from_numpy(xyz), tp, r, k)
    np.testing.assert_array_equal(n(got), n(ref))
    np.testing.assert_array_equal(n(cnt), np.asarray(cref))
    got.backward(t(dg))
    assert tp.grad.dtype == torch.bfloat16
    want, have = n(dp_ref), n(tp.grad)
    if integer:
        assert np.abs(want).max() > 256
        np.testing.assert_array_equal(have, want)
    else:
        assert (np.abs(have - want) <= _bf16_ulp(want)).all()


def test_autograd_function_on_cpu():
    """`ball_query_extract` on CPU tensors: forward is K3's twin, the
    payload gradient is K4's twin, centroids and xyz get no gradient."""
    rng, cent, xyz, pay, k, r = _inputs("mixed", 3)
    tc = torch.from_numpy(cent).requires_grad_(True)
    tx = torch.from_numpy(xyz).requires_grad_(True)
    tp = t(pay).requires_grad_(True)
    got, cnt = tgrp.ball_query_extract(tc, tx, tp, r, k)
    dg = torch.from_numpy(rng.normal(0, 1, got.shape).astype(np.float32)
                          ).to(torch.bfloat16)
    got.backward(dg)
    assert tc.grad is None and tx.grad is None and not cnt.requires_grad
    want = tgrp.extract_bwd_plain(tc.detach(), tx.detach(), dg, r, k,
                                  xyz.shape[1])
    assert tp.grad.dtype == torch.bfloat16
    assert torch.equal(tp.grad, want)
    # grouped_payload keeps the expanded-form gather for CPU tensors.
    g2, c2 = tgrp.grouped_payload(tc.detach(), tx.detach(), tp.detach(), r, k)
    ref, cref = tgrp.ball_query_group(tc.detach(), tx.detach(), tp.detach(),
                                      r, k, include_xyz=False)
    assert torch.equal(g2, ref) and torch.equal(c2, cref)


def _members_np(cent, xyz, r, k):
    """`extract_members_plain` as numpy arrays: bits and ranks before each
    word [B, NW, S], eff [B, S]."""
    bits, before, eff = tgrp.extract_members_plain(
        torch.from_numpy(cent), torch.from_numpy(xyz), r, k)
    return n(bits), n(before), n(eff)


@pytest.mark.parametrize("case", sorted(CASES))
def test_members_plain_gives_the_jax_kernels_slots(case):
    """K4's membership (a word's bits, the members before it, eff) gives
    back the JAX kernel's slots: member k mod eff in rank order, each rank
    the members before the word plus the bits below the point."""
    _, cent, xyz, pay, k, r = _inputs(case, 5)
    ref, cref = jgrp.ball_query_extract(jnp.asarray(cent), jnp.asarray(xyz),
                                        pay, r, k, True)
    bits, before, eff = _members_np(cent, xyz, r, k)
    b, s = cent.shape[:2]
    assert bits.shape == before.shape == (b, -(-xyz.shape[1] // 32), s)
    np.testing.assert_array_equal(eff, np.clip(np.asarray(cref), 1, k))
    idx = np.zeros((b, s, k), np.int64)
    for bb in range(b):
        for ss in range(s):
            members = [32 * w + lane for w in range(bits.shape[1])
                       for lane in range(32) if bits[bb, w, ss] >> lane & 1]
            assert len(members) == eff[bb, ss]
            for rank, p in enumerate(members):
                w, lane = divmod(p, 32)
                below = int(bits[bb, w, ss]) & ((1 << lane) - 1)
                if cref[bb, ss] > 0:
                    assert before[bb, w, ss] + bin(below).count("1") == rank
            idx[bb, ss] = [members[j % len(members)] for j in range(k)]
    got = tgrp.flat_row_gather(t(pay), torch.from_numpy(idx))
    np.testing.assert_array_equal(n(got), n(ref))


def test_extract_members_bytes_fits_the_membership():
    """The scratch K4's wrapper allocates: 8 bytes a centroid and 32-point
    word, 4 a centroid for eff; at the largest unfused scale of a v2 train
    step (B=128, S=128, N=1024) some 4.2 MB."""
    _, cent, xyz, _, k, r = _inputs("mixed", 6)
    bits, _, eff = _members_np(cent, xyz, r, k)
    b, s, npt = cent.shape[0], cent.shape[1], xyz.shape[1]
    assert (tgrp.extract_members_bytes(b, s, npt)
            == bits.size * 8 + eff.size * 4)
    assert tgrp.extract_members_bytes(128, 128, 1024) == 128 * 128 * 260
    assert tgrp.extract_members_bytes(2, 3, 1) == 2 * 3 * 12
    assert tgrp.extract_members_bytes(2, 3, 33) == 2 * 3 * 20


# Heavy collisions: (B, S, N, K, C, radius). Few points in many full balls,
# short balls repeating their members up to K times, empty balls.
COLLIDE = {
    "full_balls": (2, 32, 40, 64, 8, 5.0),
    "short_balls": (2, 24, 64, 128, 8, 0.3),
    "mixed": (3, 48, 96, 32, 16, 0.6),
}


@pytest.mark.parametrize("case", sorted(COLLIDE))
def test_bwd_plain_is_the_ascending_sequential_sum(case):
    """`extract_bwd_plain` on the CPU is, bit for bit, each point's slots
    summed from +0.0 in f32 in ascending (s, k) and rounded once: the
    order the card's K4 is held to. The owner's walk of K4's gather over
    the membership (ascending s; slots r, r + eff, ... < K for rank r)
    gives the same bits."""
    b, s, npt, k, c, r = COLLIDE[case]
    rng = np.random.RandomState(7)
    xyz = rng.normal(0, 0.6, (b, npt, 3)).astype(np.float32)
    cent = xyz[:, rng.randint(0, npt, s)] + rng.normal(0, 0.05, (b, s, 3))
    cent = cent.astype(np.float32)
    cent[:, ::5] += 100.0
    dg = torch.from_numpy(rng.normal(0, 1, (b, s, k, c)).astype(np.float32)
                          ).to(torch.bfloat16)
    got = tgrp.extract_bwd_plain(torch.from_numpy(cent),
                                 torch.from_numpy(xyz), dg, r, k, npt)
    idx, _ = tgrp._extract_slots(torch.from_numpy(cent),
                                 torch.from_numpy(xyz), r, k)
    idx, d = idx.numpy(), dg.float().numpy()
    hits = np.zeros((b, npt))
    for bb in range(b):
        np.add.at(hits[bb], idx[bb].ravel(), 1)
    assert hits.max() >= 4 * k if case != "mixed" else hits.max() >= k
    seq = np.zeros((b, npt, c), np.float32)
    rows = np.arange(b)
    for ss in range(s):
        for kk in range(k):
            seq[rows, idx[:, ss, kk]] += d[:, ss, kk]
    assert torch.equal(got, torch.from_numpy(seq).to(torch.bfloat16))
    bits, before, eff = _members_np(cent, xyz, r, k)
    walk = np.zeros((b, npt, c), np.float32)
    for bb in range(b):
        for p in range(npt):
            w, lane = divmod(p, 32)
            for ss in range(s):
                word = int(bits[bb, w, ss])
                if word >> lane & 1:
                    rank = before[bb, w, ss] + bin(
                        word & ((1 << lane) - 1)).count("1")
                    for kk in range(rank, k, eff[bb, ss]):
                        walk[bb, p] += d[bb, ss, kk]
    np.testing.assert_array_equal(walk, seq)
