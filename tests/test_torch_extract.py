"""Ball-query extraction (kernels K3/K4): the port's plain twins against
the JAX `ball_query_extract` (Pallas kernels in interpret mode) and its
VJP, on the CPU.

K3's twin must equal the kernel bit for bit (rows and counts): both take
the direct-form distance, so random coordinates off any grid are fine.
K4's twin must equal the VJP exactly on integer-valued cotangents (every
f32 partial sum is then exact) and within 1 bf16 ulp on continuous ones
(f32 sums in another order, rounded to bf16 once on both sides).
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
