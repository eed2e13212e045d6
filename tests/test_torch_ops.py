"""Port parity: FPS (plain twin of kernel K1), grouping, interpolation.

Same numpy inputs through `transferable3d_tpu.ops` (JAX on the CPU, the
Pallas FPS kernel in interpret mode) and `transferable3d_torch.ops` (plain
twins on CPU tensors). Indices must be equal; float outputs agree to
float32 rounding (atol 1e-5 on unit-scale data: the expanded-form
distance and the interpolation sums round in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import n, t
from transferable3d_tpu.ops import grouping as jgrp
from transferable3d_tpu.ops import interpolate as jint
from transferable3d_tpu.ops import sampling as jsam
from transferable3d_torch.ops import grouping as tgrp
from transferable3d_torch.ops import interpolate as tint
from transferable3d_torch.ops import sampling as tsam


def _cloud(seed, b, n_pts, dup=True, scale=5.0):
    rng = np.random.RandomState(seed)
    xyz = rng.uniform(-scale, scale, (b, n_pts, 3)).astype(np.float32)
    if dup:
        # Exact duplicates and a repeated cluster make argmax ties.
        xyz[:, 1] = xyz[:, 0]
        xyz[:, 7:12] = xyz[:, 3:4]
        xyz[:, -1] = xyz[:, 2]
    return xyz


@pytest.mark.parametrize("b,n_pts,k", [(3, 256, 32), (2, 64, 64),
                                        (2, 40, 64), (1, 128, 1)])
def test_fps_plain_equals_jax_ref(b, n_pts, k):
    xyz = _cloud(b + n_pts + k, b, n_pts)
    ref = np.asarray(jsam._fps_ref(jnp.asarray(xyz), k))
    got = tsam.farthest_point_sample(torch.from_numpy(xyz), k)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(n(got), ref)


def test_fps_plain_equals_pallas_interpret():
    xyz = _cloud(11, 4, 256)
    ref = np.asarray(jsam._fps_pallas(jnp.asarray(xyz), 32, True))
    np.testing.assert_array_equal(
        n(tsam.fps_plain(torch.from_numpy(xyz), 32)), ref)


def test_fps_all_equal_points_picks_zero():
    xyz = np.ones((2, 16, 3), np.float32)
    got = n(tsam.farthest_point_sample(torch.from_numpy(xyz), 5))
    np.testing.assert_array_equal(got, np.zeros((2, 5), np.int32))


def test_fps_plan_covers_every_size():
    """K1's plan for 1 <= n <= 12,288: 4 points a thread in registers up
    to 2,048 points, 8 up to 4,096, then the shared-memory path with
    1,024 threads; whole warps, as few as hold the points; the points'
    copy (16 bytes each) within the card's 232,448 bytes of shared
    memory."""
    for n in range(1, tsam.FPS_MAX_POINTS + 1):
        plan = tsam.fps_plan(n)
        assert plan.per_thread == (4 if n <= 2048 else 8 if n <= 4096
                                   else 0), n
        assert plan.threads % 32 == 0 and 32 <= plan.threads <= 1024, n
        if plan.per_thread:
            assert plan.threads * plan.per_thread >= n, n
            assert (plan.threads - 32) * plan.per_thread < n or n <= 32, n
        else:
            assert plan.threads == 1024, n
        assert plan.smem == 16 * n <= 232448 - 512, n
    for n in (0, tsam.FPS_MAX_POINTS + 1):
        with pytest.raises(ValueError):
            tsam.fps_plan(n)


@pytest.mark.parametrize("n,threads", [(128, 32), (512, 128), (1024, 256)])
def test_fps_plan_of_the_path_shapes(n, threads):
    """The main path's FPS calls (object points 512, the seg net's 1,024
    and both nets' 128 centroids): one warp for 128 points."""
    assert tsam.fps_plan(n) == (threads, 4, 16 * n)


def test_cuda_wrappers_refuse_cpu_tensors():
    xyz = torch.zeros(1, 8, 3)
    with pytest.raises(ValueError):
        tsam.fps_cuda(xyz, 4)


def test_gather_points():
    rng = np.random.RandomState(3)
    pts = rng.normal(size=(2, 20, 5)).astype(np.float32)
    idx = rng.randint(0, 20, (2, 7)).astype(np.int32)
    np.testing.assert_array_equal(
        n(tsam.gather_points(torch.from_numpy(pts), torch.from_numpy(idx))),
        np.asarray(jsam.gather_points(jnp.asarray(pts), jnp.asarray(idx))))


def _ball_setup(seed):
    """Centroids with empty, short and overfull balls (K=16, r=0.9)."""
    rng = np.random.RandomState(seed)
    xyz = rng.uniform(-1.5, 1.5, (2, 64, 3)).astype(np.float32)
    xyz[:, :24] = rng.normal(0, 0.2, (2, 24, 3))     # dense cluster
    cent = rng.uniform(-1.5, 1.5, (2, 8, 3)).astype(np.float32)
    cent[:, 0] = 0.0                                 # overfull
    cent[:, 1] = 10.0                                # empty
    return cent, xyz


def test_pairwise_sqdist():
    cent, xyz = _ball_setup(0)
    np.testing.assert_allclose(
        n(tgrp.pairwise_sqdist(torch.from_numpy(cent),
                               torch.from_numpy(xyz))),
        np.asarray(jgrp.pairwise_sqdist(jnp.asarray(cent), jnp.asarray(xyz))),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("k", [16, 5])
def test_ball_query(k):
    cent, xyz = _ball_setup(1)
    ji, jc = jgrp.ball_query(jnp.asarray(cent), jnp.asarray(xyz), 0.9, k)
    ti, tc = tgrp.ball_query(torch.from_numpy(cent), torch.from_numpy(xyz),
                             0.9, k)
    counts = np.asarray(jc)
    assert counts.min() == 0 and counts.max() > k and (
        (counts > 0) & (counts < k)).any()
    np.testing.assert_array_equal(n(ti), np.asarray(ji))
    np.testing.assert_array_equal(n(tc), counts)


@pytest.mark.parametrize("include_xyz", [True, False])
def test_ball_query_group(include_xyz):
    cent, xyz = _ball_setup(2)
    feats = np.random.RandomState(5).normal(size=(2, 64, 6)).astype(
        np.float32)
    jg, jc = jgrp.ball_query_group(jnp.asarray(cent), jnp.asarray(xyz),
                                   jnp.asarray(feats), 0.9, 16,
                                   include_xyz=include_xyz)
    tg, tc = tgrp.ball_query_group(torch.from_numpy(cent),
                                   torch.from_numpy(xyz),
                                   torch.from_numpy(feats), 0.9, 16,
                                   include_xyz=include_xyz)
    np.testing.assert_array_equal(n(tg), np.asarray(jg))  # exact gather
    np.testing.assert_array_equal(n(tc), np.asarray(jc))


def test_grouped_payload_bf16():
    cent, xyz = _ball_setup(4)
    pay = np.random.RandomState(6).normal(size=(2, 64, 8)).astype(
        np.float32)
    jg, _ = jgrp.grouped_payload(jnp.asarray(cent), jnp.asarray(xyz),
                                 jnp.asarray(pay).astype(jnp.bfloat16),
                                 0.9, 16)
    tg, _ = tgrp.grouped_payload(torch.from_numpy(cent),
                                 torch.from_numpy(xyz),
                                 torch.from_numpy(pay).bfloat16(), 0.9, 16)
    assert tg.dtype == torch.bfloat16
    np.testing.assert_array_equal(n(tg), n(jg))


@pytest.mark.parametrize("n_support", [1, 2, 30])
def test_three_nn_and_interpolate(n_support):
    rng = np.random.RandomState(n_support)
    q = rng.normal(size=(2, 17, 3)).astype(np.float32)
    s = rng.normal(size=(2, n_support, 3)).astype(np.float32)
    s[:, -1] = q[:, 0]                      # a query on a support point
    f = rng.normal(size=(2, n_support, 5)).astype(np.float32)
    jd, ji = jint.three_nn(jnp.asarray(q), jnp.asarray(s))
    td, ti = tint.three_nn(torch.from_numpy(q), torch.from_numpy(s))
    np.testing.assert_array_equal(n(ti), np.asarray(ji))
    np.testing.assert_allclose(n(td), np.asarray(jd), rtol=1e-6, atol=1e-6)
    jo = jint.three_interpolate(jnp.asarray(f), ji, jd)
    to = tint.three_interpolate(torch.from_numpy(f), ti, td)
    assert to.dtype == torch.float32
    np.testing.assert_allclose(n(to), np.asarray(jo), rtol=1e-5, atol=1e-5)


def test_three_interpolate_bf16_features_give_f32():
    rng = np.random.RandomState(9)
    q = rng.normal(size=(1, 9, 3)).astype(np.float32)
    s = rng.normal(size=(1, 6, 3)).astype(np.float32)
    f = rng.normal(size=(1, 6, 4)).astype(np.float32)
    jd, ji = jint.three_nn(jnp.asarray(q), jnp.asarray(s))
    jo = jint.three_interpolate(jnp.asarray(f).astype(jnp.bfloat16), ji, jd)
    td, ti = tint.three_nn(torch.from_numpy(q), torch.from_numpy(s))
    to = tint.three_interpolate(t(jnp.asarray(f).astype(jnp.bfloat16)),
                                ti, td)
    assert to.dtype == torch.float32
    np.testing.assert_allclose(n(to), n(jo), rtol=1e-5, atol=1e-5)


def test_kernel_build_refuses_without_nvcc(monkeypatch, tmp_path):
    """No nvcc: building raises, nothing falls back to the plain twin."""
    from transferable3d_torch.ops import _build

    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.library()
    assert not (tmp_path / "build").exists()
    srcs, digest = _build._sources()
    assert {p.name for p in srcs} >= {"fps.cu", "sa_infer.cu",
                                      "ball_extract.cu"}
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ["-G"])
    assert _build._sources()[1] != digest  # flags are part of the key


def test_phase_clocks_are_a_build_of_their_own(monkeypatch):
    """T3D_KERNEL_CLOCKS=1 adds the define that compiles the phase clocks
    of K2, K4's gather, K5, K6/K7 and K8/K9 in, under another library name;
    unset, the flags are the plain ones."""
    from transferable3d_torch.ops import _build

    monkeypatch.delenv(_build.CLOCKS_ENV, raising=False)
    assert _build._flags() == _build.NVCC_FLAGS
    plain = _build._sources()[1]
    monkeypatch.setenv(_build.CLOCKS_ENV, "1")
    assert _build._flags() == _build.NVCC_FLAGS + ["-DT3D_KERNEL_CLOCKS"]
    assert _build._sources()[1] != plain
    for name, fn in (("sa_train_bwd.cu", "t3d_sa_bwd_clocks"),
                     ("sa_train_fwd.cu", "t3d_sa_fwd_clocks"),
                     ("sa_train_fwd.cu", "t3d_sa_extract_clocks"),
                     ("sa_infer.cu", "t3d_sa_infer_clocks"),
                     ("ball_extract.cu", "t3d_extract_bwd_clocks")):
        src = (_build.SRC_DIR / name).read_text()
        assert "#ifdef T3D_KERNEL_CLOCKS" in src and fn in src
