"""Build and bind the port's CUDA kernels (csrc/*.cu) at first use.

`nvcc` compiles each of the six sources under
`transferable3d_torch/csrc/` (fps, sa_infer, ball_extract, sa_train_fwd,
sa_train_bwd, fetch_select: ten kernels) for Hopper (`sm_90a`) into an
object file, one process per source, all started together; one more `nvcc` links the objects into a single shared
library with a plain C interface, which is loaded with ctypes. The
library lands in `transferable3d_torch/_build/` (git-ignored) under a
name that carries a hash of the sources, the shared headers and the
flags, so an edited source is rebuilt and an unchanged one is reused
within a checkout. With `T3D_KERNEL_CLOCKS=1` in the environment
K2, K4's gather, K5, K6/K7, K8/K9 and K15 are compiled with their phase
clocks, as a library of its own name. Nothing here runs at import time: the CPU tests import every
module on machines without `nvcc`.

Each C entry point launches on the stream it is given, does not
synchronise, and returns `cudaGetLastError()`; `check()` raises on a
nonzero code. Launch counts live in `LAUNCHES`, one plain integer per
kernel, incremented by the wrappers right after a launch and nowhere
else; beside them `fused_sa_rerouted` counts the set-abstraction scales
that `fused_sa.fused_route` sent from the fused branch to the unfused one.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-lineinfo",
              *ARCH]
# Set to "1" before the first build of a process, this compiles K2, K4's
# gather, K5, K6/K7, K8/K9 and K15 with their phase clocks
# (scripts/torch_time_sa_fwd.py, torch_time_sa_bwd.py and
# torch_time_fetch.py, --phases).
CLOCKS_ENV = "T3D_KERNEL_CLOCKS"

LAUNCHES = {"fps": 0, "sa_infer": 0, "extract_fwd": 0, "extract_bwd": 0,
            "sa_extract": 0, "sa_fwd_step": 0, "sa_fwd_last": 0,
            "sa_bwd_step": 0, "sa_bwd_step0": 0, "fetch_select": 0,
            "fused_sa_rerouted": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures: every pointer and the stream as c_void_p (a bare Python
# int would be passed as a 32-bit int and cut the pointer).
_SIGNATURES = {
    # xyz, out_idx, B, N, K, threads, points a thread, stream
    "t3d_fps": [_P, _P, _I, _I, _I, _I, _I, _P],
    # cent, xyz, pf, qc, params, pooled, B, S, N, K, depth, dims (host
    # int array), r2, stream
    "t3d_sa_infer": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _F,
                     _P],
    # cent, xyz, pf, qc, W_d, packs, biases (host pointer arrays), pooled,
    # B, S, N, K, depth, the kernel's and the chain's widths (host int
    # arrays), grid, r2, stream
    "t3d_sa_infer_mma": [_P] * 8 + [_I] * 5 + [_P, _P, _I, _F, _P],
    # cent, xyz, payload, out, count, B, S, N, K, C, r2, stream
    "t3d_extract_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P],
    # cent, xyz, dg, membership scratch, dpay, B, S, N, K, C, r2, stream
    "t3d_extract_bwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P],
    # cent, xyz, pf, qc, z1, partials, sums, B, S, N, K, F0, r2, warps a
    # block, channels an access, grid, stream
    "t3d_sa_extract": [_P] * 7 + [_I] * 5 + [_F, _I, _I, _I, _P],
    # z_prev, pack, f32 W (or bf16 W^T), bias, z_next, partials, sums, zmax,
    # zmin, centroids, K, F_in, F_out, last, centroids per tile, stages,
    # W in shared memory, grid, stream
    "t3d_sa_fwd_step": [_P] * 9 + [_I] * 9 + [_P],
    # z_j, z_j1, dy_j1, pooled, dpooled, pack_j, pack_j1, bf16 W, cent,
    # xyz, qc, dy_j, partials, sums, scatter workspace, per-centroid
    # sums, B, S, N, K, F_j, F_j1, r2, train, top, step0, centroids per
    # tile, stages, W in shared memory, grid, stream
    "t3d_sa_bwd_step": [_P] * 19 + [_I] * 6 + [_F] + [_I] * 7 + [_P],
    # pts, inside (bytes), u, perm, sampled, idx, count, F, MB, N, C,
    # npoints, blocks a frustum, words a block, mask bytes a load, stream
    "t3d_fetch_select": [_P] * 7 + [_I] * 8 + [_P],
}

_lock = threading.Lock()
_lib = None
build_seconds = None  # wall time of the build in this process, if any


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels of "
        "transferable3d_torch cannot be built on this machine")


def _flags():
    if os.environ.get(CLOCKS_ENV) == "1":
        return NVCC_FLAGS + ["-DT3D_KERNEL_CLOCKS"]
    return NVCC_FLAGS


def _sources():
    srcs = sorted(SRC_DIR.glob("*.cu"))
    deps = srcs + sorted(SRC_DIR.glob("*.cuh"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {SRC_DIR}")
    h = hashlib.sha256(" ".join(_flags()).encode())
    for p in deps:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return srcs, h.hexdigest()[:16]


def _run_all(cmds) -> None:
    """Run the commands as parallel processes; raise with the output of
    every one that failed."""
    procs = [(cmd, subprocess.Popen(
        [str(a) for a in cmd], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)) for cmd in cmds]
    errors = []
    for cmd, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append("nvcc failed (" + " ".join(map(str, cmd))
                          + "):\n" + log)
    if errors:
        raise RuntimeError("\n".join(errors))


def library() -> ctypes.CDLL:
    """The kernels' shared library, built on first call."""
    global _lib, build_seconds
    with _lock:
        if _lib is not None:
            return _lib
        srcs, digest = _sources()
        so = BUILD_DIR / f"libt3d_kernels_{digest}.so"
        if not so.exists():
            t0 = time.perf_counter()
            nvcc = _nvcc()
            work = BUILD_DIR / f"obj_{digest}_{os.getpid()}"
            work.mkdir(parents=True, exist_ok=True)
            objs = [work / f"{src.stem}.o" for src in srcs]
            _run_all([[nvcc, *_flags(), "-I", SRC_DIR, "-c", "-o", obj,
                       src] for src, obj in zip(srcs, objs)])
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            _run_all([[nvcc, "-shared", *ARCH, "-o", tmp, *objs]])
            os.replace(tmp, so)
            shutil.rmtree(work)
            build_seconds = time.perf_counter() - t0
        lib = ctypes.CDLL(str(so))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
        return lib


def check(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} at launch")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
