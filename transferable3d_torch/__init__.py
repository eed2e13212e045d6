"""PyTorch + CUDA port of transferable3d_tpu for NVIDIA Hopper (H100).

Module paths mirror the JAX package: the counterpart of
`transferable3d_tpu/ops/fused_sa.py` is `transferable3d_torch/ops/fused_sa.py`.
This package imports `torch` and never JAX or `transferable3d_tpu`; the few
constants and numpy helpers it shares with the JAX package are kept as
JAX-free copies (core/bins.py, core/geometry.py).

Every Pallas kernel on a ported path has a hand-written CUDA kernel under
`csrc/`, built at first use by `ops/_build.py`, and a plain PyTorch twin
in the same module. A wrapper takes the plain twin only for CPU tensors;
for CUDA tensors it launches the kernel or raises.
"""

__version__ = "0.1.0"
