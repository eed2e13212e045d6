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

Entry points run on the card unless the caller asks for the CPU: a
constructor or data function called without `device` resolves it through
`resolve_device()`, that is `default_device()`, which raises on a
machine without an NVIDIA GPU instead of running on the CPU unasked. The
tests pass `device="cpu"`.
"""

__version__ = "0.1.0"


def default_device():
    """The current CUDA device; a RuntimeError where there is none."""
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError(
            "transferable3d_torch found no NVIDIA GPU "
            "(torch.cuda.is_available() is false); pass device=\"cpu\" to "
            "run on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def resolve_device(device=None):
    """`device` as a torch.device; None is the card (`default_device`)."""
    import torch

    return default_device() if device is None else torch.device(device)
