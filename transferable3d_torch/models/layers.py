"""Layer library: Dense, scheduled BatchNorm, shared per-point MLPs, FC heads.

Port of `transferable3d_tpu/models/layers.py`. Parameters and BN
statistics stay float32; `dtype` is the compute type (float32 or
bfloat16), applied where flax applies it:

* `Dense` rounds the product to `dtype` and then adds the bias in
  `dtype` (flax `nn.Dense(dtype=...)` casts input, kernel and bias to
  `dtype` and adds the bias after the dot);
* `ScheduledBatchNorm` normalizes in float32 and casts the result to
  `dtype`.

`dropout` is flax `nn.Dropout` in train mode. Its keep mask comes from
an explicit `torch.Generator`, never from torch's global generator,
through the module-level `dropout_keep_mask`, which a test can replace
to feed the JAX step's own mask.

Parameter and buffer names are the flax leaf names (`weight` stands for
the flax `kernel`, transposed to [out, in]) so `utils/bridge.py` maps a
flax variable tree onto `state_dict()` one to one.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn


def _init_device(device):
    return torch.device("cpu") if device is None else torch.device(device)


class Dense(nn.Module):
    """flax `nn.Dense` twin: weight [out, in] lecun-normal, zero bias."""

    def __init__(self, in_features: int, features: int, *,
                 dtype=torch.float32, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        # flax lecun_normal: truncated normal at +-2 std, std corrected
        # for the truncation (variance_scaling's 0.87962566 constant).
        std = math.sqrt(1.0 / in_features) / 0.87962566103423978
        w = torch.empty(features, in_features)
        nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                              generator=generator)
        dev = _init_device(device)
        self.weight = nn.Parameter(w.to(dev))
        self.bias = nn.Parameter(torch.zeros(features, device=dev))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        y = torch.matmul(x.to(dt), self.weight.to(dt).t())
        return y + self.bias.to(dt)


class ScheduledBatchNorm(nn.Module):
    """BatchNorm with a call-time momentum, eps 1e-3, f32 statistics.

    Eval: y = (x_f32 - mean) * (1/sqrt(var + eps) * scale) + bias, cast
    to `dtype` (layers.py:53-67). Train: biased batch variance over all
    axes but the last, and running = m * running + (1 - m) * batch.
    """

    EPSILON = 1e-3  # TF1 batch_norm default, as in the JAX module

    def __init__(self, features: int, *, dtype=None, device=None):
        super().__init__()
        dev = _init_device(device)
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(features, device=dev))
        self.bias = nn.Parameter(torch.zeros(features, device=dev))
        self.register_buffer("mean", torch.zeros(features, device=dev))
        self.register_buffer("var", torch.ones(features, device=dev))

    def forward(self, x: torch.Tensor, momentum: float = 0.9
                ) -> torch.Tensor:
        xf = x.float()
        if self.training:
            axes = tuple(range(x.dim() - 1))
            mean = xf.mean(dim=axes)
            var = (xf * xf).mean(dim=axes) - mean * mean
            with torch.no_grad():
                self.mean.mul_(momentum).add_((1.0 - momentum) * mean)
                self.var.mul_(momentum).add_((1.0 - momentum) * var)
        else:
            mean, var = self.mean, self.var
        inv = torch.reciprocal(torch.sqrt(var + self.EPSILON)) * self.scale
        y = (xf - mean) * inv + self.bias
        return y.to(self.dtype or x.dtype)


class PointMLP(nn.Module):
    """Shared per-point MLP over [..., C]: (Dense -> BN -> ReLU) per layer,
    optionally ending in a max-pool over axis 1."""

    def __init__(self, in_features: int, features: Sequence[int], *,
                 pool: bool = False, dtype=torch.float32, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.pool = pool
        self.depth = len(features)
        f_in = in_features
        for i, f in enumerate(features):
            self.add_module(f"dense_{i}", Dense(
                f_in, f, dtype=dtype, device=device, generator=generator))
            self.add_module(f"bn_{i}", ScheduledBatchNorm(
                f, dtype=dtype, device=device))
            f_in = f

    def forward(self, x: torch.Tensor, bn_momentum: float = 0.9
                ) -> torch.Tensor:
        for i in range(self.depth):
            x = getattr(self, f"dense_{i}")(x)
            x = torch.relu(getattr(self, f"bn_{i}")(x, bn_momentum))
        if self.pool:
            x = masked_max_pool(x)
        return x


class MLPHead(nn.Module):
    """FC stack (Dense -> BN -> ReLU per layer) + a float32 projection."""

    def __init__(self, in_features: int, features: Sequence[int],
                 out_features: int, *, dtype=torch.float32, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.depth = len(features)
        f_in = in_features
        for i, f in enumerate(features):
            self.add_module(f"fc_{i}", Dense(
                f_in, f, dtype=dtype, device=device, generator=generator))
            self.add_module(f"bn_{i}", ScheduledBatchNorm(
                f, dtype=dtype, device=device))
            f_in = f
        # Final projection in fp32: logits / regressions feed losses.
        self.out = Dense(f_in, out_features, dtype=torch.float32,
                         device=device, generator=generator)

    def forward(self, x: torch.Tensor, bn_momentum: float = 0.9
                ) -> torch.Tensor:
        for i in range(self.depth):
            x = getattr(self, f"fc_{i}")(x)
            x = torch.relu(getattr(self, f"bn_{i}")(x, bn_momentum))
        return self.out(x)


def dropout_keep_mask(shape, rate: float, generator: torch.Generator
                      ) -> torch.Tensor:
    """Bool keep mask of `shape`, each entry kept with probability
    1 - rate, drawn on the generator's device (a CPU generator gives the
    same mask whatever device the activations are on)."""
    return (torch.rand(shape, generator=generator, device=generator.device)
            < 1.0 - rate)


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator
            ) -> torch.Tensor:
    """flax `nn.Dropout(rate)` in train mode: where(keep, x / (1 - rate),
    0); at rate 0.5 the scaling by 2 is exact in bf16."""
    keep = dropout_keep_mask(tuple(x.shape), rate, generator).to(x.device)
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def masked_max_pool(x: torch.Tensor, mask: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """Max-pool [B, N, C] over the points axis; points with mask 0 never
    win."""
    if mask is not None:
        neg = torch.tensor(-1e9, dtype=x.dtype, device=x.device)
        x = torch.where(mask[..., None] > 0, x, neg)
    return x.amax(dim=1)
