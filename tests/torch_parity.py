"""Shared helpers for the PyTorch-port parity tests (tests/test_torch_*.py).

Both packages get the same numpy inputs; JAX stays on the CPU (see
conftest.py) and the port runs its plain twins on CPU tensors. Flax
variables cross over as nested dicts of numpy arrays through
`transferable3d_torch.utils.bridge`.
"""

from __future__ import annotations

import jax
import numpy as np
import torch

from transferable3d_torch.utils.bridge import load_flax_variables


def to_numpy_tree(tree):
    """jax pytree of mappings -> nested dicts of numpy arrays."""
    if hasattr(tree, "items"):
        return {k: to_numpy_tree(v) for k, v in tree.items()}
    return np.array(jax.device_get(tree))


def perturb_stats(batch_stats, rng: np.random.RandomState):
    """BN running statistics moved away from 0/1 so no layer is an
    identity: mean ~ N(0, 0.2), var ~ U(0.5, 2)."""
    out = {}
    for k, v in batch_stats.items():
        if hasattr(v, "items"):
            out[k] = perturb_stats(v, rng)
        elif k == "mean":
            out[k] = rng.normal(0, 0.2, np.shape(v)).astype(np.float32)
        elif k == "var":
            out[k] = rng.uniform(0.5, 2.0, np.shape(v)).astype(np.float32)
        else:
            raise KeyError(k)
    return out


def init_flax(module, rng_seed: int, *args, **kwargs):
    """Jitted flax init -> (params, batch_stats) as numpy trees, with the
    batch statistics perturbed (numpy RandomState(rng_seed))."""
    variables = jax.jit(lambda *a: module.init(
        jax.random.PRNGKey(rng_seed), *a, **kwargs))(*args)
    variables = to_numpy_tree(variables)
    stats = variables.get("batch_stats", {})
    return (variables["params"],
            perturb_stats(stats, np.random.RandomState(rng_seed + 1000)))


def bridged(torch_module, params, batch_stats):
    load_flax_variables(torch_module, params, batch_stats)
    return torch_module.eval()


def t(x):
    """numpy / jax array -> CPU torch tensor (bf16 via float32)."""
    arr = np.asarray(jax.device_get(x))
    if arr.dtype == jax.numpy.bfloat16:
        return torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def n(x):
    """torch tensor or jax array -> float32/int numpy array."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.float() if x.is_floating_point() else x).numpy()
    arr = np.asarray(jax.device_get(x))
    return arr.astype(np.float32) if arr.dtype == jax.numpy.bfloat16 else arr

