"""flax variables -> the port's `state_dict`.

The flax tree of the JAX package (`params` + `batch_stats`, nested
mappings of arrays, e.g. after `jax.device_get`) maps onto the port's
module tree one leaf to one entry:

* params `.../kernel` [in, out] -> `....weight` [out, in] (transposed);
* params `.../bias`, `.../scale` -> the same name;
* batch_stats `.../mean`, `.../var` -> the BN buffers of the same name.

The path is the flax module path joined with dots (flax and port
modules share names: `seg_net.sa1.mlp_0.dense_0.weight`). Loading
raises unless every leaf on both sides is used exactly once with the
same shape.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Dict, Iterator, Tuple

import numpy as np
import torch

_PARAM_LEAVES = {"kernel": "weight", "bias": "bias", "scale": "scale"}
_STAT_LEAVES = {"mean": "mean", "var": "var"}


def _leaves(tree: Mapping, prefix: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), np.array(v, dtype=np.float32)


def flax_to_state_dict(params: Mapping, batch_stats: Mapping
                       ) -> Dict[str, torch.Tensor]:
    """Flax params + batch_stats -> {port state_dict key: f32 tensor}."""
    out: Dict[str, torch.Tensor] = {}
    for tree, names in ((params, _PARAM_LEAVES), (batch_stats, _STAT_LEAVES)):
        for path, arr in _leaves(tree):
            leaf = path[-1]
            if leaf not in names:
                raise ValueError(f"unmapped flax leaf {'/'.join(path)}")
            if leaf == "kernel":
                if arr.ndim != 2:
                    raise ValueError(f"kernel {'/'.join(path)} is not 2-D")
                arr = arr.T
            key = ".".join(path[:-1] + (names[leaf],))
            if key in out:
                raise ValueError(f"two flax leaves map to {key}")
            out[key] = torch.from_numpy(np.ascontiguousarray(arr))
    return out


def load_flax_variables(model: torch.nn.Module, params: Mapping,
                        batch_stats: Mapping) -> None:
    """Copy a flax variable tree into `model` in place (on its device)."""
    sd = flax_to_state_dict(params, batch_stats)
    own = model.state_dict()
    missing = sorted(set(own) - set(sd))
    unused = sorted(set(sd) - set(own))
    if missing or unused:
        raise ValueError(f"flax/port trees differ: port entries without a "
                         f"flax leaf {missing}; flax leaves without a port "
                         f"entry {unused}")
    for k, v in sd.items():
        if tuple(v.shape) != tuple(own[k].shape):
            raise ValueError(f"{k}: flax shape {tuple(v.shape)} != port "
                             f"shape {tuple(own[k].shape)}")
    model.load_state_dict(
        {k: v.to(device=own[k].device, dtype=own[k].dtype)
         for k, v in sd.items()}, strict=True)
