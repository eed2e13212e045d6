"""Model registry: name -> constructor (port of models/registry.py).

`register(name)` adds a constructor under a name, as in the JAX
package. A model built without `device` lands on the card
(`default_device`).
"""

from __future__ import annotations

from typing import Any, Callable, Dict

from transferable3d_torch.core import bins as bins_lib
from transferable3d_torch.models.boxpc import BoxPCFitNet
from transferable3d_torch.models.frustum_pointnet_v1 import (
    BoxEstimationOnly, FrustumPointNetV1)
from transferable3d_torch.models.frustum_pointnet_v2 import FrustumPointNetV2

_REGISTRY: Dict[str, Callable[..., Any]] = {
    "frustum_pointnets_v1": FrustumPointNetV1,
    "frustum_pointnets_v2": FrustumPointNetV2,
    "box_estimation_v1": BoxEstimationOnly,
    "boxpc_fit": BoxPCFitNet,
}


def register(name: str):
    """Decorator: register a constructor under `name`."""
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


def get_model(name: str, cfg: bins_lib.BinConfig, **kwargs):
    """Construct a model by registry name, e.g.
    get_model("frustum_pointnets_v2", SUNRGBD, dtype=torch.bfloat16)
    (on the card) or get_model(..., device="cpu")."""
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown model '{name}'; available: {sorted(_REGISTRY)}")
    return _REGISTRY[name](cfg=cfg, **kwargs)


def available() -> list:
    return sorted(_REGISTRY)
