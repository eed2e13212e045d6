"""Model registry: name -> constructor (port of models/registry.py).

Only the v2 model is ported so far; v1, `box_estimation_v1` and
`boxpc_fit` follow (ROADMAP queue A).
"""

from __future__ import annotations

from typing import Any, Callable, Dict

from transferable3d_torch.core import bins as bins_lib
from transferable3d_torch.models.frustum_pointnet_v2 import FrustumPointNetV2

_REGISTRY: Dict[str, Callable[..., Any]] = {
    "frustum_pointnets_v2": FrustumPointNetV2,
}


def get_model(name: str, cfg: bins_lib.BinConfig, **kwargs):
    """Construct a model by registry name, e.g.
    get_model("frustum_pointnets_v2", SUNRGBD, dtype=torch.bfloat16,
    device="cuda")."""
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown model '{name}'; available: {sorted(_REGISTRY)}")
    return _REGISTRY[name](cfg=cfg, **kwargs)
