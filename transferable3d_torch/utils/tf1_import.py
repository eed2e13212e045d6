"""One-way TF1 checkpoint -> parameter-tree importer (parity tool).

Port of `transferable3d_tpu/utils/tf1_import.py`, numpy only. The
variable-name map below encodes the expected TF1 layout of the lineage
(tf_util.conv2d '<scope>/weights|biases' + batch_norm
'<scope>/bn/{gamma,beta,moving_mean,moving_variance}'); `name_map`
overrides let it adapt to a real checkpoint, and `import_tf1_checkpoint`
fails loudly with the full unmatched-variable list rather than guessing.
It returns the JAX package's flax-shaped (params, batch_stats) numpy
trees; `load_tf1_checkpoint` loads them into a port model through the
weight bridge (`utils/bridge.load_flax_variables`).

Structural notes:
  * TF1 1x1-conv kernels are [1, 1, Cin, Cout] -> squeezed to [Cin, Cout]
    (the flax Dense layout; the bridge transposes them).
  * The seg head factors the reference's concat conv (SURVEY §3.3 conv
    after concat(point_feat 64, global 1024, one-hot K)) into
    mlp3_point (first 64 rows) + mlp3_global (remaining rows) — the
    importer splits the reference weight matrix accordingly; the bias
    goes to mlp3_point.

`tensorflow` is imported only where a checkpoint is read (`_reader`):
the card's machine does not promise it.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np


# v1 param paths -> expected TF1 scope names (instance seg stage).
# Layer widths follow SURVEY.md §3.3 / C6.
V1_CONV_MAP: Dict[str, str] = {
    "seg_net/mlp1/dense_0": "conv1",
    "seg_net/mlp1/dense_1": "conv2",
    "seg_net/mlp2/dense_0": "conv3",
    "seg_net/mlp2/dense_1": "conv4",
    "seg_net/mlp2/dense_2": "conv5",
    # conv6 is the concat conv: split into mlp3_point / mlp3_global.
    "seg_net/mlp3/dense_0": "conv7",
    "seg_net/mlp3/dense_1": "conv8",
    "seg_net/mlp3/dense_2": "conv9",
    "seg_net/seg_out": "conv10",
    "tnet/mlp/dense_0": "center_regression_net/conv-reg1-stage1",
    "tnet/mlp/dense_1": "center_regression_net/conv-reg2-stage1",
    "tnet/mlp/dense_2": "center_regression_net/conv-reg3-stage1",
    "tnet/head/fc_0": "center_regression_net/fc1-stage1",
    "tnet/head/fc_1": "center_regression_net/fc2-stage1",
    "tnet/head/out": "center_regression_net/fc3-stage1",
    "box_net/mlp/dense_0": "conv-reg1",
    "box_net/mlp/dense_1": "conv-reg2",
    "box_net/mlp/dense_2": "conv-reg3",
    "box_net/mlp/dense_3": "conv-reg4",
    "box_net/head/fc_0": "fc1",
    "box_net/head/fc_1": "fc2",
    "box_net/head/out": "fc3",
}
V1_CONCAT_CONV = "conv6"
V1_CONCAT_SPLIT = 64  # point-feature rows before the global/one-hot rows


def _set_path(tree: dict, path: List[str], value: np.ndarray) -> None:
    node = tree
    for k in path[:-1]:
        node = node.setdefault(k, {})
    node[path[-1]] = value


def _reader(ckpt_path: str):
    import tensorflow as tf

    return tf.train.load_checkpoint(ckpt_path)


def list_tf1_variables(ckpt_path: str) -> Dict[str, Tuple[int, ...]]:
    reader = _reader(ckpt_path)
    return {k: tuple(v) for k, v in
            reader.get_variable_to_shape_map().items()}


def import_tf1_checkpoint(
        ckpt_path: str,
        name_map: Optional[Dict[str, str]] = None,
        concat_conv: Optional[str] = V1_CONCAT_CONV,
        concat_split: int = V1_CONCAT_SPLIT,
        strict: bool = True,
        include_v1_map: bool = True,
) -> Tuple[dict, dict]:
    """Returns (params, batch_stats) numpy trees for FrustumPointNetV1,
    under the flax paths the weight bridge maps.

    `name_map` overrides/extends V1_CONV_MAP (param path -> TF scope).
    `include_v1_map=False` with `concat_conv=None` imports an arbitrary
    TF1 conv/fc checkpoint through `name_map` alone (used by the v2
    SA-MSG/FP parity twins, whose param trees have no concat conv).
    """
    reader = _reader(ckpt_path)
    available = set(reader.get_variable_to_shape_map())

    def get(name: str) -> Optional[np.ndarray]:
        for candidate in (name, name + ":0"):
            if candidate in available:
                available.discard(candidate)
                return np.asarray(reader.get_tensor(candidate))
        return None

    mapping = dict(V1_CONV_MAP) if include_v1_map else {}
    if name_map:
        mapping.update(name_map)

    params: dict = {}
    batch_stats: dict = {}
    missing: List[str] = []

    def pull(our_path: str, scope: str) -> None:
        w = get(f"{scope}/weights")
        b = get(f"{scope}/biases")
        if w is None:
            missing.append(f"{scope}/weights")
            return
        if w.ndim == 4:  # [1, 1, Cin, Cout] 1x1 conv
            w = w.reshape(w.shape[2], w.shape[3])
        path = our_path.split("/")
        _set_path(params, path + ["kernel"], w.astype(np.float32))
        if b is not None:
            _set_path(params, path + ["bias"], b.astype(np.float32))
        # BatchNorm siblings (absent for the final linear outputs).
        gamma = get(f"{scope}/bn/gamma")
        if gamma is not None:
            beta = get(f"{scope}/bn/beta")
            mean = get(f"{scope}/bn/moving_mean")
            var = get(f"{scope}/bn/moving_variance")
            # bn sits next to the dense layer: dense_i -> bn_i.
            bn_path = path[:-1] + [path[-1].replace("dense_", "bn_")
                                   .replace("fc_", "bn_")]
            _set_path(params, bn_path + ["scale"], gamma.astype(np.float32))
            _set_path(params, bn_path + ["bias"], beta.astype(np.float32))
            _set_path(batch_stats, bn_path + ["mean"],
                      mean.astype(np.float32))
            _set_path(batch_stats, bn_path + ["var"],
                      var.astype(np.float32))

    for our_path, scope in mapping.items():
        pull(our_path, scope)

    # The concat conv: split rows into point / global parts.
    w = get(f"{concat_conv}/weights") if concat_conv else None
    if concat_conv is None:
        pass
    elif w is not None:
        if w.ndim == 4:
            w = w.reshape(w.shape[2], w.shape[3])
        _set_path(params, ["seg_net", "mlp3_point", "kernel"],
                  w[:concat_split].astype(np.float32))
        _set_path(params, ["seg_net", "mlp3_global", "kernel"],
                  w[concat_split:].astype(np.float32))
        b = get(f"{concat_conv}/biases")
        if b is not None:
            _set_path(params, ["seg_net", "mlp3_point", "bias"],
                      b.astype(np.float32))
        gamma = get(f"{concat_conv}/bn/gamma")
        if gamma is not None:
            _set_path(params, ["seg_net", "mlp3_bn", "scale"],
                      gamma.astype(np.float32))
            _set_path(params, ["seg_net", "mlp3_bn", "bias"],
                      get(f"{concat_conv}/bn/beta").astype(np.float32))
            _set_path(batch_stats, ["seg_net", "mlp3_bn", "mean"],
                      get(f"{concat_conv}/bn/moving_mean").astype(
                          np.float32))
            _set_path(batch_stats, ["seg_net", "mlp3_bn", "var"],
                      get(f"{concat_conv}/bn/moving_variance").astype(
                          np.float32))
    else:
        missing.append(f"{concat_conv}/weights")

    if strict and missing:
        raise KeyError(
            "TF1 checkpoint import: missing variables "
            f"{missing}; checkpoint has (unclaimed): {sorted(available)}. "
            "Pass name_map= to adapt the scope mapping.")
    return params, batch_stats


def load_tf1_checkpoint(model, ckpt_path: str, **kw) -> Tuple[dict, dict]:
    """Import a TF1 checkpoint (`import_tf1_checkpoint(ckpt_path, **kw)`)
    and copy it into the port model `model` (a `torch.nn.Module`) in
    place, on the model's device; raises unless every imported leaf
    meets a model entry of its shape and every model entry is imported.
    Returns the imported (params, batch_stats)."""
    from transferable3d_torch.utils import bridge

    params, batch_stats = import_tf1_checkpoint(ckpt_path, **kw)
    bridge.load_flax_variables(model, params, batch_stats)
    return params, batch_stats
