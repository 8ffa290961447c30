"""Carry the JAX package's parameters across to the port.

The inputs are ``mgnns_tpu`` pytrees with numpy leaves (for example
``jax.tree.map(np.asarray, params)``); the outputs are the port's trees of
float32/int tensors on ``device``.  Most layouts are shared and copy as they
are; the ResNet trunks change: HWIO conv weights become OIHW and each stage's
stacked ``rest`` blocks are unstacked into a list after its ``first`` block.
The transforms are pure rearrangements, so the same functions map a JAX
gradient tree onto the port's parameter layout exactly as they map the
parameters.
"""

from __future__ import annotations

import numpy as np
import torch

from mgnns_tpu_torch.utils import resolve_device, tree_map

# the parameters the forward reads; the JAX package's dead modules (GRU,
# gates, linear pyramids, another_mha, text head) never run and are not
# carried across
FUSION_KEYS = (
    "text_gcn", "embedding", "lstm", "liner_img_object", "liner_img_place",
    "gc1", "gc2", "object_attention", "place_attention", "object_linear_5",
    "object_x_linear", "place_linear_5", "place_x_linear",
    "img_object_text_mha", "img_place_text_mha", "text_img_object_mha",
    "text_img_place_mha", "multi_linear_1", "multi_linear_2", "object_A", "place_A",
)


def to_torch(tree, device="cuda"):
    """numpy leaves -> tensors on ``device`` (floats as float32)."""
    dev = resolve_device(device)

    def leaf(a):
        a = np.asarray(a)
        if np.issubdtype(a.dtype, np.floating):
            a = a.astype(np.float32)
        return torch.tensor(a, device=dev)

    return tree_map(leaf, tree)


def _first_leaf(tree):
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return np.asarray(tree)


def resnet_from_jax(tree: dict, device="cuda") -> dict:
    """A JAX ``resnet_init``-shaped trunk tree -- its params, its
    batch_stats, or a gradient of its params -- in the port's layout
    (:mod:`mgnns_tpu_torch.nn.resnet`)."""

    def node(name, v):
        if "conv" in name:                       # conv1..3, downsample_conv: HWIO -> OIHW
            return to_torch(np.asarray(v["w"]).transpose(3, 2, 0, 1), device)
        return to_torch(v, device)               # bn: {scale, bias} or {mean, var}

    def block(t):
        return {name: node(name, v) for name, v in t.items()}

    out = {name: node(name, v) for name, v in tree.items() if not name.startswith("layer")}
    li = 1
    while f"layer{li}" in tree:
        layer = tree[f"layer{li}"]
        blocks = [block(layer["first"])]
        if "rest" in layer:
            for i in range(_first_leaf(layer["rest"]).shape[0]):
                blocks.append(block(tree_map(lambda a: np.asarray(a)[i], layer["rest"])))  # noqa: B023
        out[f"layer{li}"] = blocks
        li += 1
    return out


def params_from_jax(params: dict, device="cuda") -> dict:
    """The fusion model's parameters -- or a gradient tree of the same shape
    -- for :func:`mgnns_tpu_torch.models.mgnns.mgnns_apply`."""
    out = {k: to_torch(params[k], device) for k in FUSION_KEYS}
    out["object_trunk"] = resnet_from_jax(params["object_trunk"], device)
    out["place_trunk"] = resnet_from_jax(params["place_trunk"], device)
    return out


def from_jax_params(params: dict, batch_stats: dict, consts: dict,
                    device="cuda") -> tuple[dict, dict, dict]:
    """The fusion model's (params, batch_stats, consts).  ``consts`` holds
    ``label_query`` (the JAX package's consts) and ``object_inp`` /
    ``place_inp`` (which the JAX package passes in the batch)."""
    stats = {k: resnet_from_jax(batch_stats[k], device) for k in ("object_trunk", "place_trunk")}
    consts_t = to_torch({k: consts[k] for k in ("label_query", "object_inp", "place_inp")}, device)
    return params_from_jax(params, device), stats, consts_t


def text_model_from_jax_params(params: dict, device="cuda") -> dict:
    """The text-only model's parameters (``text_gcn`` + ``head``)."""
    return to_torch({"text_gcn": params["text_gcn"], "head": params["head"]}, device)
