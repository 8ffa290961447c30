"""Carry the JAX package's parameters across to the port.

The inputs are ``mgnns_tpu`` pytrees with numpy leaves (for example
``jax.tree.map(np.asarray, params)``); the outputs are the port's parameter
trees of float32/int tensors on ``device``.  Most layouts are shared and
copy as they are; the ResNet trunks change: HWIO conv weights become OIHW,
each stage's stacked ``rest`` blocks are unstacked into a list after its
``first`` block, and BatchNorm's parameters and running statistics merge
into one dict per layer.
"""

from __future__ import annotations

import numpy as np
import torch

from mgnns_tpu_torch.utils import resolve_device, tree_map

# the parameters the eval forward reads; the JAX package's dead modules
# (GRU, gates, linear pyramids, another_mha, text head) never run and are
# not carried across
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


def _block(p: dict, s: dict, device) -> dict:
    out = {}
    for name, v in p.items():
        if "conv" in name:                       # conv1..3, downsample_conv
            out[name] = to_torch(np.asarray(v["w"]).transpose(3, 2, 0, 1), device)
        else:                                    # bn1..3, downsample_bn
            out[name] = to_torch({**v, **s[name]}, device)
    return out


def resnet_from_jax(params: dict, stats: dict, device="cuda") -> dict:
    """A JAX ``resnet_init``-shaped (params, batch_stats) pair -> the port's
    trunk parameters (:mod:`mgnns_tpu_torch.nn.resnet`)."""
    out = {"conv1": to_torch(np.asarray(params["conv1"]["w"]).transpose(3, 2, 0, 1), device),
           "bn1": to_torch({**params["bn1"], **stats["bn1"]}, device)}
    li = 1
    while f"layer{li}" in params:
        lp, ls = params[f"layer{li}"], stats[f"layer{li}"]
        blocks = [_block(lp["first"], ls["first"], device)]
        if "rest" in lp:
            n = np.asarray(lp["rest"]["conv1"]["w"]).shape[0]
            for i in range(n):
                pick = lambda t: tree_map(lambda a: np.asarray(a)[i], t)  # noqa: E731
                blocks.append(_block(pick(lp["rest"]), pick(ls["rest"]), device))
        out[f"layer{li}"] = blocks
        li += 1
    return out


def from_jax_params(params: dict, batch_stats: dict, consts: dict,
                    device="cuda") -> tuple[dict, dict]:
    """The fusion model's (params, consts) for :func:`mgnns_tpu_torch.models.
    mgnns.mgnns_apply`.  ``consts`` holds ``label_query`` (the JAX package's
    consts) and ``object_inp`` / ``place_inp`` (which the JAX package passes
    in the batch)."""
    out = {k: to_torch(params[k], device) for k in FUSION_KEYS}
    out["object_trunk"] = resnet_from_jax(params["object_trunk"], batch_stats["object_trunk"], device)
    out["place_trunk"] = resnet_from_jax(params["place_trunk"], batch_stats["place_trunk"], device)
    consts_t = to_torch({k: consts[k] for k in ("label_query", "object_inp", "place_inp")}, device)
    return out, consts_t


def text_model_from_jax_params(params: dict, device="cuda") -> dict:
    """The text-only model's parameters (``text_gcn`` + ``head``)."""
    return to_torch({"text_gcn": params["text_gcn"], "head": params["head"]}, device)
