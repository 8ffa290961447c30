"""Dense label-graph convolution for the image channels.

Port of the JAX package's ``mgnns_tpu/nn/image_gcn.py`` (reference
``models/Multi_GCN_Multihead_att.py:30-63``): ``out = adj @ (x @ W)`` with
U(+-1/sqrt(out_features)) init and no bias (as the model builds it).
"""

from __future__ import annotations

import math

import torch

from mgnns_tpu_torch.nn.core import linear, uniform


def graph_conv_init(g: torch.Generator, in_features: int, out_features: int) -> dict:
    return {"w": uniform(g, (in_features, out_features), 1.0 / math.sqrt(out_features))}


def graph_conv_apply(p: dict, x: torch.Tensor, adj: torch.Tensor, *, column=None,
                     row=None) -> torch.Tensor:
    """``adj @ (x @ w)``; ``column`` / ``row``: the model axis of a
    column- or row-parallel ``w`` (:func:`mgnns_tpu_torch.nn.core.linear`)."""
    return adj @ linear(p, x, column=column, row=row)
