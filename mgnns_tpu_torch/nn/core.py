"""Core primitives: linear, embedding, layer norm, leaky ReLU, and the
seeded initializers behind them.

Port of the JAX package's ``mgnns_tpu/nn/core.py``.  Parameters keep that
package's layouts (a linear weight is ``[in, out]``) so converted weights are
used as they are.  Initializers reproduce the PyTorch defaults the reference
relies on, drawn from an explicit ``torch.Generator`` on the parameters'
device.  Dropout is absent: the port runs eval forwards only.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def uniform(g: torch.Generator, shape, bound: float) -> torch.Tensor:
    """U(-bound, bound) float32 on the generator's device."""
    u = torch.rand(shape, generator=g, device=g.device, dtype=torch.float32)
    return u * (2 * bound) - bound


def normal(g: torch.Generator, shape, std: float = 1.0) -> torch.Tensor:
    return std * torch.randn(shape, generator=g, device=g.device, dtype=torch.float32)


def as_param(a: np.ndarray, g: torch.Generator) -> torch.Tensor:
    """A copy of a given numpy array as a float32 tensor on the generator's
    device."""
    return torch.tensor(np.asarray(a, np.float32), device=g.device)


# ---------------------------------------------------------------------------
# Linear


def linear_init(g: torch.Generator, in_dim: int, out_dim: int, w_init="torch") -> dict:
    """``w_init``: 'torch' (U(+-1/sqrt(in))), 'xavier_normal', or
    ('normal', std).  Weight ``[in, out]``, bias U(+-1/sqrt(in))."""
    if w_init == "torch":
        w = uniform(g, (in_dim, out_dim), 1.0 / math.sqrt(in_dim))
    elif w_init == "xavier_normal":
        w = normal(g, (in_dim, out_dim), math.sqrt(2.0 / (in_dim + out_dim)))
    elif isinstance(w_init, tuple) and w_init[0] == "normal":
        w = normal(g, (in_dim, out_dim), w_init[1])
    else:
        raise ValueError(f"unknown w_init {w_init!r}")
    return {"w": w, "b": uniform(g, (out_dim,), 1.0 / math.sqrt(in_dim))}


def linear(p: dict, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


# ---------------------------------------------------------------------------
# Embedding


def embedding_init(g: torch.Generator, vocab_size: int, dim: int, padding_idx: int = 0) -> dict:
    """N(0,1) like ``nn.Embedding``, with the padding row zeroed."""
    table = normal(g, (vocab_size, dim))
    table[padding_idx] = 0.0
    return {"table": table}


def embedding(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    return table[ids]


# ---------------------------------------------------------------------------
# LayerNorm (torch-std flavor used by the reference)


def layer_norm_init(dim: int, device) -> dict:
    return {"gamma": torch.ones(dim, device=device), "beta": torch.zeros(dim, device=device)}


def layer_norm(p: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """``gamma * (x - mean) / (std + eps) + beta`` with the *unbiased* std
    and eps added to the std (reference ``models/submodules.py:153-156``),
    which ``nn.LayerNorm`` does not compute."""
    mean = x.mean(-1, keepdim=True)
    n = x.shape[-1]
    var = ((x - mean) ** 2).sum(-1, keepdim=True) / max(n - 1, 1)
    return p["gamma"] * (x - mean) / (torch.sqrt(var) + eps) + p["beta"]


# ---------------------------------------------------------------------------
# Activations


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.2) -> torch.Tensor:
    return torch.where(x >= 0, x, negative_slope * x)
