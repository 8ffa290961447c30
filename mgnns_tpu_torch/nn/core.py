"""Core primitives: linear, embedding, layer norm, leaky ReLU, dropout,
per-call-site generator streams, and the seeded initializers.

Port of the JAX package's ``mgnns_tpu/nn/core.py``.  Parameters keep that
package's layouts (a linear weight is ``[in, out]``) so converted weights are
used as they are.  Initializers reproduce the PyTorch defaults the reference
relies on, drawn from an explicit ``torch.Generator`` on the parameters'
device.  Dropout masks come from ``torch.Generator``s too, so they cannot
equal the JAX package's ``jax.random.bernoulli`` masks; the tests compare the
two packages at dropout 0 and test dropout on its own.
"""

from __future__ import annotations

import hashlib
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
# Generator streams


def derive_seed(seed: int, *parts) -> int:
    """A 63-bit seed from ``seed`` and any labels, stable across processes
    (not Python's salted ``hash``)."""
    key = "/".join(str(p) for p in (seed, *parts)).encode()
    return int.from_bytes(hashlib.blake2b(key, digest_size=8).digest(), "little") >> 1


class RngStream:
    """Hands out one dropout generator per call site, derived from a root
    generator's seed, a counter and the site's name (the counterpart of the
    JAX package's ``RngStream``).  A site's mask does not depend on how much
    randomness other sites drew.  ``next`` returns None without a root.

    Usage inside an apply function::

        rngs = RngStream(generator)
        x = dropout(x, 0.5, rngs.next("attn"), train)
    """

    def __init__(self, generator: torch.Generator | None):
        self._root = generator
        self._count = 0

    def next(self, name: str = "") -> torch.Generator | None:
        if self._root is None:
            return None
        self._count += 1
        seed = derive_seed(self._root.initial_seed(), self._count, name)
        return torch.Generator(device=self._root.device).manual_seed(seed)


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


# ---------------------------------------------------------------------------
# Dropout


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator | None,
            train: bool) -> torch.Tensor:
    """Inverted dropout; the identity when not training, at rate 0 or
    without a generator."""
    if not train or rate <= 0.0 or generator is None:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, 0.0)
