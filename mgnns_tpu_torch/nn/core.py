"""Core primitives: linear, embedding, layer norm, leaky ReLU, dropout,
per-call-site generator streams, and the seeded initializers.

Port of the JAX package's ``mgnns_tpu/nn/core.py``.  Parameters keep that
package's layouts (a linear weight is ``[in, out]``) so converted weights are
used as they are.  Initializers reproduce the PyTorch defaults the reference
relies on, drawn from an explicit ``torch.Generator`` on the parameters'
device.  Dropout masks come from ``torch.Generator``s too, so they cannot
equal the JAX package's ``jax.random.bernoulli`` masks; the tests compare the
two packages at dropout 0 and test dropout on its own.

On a model axis (:mod:`mgnns_tpu_torch.parallel.sharding`) a parameter
leaf may be this rank's shard of the whole.  A model's apply function then
takes ``model=``, a :class:`~mgnns_tpu_torch.parallel.sharding.Shards`
view, hands each submodule its part (:func:`scope`) and asks it which
leaves are split (:func:`sharded`); :func:`linear` and :func:`embedding`
take the axis of a split leaf and run its collectives.  Without ``model``
every function here runs as it does on one device.
"""

from __future__ import annotations

import hashlib
import math

import numpy as np
import torch

from mgnns_tpu_torch.parallel.collectives import copy_to_model, reduce_from_model


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


class SiteGenerator(torch.Generator):
    """A generator of a :class:`SiteGenerators` tree: ``path`` is the chain
    of ``(count, name)`` call sites that leads to it from the root."""

    def __new__(cls, tree: "SiteGenerators", path: tuple, device):
        return super().__new__(cls, device=device)

    def __init__(self, tree: "SiteGenerators", path: tuple, device):
        self.tree = tree
        self.path = path


class SiteGenerators:
    """Dropout generators made once per call site and re-seeded per step.

    A step's model code asks :class:`RngStream` for one generator per call
    site; over this tree's ``root`` it gets the same :class:`SiteGenerator`
    object at every step, one per path of ``(count, name)`` pairs, seeded as
    a fresh generator would be: ``derive_seed(<parent's seed>, count,
    name)``.  :meth:`reseed` sets every known generator for the next step.
    A captured CUDA graph registers :meth:`generators` and reads their seeds
    and offsets at each replay, so a replay draws the masks that the same
    step draws eagerly.

    ``axis``: the data axis (:class:`~mgnns_tpu_torch.parallel.collectives.
    DataAxis`) of a step that runs on several ranks.  :func:`dropout` then
    draws each mask for the global batch and keeps this rank's rows, so N
    ranks apply the masks that one device draws for the global batch, as
    the JAX package does under SPMD.  The ranks of one data position on a
    model axis hold the same tree with the same seeds, so they draw the
    same masks."""

    def __init__(self, device, axis=None):
        self.device = torch.device(device)
        self.axis = axis
        self.root = SiteGenerator(self, (), self.device)
        self._nodes = {(): self.root}  # path -> generator, parents before children

    def child(self, parent: SiteGenerator, count: int, name: str) -> SiteGenerator:
        path = parent.path + ((count, name),)
        gen = self._nodes.get(path)
        if gen is None:
            gen = SiteGenerator(self, path, self.device)
            gen.manual_seed(derive_seed(parent.initial_seed(), count, name))
            self._nodes[path] = gen
        return gen

    def reseed(self, seed: int) -> None:
        """Seed the root with ``seed`` and every site below it as
        :class:`RngStream` derives it; offsets restart at 0."""
        seeds = {(): seed}
        self.root.manual_seed(seed)
        for path, gen in self._nodes.items():
            if path:
                seeds[path] = derive_seed(seeds[path[:-1]], *path[-1])
                gen.manual_seed(seeds[path])

    def generators(self) -> list[SiteGenerator]:
        return list(self._nodes.values())


class RngStream:
    """Hands out one dropout generator per call site, derived from a root
    generator's seed, a counter and the site's name (the counterpart of the
    JAX package's ``RngStream``).  A site's mask does not depend on how much
    randomness other sites drew.  ``next`` returns None without a root.  A
    root from :class:`SiteGenerators` hands out that tree's generators; any
    other root a new generator per call.

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
        if isinstance(self._root, SiteGenerator):
            return self._root.tree.child(self._root, self._count, name)
        seed = derive_seed(self._root.initial_seed(), self._count, name)
        return torch.Generator(device=self._root.device).manual_seed(seed)


# ---------------------------------------------------------------------------
# The model axis


def scope(model, *parts):
    """The view of the subtree ``parts`` of a model-axis view (None: no axis)."""
    return None if model is None else model.at(*parts)


def sharded(model, name: str):
    """The model axis when leaf ``name`` of the view is split over it, else None."""
    return None if model is None else model.axis_of(name)


# ---------------------------------------------------------------------------
# Linear


def linear_init(g: torch.Generator, in_dim: int, out_dim: int, w_init="torch",
                bias: bool = True) -> dict:
    """``w_init``: 'torch' (U(+-1/sqrt(in))), 'xavier_normal', or
    ('normal', std).  Weight ``[in, out]``, bias U(+-1/sqrt(in)) unless
    ``bias`` is False."""
    if w_init == "torch":
        w = uniform(g, (in_dim, out_dim), 1.0 / math.sqrt(in_dim))
    elif w_init == "xavier_normal":
        w = normal(g, (in_dim, out_dim), math.sqrt(2.0 / (in_dim + out_dim)))
    elif isinstance(w_init, tuple) and w_init[0] == "normal":
        w = normal(g, (in_dim, out_dim), w_init[1])
    else:
        raise ValueError(f"unknown w_init {w_init!r}")
    if not bias:
        return {"w": w}
    return {"w": w, "b": uniform(g, (out_dim,), 1.0 / math.sqrt(in_dim))}


def linear(p: dict, x: torch.Tensor, *, column=None, row=None) -> torch.Tensor:
    """``x @ w + b``.  ``column``: the model axis when ``p`` is
    column-parallel (``w [in, out/N]``, ``b [out/N]``): ``x`` is replicated
    and the output holds this rank's columns.  ``row``: the model axis when
    ``p`` is row-parallel (``w [in/N, out]``, ``b`` whole): ``x`` is this
    rank's ``in/N`` columns of the input, or the whole input, of which the
    rank takes its slice; the partial products are summed over the axis and
    the bias is added once, after the sum."""
    if row is not None:
        n = p["w"].shape[0]
        if x.shape[-1] != n:
            x = copy_to_model(x, row).narrow(-1, row.rank * n, n)
        y = reduce_from_model(x @ p["w"], row)
    else:
        y = (x if column is None else copy_to_model(x, column)) @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


# ---------------------------------------------------------------------------
# Embedding


def embedding_init(g: torch.Generator, vocab_size: int, dim: int, padding_idx: int = 0,
                   weights: np.ndarray | None = None) -> dict:
    """N(0,1) like ``nn.Embedding``, or a copy of a pretrained ``weights``
    matrix [vocab_size, dim]; the padding row is zeroed either way."""
    if weights is None:
        table = normal(g, (vocab_size, dim))
    else:
        table = as_param(weights, g)
        if table.shape != (vocab_size, dim):
            raise ValueError(f"embedding weights of shape {tuple(table.shape)}, "
                             f"expected {(vocab_size, dim)}")
    table[padding_idx] = 0.0
    return {"table": table}


def embedding(table: torch.Tensor, ids: torch.Tensor, model=None) -> torch.Tensor:
    """``table[ids]``.  ``model``: the model axis when ``table`` is this
    rank's block of rows (vocab-parallel): ids outside the block gather
    zeros, and the sum over the axis holds every row once; the gradient
    reaches only the rows of the rank's block."""
    if model is None:
        return table[ids]
    rows = table.shape[0]
    local = ids.long() - model.rank * rows
    hit = (local >= 0) & (local < rows)
    out = table[torch.where(hit, local, 0)]
    return reduce_from_model(torch.where(hit[..., None], out, 0.0), model)


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
            train: bool, shard: tuple | None = None) -> torch.Tensor:
    """Inverted dropout; the identity when not training, at rate 0 or
    without a generator.  A generator of a :class:`SiteGenerators` tree with
    a data axis of N ranks draws the mask of the global batch ``[N * B,
    ...]`` and keeps this rank's rows ``[rank * B, (rank + 1) * B)``.
    ``shard``: ``(model axis, dim)`` when ``x`` is this rank's slice along
    ``dim`` of a tensor split over the model axis (attention heads); the
    mask is drawn for the whole tensor and the rank keeps its slice.  A
    replicated ``x`` gets the same mask on every rank of the model axis,
    whose generators are seeded alike."""
    if not train or rate <= 0.0 or generator is None:
        return x
    keep = 1.0 - rate
    axis = generator.tree.axis if isinstance(generator, SiteGenerator) else None
    shape = list(x.shape)
    if axis is not None and axis.size > 1:
        shape[0] *= axis.size
    if shard is not None:
        shape[shard[1]] *= shard[0].size
    u = torch.rand(shape, generator=generator, device=x.device)
    if axis is not None and axis.size > 1:
        B = x.shape[0]
        u = u[axis.rank * B:(axis.rank + 1) * B]
    if shard is not None:
        model, dim = shard
        u = u.narrow(dim, model.rank * x.shape[dim], x.shape[dim])
    return torch.where(u < keep, x / keep, 0.0)
