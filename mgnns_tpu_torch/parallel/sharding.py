"""The model axis: which parameters shard, and how a rank holds its shard.

Port of the JAX package's ``mgnns_tpu/parallel/sharding.py``.  The rules
are the same regexes over the same tree paths (:func:`mgnns_tpu_torch.
utils.tree_paths`, without the leading ``/``), and a spec is the tuple of a
``PartitionSpec``'s entries: ``("model", None)`` splits the rows over the
``'model'`` axis, ``(None, "model")`` the columns, ``()`` replicates.

- the text-GCN node and edge tables and the vocabulary embedding shard
  their rows (vocab-parallel gathers);
- the attention q/k/v projections and the FFN's ``w_1`` are
  column-parallel, ``fc`` and ``w_2`` row-parallel; ``gc1``/``gc2`` are a
  column/row pair; ``liner_img_*`` and ``multi_linear_1`` are row-parallel;
- everything else, the trunks, the LSTM and the label attention included,
  is replicated.

The fallback is the JAX package's, leaf for leaf: a gather table whose row
count does not divide the axis is zero-padded up to the next multiple (the
reference vocabulary of 20,153 rows becomes 20,154 at model 2), and any
other leaf whose split does not divide is replicated.

There XLA's SPMD partitioner inserts every collective.  Here each rank
holds its shard as a plain tensor, and the model's layers call the model
axis's collectives themselves (:mod:`mgnns_tpu_torch.parallel.collectives`),
told by a :class:`Shards` which leaves are split.  One deliberate
difference: where a column split would cut through an attention head
(``heads`` does not divide the axis), the port replicates the q/k/v
projections and their row-parallel partner ``fc``.  XLA can split a head;
written-out collectives would have to sum each head's partial scores.

A placement is declared, not carried: :func:`shard_tree` returns the
rank's local tensors and each leaf's :class:`Placement`, and
:func:`unshard_tree` gathers whole leaves back without their padding rows
(checkpoints and the reference ``state_dict`` export hold those).
"""

from __future__ import annotations

import dataclasses
import re

import torch
import torch.distributed as dist

from mgnns_tpu_torch.utils import tree_leaves, tree_paths, tree_unflatten

MODEL = "model"


def mgnns_param_rules() -> list[tuple[str, tuple]]:
    return [
        (r"text_gcn/node_embedding", (MODEL, None)),
        (r"text_gcn/edge_weight", (MODEL, None)),
        (r"embedding/table", (MODEL, None)),
        (r".*mha.*/slf_attn/w_[qkv]s/w", (None, MODEL)),
        (r".*mha.*/slf_attn/w_[qkv]s/b", (MODEL,)),
        (r".*mha.*/slf_attn/fc/w", (MODEL, None)),
        (r".*mha.*/pos_ffn/w_1/w", (None, MODEL)),
        (r".*mha.*/pos_ffn/w_1/b", (MODEL,)),
        (r".*mha.*/pos_ffn/w_2/w", (MODEL, None)),
        (r"gc1/w", (None, MODEL)),
        (r"gc2/w", (MODEL, None)),
        (r"liner_img_(object|place)/w", (MODEL, None)),
        (r"multi_linear_1/w", (MODEL, None)),
    ]


def text_model_param_rules() -> list[tuple[str, tuple]]:
    return [
        (r"text_gcn/node_embedding", (MODEL, None)),
        (r"text_gcn/edge_weight", (MODEL, None)),
    ]


def resolve_spec(path: str, rules: list[tuple[str, tuple]]) -> tuple:
    """The spec of the first rule whose regex matches all of ``path``."""
    path = path.lstrip("/")
    for pattern, spec in rules:
        if re.fullmatch(pattern, path):
            return spec
    return ()


# gather tables, zero-padded to a multiple of the axis: ids never reach the
# padding rows, so they get zero gradients and stay zero
_PADDABLE_TABLES = (r"text_gcn/node_embedding", r"text_gcn/edge_weight", r"embedding/table")
# the leaves a column split would cut through attention heads
_HEAD_LEAVES = (r".*mha.*/slf_attn/w_[qkv]s/[wb]", r".*mha.*/slf_attn/fc/w")


def _matches(path: str, patterns) -> bool:
    return any(re.fullmatch(p, path) for p in patterns)


@dataclasses.dataclass(frozen=True)
class Placement:
    """How one leaf lies on the model axis: ``spec`` after the fallback
    (``()`` replicated) and the whole leaf's unpadded ``shape``."""

    spec: tuple
    shape: tuple

    @property
    def dim(self) -> int | None:
        """The dimension split over the axis, or None when replicated."""
        return self.spec.index(MODEL) if MODEL in self.spec else None


def place(path: str, shape, size: int, rules, heads: int | None = None) -> Placement:
    """The placement of a leaf of ``shape`` at ``path`` on a model axis of
    ``size`` ranks (``shard_pytree``'s fallback; see the module's
    docstring).  ``heads``: the attention's head count, for the head rule."""
    path = path.lstrip("/")
    spec = resolve_spec(path, rules)
    for dim, name in enumerate(spec):
        if name is None:
            continue
        if dim >= len(shape) or (shape[dim] % size
                                 and not (dim == 0 and _matches(path, _PADDABLE_TABLES))):
            spec = ()
            break
    if spec and heads is not None and heads % size and _matches(path, _HEAD_LEAVES):
        spec = ()
    return Placement(spec=tuple(spec), shape=tuple(shape))


def pad_dim_to_multiple(t: torch.Tensor, dim: int, multiple: int) -> torch.Tensor:
    """Zero-pad ``t`` along ``dim`` up to the next multiple."""
    rem = t.shape[dim] % multiple
    if rem == 0:
        return t
    pad = list(t.shape)
    pad[dim] = multiple - rem
    return torch.cat([t, t.new_zeros(pad)], dim=dim)


def shard_tensor(t: torch.Tensor, placement: Placement, rank: int, size: int) -> torch.Tensor:
    """Rank ``rank``'s shard of the whole leaf ``t`` (a copy), padded first
    where the placement pads; ``t`` itself when replicated."""
    dim = placement.dim
    if dim is None or size == 1:
        return t
    t = pad_dim_to_multiple(t, dim, size)
    n = t.shape[dim] // size
    return t.narrow(dim, rank * n, n).clone()


def shard_leaves(leaves: list, placements: list[Placement], axis) -> list:
    return [shard_tensor(t, p, axis.rank, axis.size) for t, p in zip(leaves, placements)]


def refuse_encoder(params, where: str) -> None:
    """Raise ``NotImplementedError`` when ``params`` hold a MoE text
    encoder: its experts are held one share a card, and exchanging tokens
    with the cards that hold the others is not written yet."""
    if isinstance(params, dict) and "encoder" in params:
        raise NotImplementedError(
            f"the MoE text encoder cannot run on {where} yet: it has no sharding rules, and "
            "the exchange of tokens with the cards that hold the other experts is not "
            "implemented; run it on one card")


def shard_tree(tree, axis, rules, heads: int | None = None):
    """(this rank's tree, {path: Placement}) of a tree of whole leaves on the
    model ``axis`` (a :class:`~mgnns_tpu_torch.parallel.collectives.
    ModelAxis`, or anything with its ``rank`` and ``size``).  A MoE text
    encoder (an ``encoder`` subtree) has no rules yet and is refused."""
    refuse_encoder(tree, "a model axis")
    paths = [p.lstrip("/") for p in tree_paths(tree)]
    leaves = tree_leaves(tree)
    placements = [place(p, tuple(t.shape), axis.size, rules, heads)
                  for p, t in zip(paths, leaves)]
    return (tree_unflatten(tree, shard_leaves(leaves, placements, axis)),
            dict(zip(paths, placements)))


def unshard_leaves(leaves: list, placements: list[Placement], axis) -> list:
    """The whole leaves, without padding rows, on every rank of the model
    ``axis``: one all-reduce of every sharded leaf per dtype, each rank's
    shards in its slot (a collective)."""
    out = list(leaves)
    split = [i for i, p in enumerate(placements) if p.dim is not None]
    if axis.size == 1 or not split:
        return out
    by_dtype: dict = {}
    for i in split:
        by_dtype.setdefault(leaves[i].dtype, []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([leaves[i].reshape(-1) for i in idx])
        slots = flat.new_zeros((axis.size, flat.numel()))
        slots[axis.rank] = flat
        dist.all_reduce(slots, group=axis.group)
        at = 0
        for i in idx:
            t, p = leaves[i], placements[i]
            parts = [slots[r, at:at + t.numel()].view(t.shape) for r in range(axis.size)]
            at += t.numel()
            out[i] = torch.cat(parts, dim=p.dim).narrow(p.dim, 0, p.shape[p.dim]).clone()
    return out


def unshard_tree(tree, placements: dict, axis):
    """The whole tree of this rank's ``tree`` (see :func:`unshard_leaves`)."""
    paths = [p.lstrip("/") for p in tree_paths(tree)]
    return tree_unflatten(tree, unshard_leaves(tree_leaves(tree),
                                               [placements[p] for p in paths], axis))


class Shards:
    """A model's view of the model axis: the axis, and the placement of
    each leaf under ``prefix``.  Model code asks :meth:`axis_of` whether a
    leaf is split (:func:`mgnns_tpu_torch.nn.core.sharded`), and hands a
    submodule its subtree's view (:meth:`at`, :func:`mgnns_tpu_torch.nn.
    core.scope`)."""

    def __init__(self, axis, placements: dict[str, Placement], prefix: str = ""):
        self.axis = axis
        self.placements = placements
        self.prefix = prefix

    def at(self, *parts) -> "Shards":
        return Shards(self.axis, self.placements,
                      self.prefix + "".join(f"{p}/" for p in parts))

    def axis_of(self, name: str):
        """The model axis when the leaf ``name`` (under this view's prefix)
        is split over it; None when it is replicated."""
        p = self.placements.get(self.prefix + name)
        return self.axis if p is not None and p.dim is not None and self.axis.size > 1 else None
