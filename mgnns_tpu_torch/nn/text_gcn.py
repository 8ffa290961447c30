"""Text-level GCN with edge-weighted max aggregation.

Port of the JAX package's ``mgnns_tpu/nn/text_gcn.py``: per position, the max
over the window's edge-weighted messages (kernel K1, with K2 as its backward,
:mod:`mgnns_tpu_torch.kernels.edge_max`), then per unique word the max over
its positions, summed over words, then dropout and ReLU (reference
``models/Text_GCN.py:242-275``).
"""

from __future__ import annotations

import numpy as np
import torch

from mgnns_tpu_torch.kernels import edge_max
from mgnns_tpu_torch.nn.core import as_param, dropout, embedding, normal


def text_gcn_init(g: torch.Generator, vocab_size: int, hidden_size: int, num_edges: int,
                  node_weights: np.ndarray | None = None,
                  edge_weights: np.ndarray | None = None) -> dict:
    """Node embeddings [V, D], N(0,1) or a copy of ``node_weights`` (the
    reference's GloVe, ``models/Text_GCN.py:76``), and an [E, 1] edge-weight
    table, all ones (the reference's trainable_edges=True, ``:68``) or a copy
    of ``edge_weights``."""
    node = normal(g, (vocab_size, hidden_size)) if node_weights is None else as_param(node_weights, g)
    edge = (torch.ones((num_edges, 1), device=g.device) if edge_weights is None
            else as_param(edge_weights, g))
    return {"node_embedding": node, "edge_weight": edge}


def unique_word_readout(
    per_pos_max: torch.Tensor,  # [B, L, D], -inf at invalid positions
    ids: torch.Tensor,          # [B, L]
    lens: torch.Tensor,         # [B]
) -> torch.Tensor:
    """Sum over unique words of the max over that word's positions.

    Each position's aggregate is scatter-maxed into the slot of its word's
    first occurrence, found with a stable sort; the readout sums each slot
    once.  Slots that are not a first occurrence stay -inf and drop out.
    The scatter-max's backward splits the gradient evenly among the tied
    positions of a word, as the JAX package's scatter-max VJP does."""
    B, L, D = per_pos_max.shape
    pos = torch.arange(L, device=ids.device)
    valid = pos[None, :] < lens[:, None]
    sentinel = torch.iinfo(torch.int64).max  # invalid positions sort last
    key_ids = torch.where(valid, ids.long(), sentinel)
    sorted_ids, sidx = torch.sort(key_ids, dim=1, stable=True)
    head = torch.ones_like(sorted_ids, dtype=torch.bool)
    head[:, 1:] = sorted_ids[:, 1:] != sorted_ids[:, :-1]
    # stable sort: a segment of equal ids starts at the word's first occurrence
    head_at = torch.where(head, pos[None, :], 0).cummax(dim=1).values
    canon = torch.empty_like(sidx).scatter_(1, sidx, sidx.gather(1, head_at))
    canon = torch.where(valid, canon, L)                # dummy slot for padding
    out = torch.full((B, L + 1, D), float("-inf"), dtype=per_pos_max.dtype,
                     device=per_pos_max.device)
    out = out.scatter_reduce(1, canon[:, :, None].expand(B, L, D), per_pos_max,
                             reduce="amax", include_self=True)
    out = out[:, :L, :]
    return torch.where(torch.isfinite(out), out, 0.0).sum(dim=1)


def text_gcn_apply(
    params: dict,
    ids: torch.Tensor,    # [B, L] int token ids (0 = PAD, suffix padding)
    lens: torch.Tensor,   # [B] int32 true lengths
    eids: torch.Tensor,   # [B, L, W] window edge ids from the host pipeline
    *,
    ngram: int,
    dropout_rate: float = 0.5,
    train: bool = False,
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """Document representations [B, D]."""
    emb = embedding(params["node_embedding"], ids)    # [B, L, D]
    w = params["edge_weight"][:, 0][eids]             # [B, L, W]
    m = edge_max.window_max_aggregate(emb, w, lens, ngram)
    h = dropout(unique_word_readout(m, ids, lens), dropout_rate, generator, train)
    return torch.relu(h)
