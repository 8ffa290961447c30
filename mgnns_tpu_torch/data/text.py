"""Text side of serving: raw texts -> static-shape numpy tensors.

A copy of the JAX package's ``mgnns_tpu/data/text.py:encode_texts``, so the
two packages encode a request identically.
"""

from __future__ import annotations

import numpy as np

from mgnns_tpu_torch.config import TextGraphConfig
from mgnns_tpu_torch.graphs.pmi import PmiGraph, doc_window_edge_ids
from mgnns_tpu_torch.graphs.vocab import words_to_ids


def encode_texts(
    texts: list[str],
    w2i: dict[str, int],
    graph: PmiGraph,
    cfg: TextGraphConfig,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Tokenize + pad + mask + window-edge-id encode.

    Returns (ids [N, L], lens [N], mask [N, L], eids [N, L, W]); ``lens`` is
    clamped to >= 1 so an empty text still has one (PAD) token."""
    L = cfg.max_len
    N = len(texts)
    ids = np.zeros((N, L), np.int32)
    lens = np.zeros((N,), np.int32)
    for n, text in enumerate(texts):
        toks = words_to_ids(text.split(" "), w2i)[:L]
        ids[n, : len(toks)] = toks
        lens[n] = max(len(toks), 1)
    mask = (np.arange(L)[None, :] < lens[:, None]).astype(np.float32)
    eids = doc_window_edge_ids(ids, lens, cfg.ngram, graph)
    return ids, lens, mask, eids
