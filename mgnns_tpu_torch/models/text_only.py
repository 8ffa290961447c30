"""Text-only classification model: text GCN -> linear head.

Port of the JAX package's ``mgnns_tpu/models/text_only.py`` (the reference's
``Text_GCN.Model`` with its classification Linear attached,
``models/Text_GCN.py:95,273``).
"""

from __future__ import annotations

import numpy as np
import torch

from mgnns_tpu_torch.nn import text_gcn
from mgnns_tpu_torch.nn.core import RngStream, linear, linear_init
from mgnns_tpu_torch.utils import resolve_device


def text_model_init(
    vocab_size: int,
    num_labels: int,
    num_edges: int,
    *,
    seed: int = 0,
    hidden_size: int = 300,
    node_embedding: np.ndarray | None = None,
    edge_weights: np.ndarray | None = None,
    device="cuda",
) -> dict:
    """Parameters drawn from a ``torch.Generator`` seeded with ``seed`` on
    ``device`` (raises when that is CUDA and no card is present).
    ``node_embedding`` [V, D] and ``edge_weights`` [E, 1] replace the random
    node table and the all-ones edge table, as in the JAX package."""
    g = torch.Generator(device=resolve_device(device)).manual_seed(seed)
    return {
        "text_gcn": text_gcn.text_gcn_init(g, vocab_size, hidden_size, num_edges,
                                           node_weights=node_embedding, edge_weights=edge_weights),
        "head": linear_init(g, hidden_size, num_labels),
    }


def text_model_apply(params: dict, batch: dict, *, ngram: int, dropout_rate: float = 0.5,
                     train: bool = False, generator: torch.Generator | None = None) -> torch.Tensor:
    """batch: ``ids`` [B, L], ``lens`` [B] int32, ``eids`` [B, L, W].
    Returns logits [B, num_labels].  In train mode the text GCN's readout
    takes dropout from ``generator``."""
    rngs = RngStream(generator)
    h = text_gcn.text_gcn_apply(params["text_gcn"], batch["ids"], batch["lens"],
                                batch["eids"], ngram=ngram, dropout_rate=dropout_rate,
                                train=train, generator=rngs.next("text_gcn"))
    return linear(params["head"], h)
