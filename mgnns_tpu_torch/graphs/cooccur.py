"""Object/scene label co-occurrence adjacency: counting, thresholding and
normalization.

:func:`build_cooccurrence`, :func:`load_adj_pickle` and :func:`gen_A` are the
JAX package's numpy functions as they are (reference ``utils/util.py:325-398``);
:func:`gen_adj` is its degree normalization in torch (``:421-426``).
"""

from __future__ import annotations

import pickle
from typing import Sequence

import numpy as np
import torch


def build_cooccurrence(label_sets: Sequence[Sequence[int]], num_classes: int) -> dict:
    """Counts ``{'nums': [C], 'adj': [C, C]}`` (the on-disk format of
    ``data/adj/*.pkl``) from per-sample label lists, each deduplicated
    first; a pair cell counts once per ordered pair and sample, and a label
    that never occurs gets num 1 (``utils/util.py:325-380``)."""
    nums = np.zeros(num_classes, dtype=np.float64)
    adj = np.zeros((num_classes, num_classes), dtype=np.float64)
    for labels in label_sets:
        uniq = sorted(set(labels))
        for a in uniq:
            nums[a] += 1
        for a in uniq:
            for b in uniq:
                if a != b:
                    adj[a, b] += 1
    nums[nums == 0] = 1
    return {"nums": nums, "adj": adj}


def load_adj_pickle(path: str) -> dict:
    """Load a ``{'nums', 'adj'}`` co-occurrence pickle (``data/adj/*.pkl``)."""
    with open(path, "rb") as f:
        result = pickle.load(f)
    return {"nums": np.asarray(result["nums"]), "adj": np.asarray(result["adj"])}


def gen_A(num_classes: int, t: float, adj_data: dict | str,
          gama: float = 0.2) -> tuple[np.ndarray, np.ndarray]:
    """Threshold + reweight the co-occurrence counts ``adj_data``, a loaded
    ``{'nums', 'adj'}`` dict or the path of its pickle.

    Steps: P(j|i) = adj / nums[:, None]; binarize at ``t``; scale rows by
    ``gama / (column_sums + 1e-6)``; add ``(1 - gama) * I`` self-loops.
    """
    if isinstance(adj_data, str):
        adj_data = load_adj_pickle(adj_data)
    _adj = np.array(adj_data["adj"], dtype=np.float64)
    _nums = np.array(adj_data["nums"], dtype=np.float64)[:, None]
    _adj = _adj / _nums
    _adj = np.where(_adj < t, 0.0, 1.0)
    _adj = _adj * gama / (_adj.sum(0, keepdims=True) + 1e-6)
    _adj = _adj + (1 - gama) * np.identity(num_classes, dtype=np.float64)
    return _adj, _nums


def gen_adj(A: torch.Tensor) -> torch.Tensor:
    """Degree normalization ``((A @ D)^T) @ D``, ``D = diag(rowsum(A)^-1/2)``."""
    D = torch.pow(A.sum(dim=1), -0.5)
    AD = A * D[None, :]        # A @ diag(D) scales columns
    return AD.T * D[None, :]   # (A D)^T @ diag(D)
