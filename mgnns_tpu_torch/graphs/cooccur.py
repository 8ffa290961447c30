"""Object/scene label co-occurrence adjacency: thresholding and normalization.

:func:`gen_A` is the JAX package's numpy function as it is (reference
``utils/util.py:382-398``); :func:`gen_adj` is its degree normalization in
torch (``:421-426``).
"""

from __future__ import annotations

import numpy as np
import torch


def gen_A(num_classes: int, t: float, adj_data: dict, gama: float = 0.2) -> tuple[np.ndarray, np.ndarray]:
    """Threshold + reweight the co-occurrence counts ``{'nums', 'adj'}``.

    Steps: P(j|i) = adj / nums[:, None]; binarize at ``t``; scale rows by
    ``gama / (column_sums + 1e-6)``; add ``(1 - gama) * I`` self-loops.
    """
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
