"""The arithmetic of ``correct`` and of the latency tails.

- :func:`norm_gap`: for each leaf, the gap between the program's norm and
  the reference's, over the reference's norm of that leaf or of the median
  leaf, whichever is larger; the worst leaf's.
- :func:`percentile`: a latency percentile over every request sent, a
  failed request ranked as the slowest.
- :func:`logit_gap`: by how much the reference's best logit exceeds its
  logit of the class the program chose, at the worst row.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def leaf_norms(named: dict) -> dict:
    """{path: float64 norm} of ``{path: tensor}``."""
    return {k: float(torch.linalg.vector_norm(v.detach().double())) for k, v in named.items()}


def norm_gap(prog: dict, ref: dict, keep=None) -> float:
    """The worst leaf's norm gap (see the module's docstring) over the
    paths of ``ref`` (those in ``keep`` when given); a path the program
    lacks reads 1, as a leaf it never moved would."""
    paths = [p for p in ref if keep is None or p in keep]
    if not paths:
        return float("nan")
    median = float(np.median([ref[p] for p in paths]))
    worst = 0.0
    for p in paths:
        scale = max(ref[p], median)
        gap = abs(prog.get(p, 0.0) - ref[p]) / scale if scale > 0 else 0.0
        worst = max(worst, gap if p in prog else 1.0)
    return worst


def percentile(latencies: list[float], failed: int, q: float) -> float:
    """The ``q``-th percentile (0-100) of ``latencies`` plus ``failed``
    requests at +inf, by the nearest rank."""
    values = sorted(latencies) + [math.inf] * failed
    if not values:
        return math.inf
    rank = max(1, math.ceil(q / 100 * len(values)))
    return float(values[rank - 1])


def logit_gap(ref_logits: np.ndarray, prog_pred: np.ndarray) -> float:
    ref_logits = np.asarray(ref_logits, np.float64)
    best = ref_logits.max(axis=1)
    chosen = ref_logits[np.arange(len(prog_pred)), np.asarray(prog_pred)]
    return float((best - chosen).max()) if len(prog_pred) else 0.0
