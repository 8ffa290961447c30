"""Streaming metrics through a confusion matrix.

Port of the JAX package's ``mgnns_tpu/engine/metrics.py``: one [C, C]
confusion matrix accumulates on the device during an epoch (one scatter-add
per step, no host sync), and accuracy and the F1 averages come from it on
the host at the epoch's end, equal to sklearn's globally computed values.
"""

from __future__ import annotations

import numpy as np
import torch


def confusion_init(num_classes: int, device) -> torch.Tensor:
    """A zero [C, C] int64 confusion matrix on ``device``."""
    return torch.zeros((num_classes, num_classes), dtype=torch.int64, device=device)


def confusion_update(cm: torch.Tensor, preds: torch.Tensor, labels: torch.Tensor,
                     weights: torch.Tensor | None = None) -> torch.Tensor:
    """cm[true, pred] += weight for each sample, in place; ``weights`` (0/1)
    masks the padding rows of a final ragged batch."""
    if weights is None:
        weights = torch.ones_like(labels)
    C = cm.shape[1]
    cm.view(-1).index_add_(0, labels.long() * C + preds.long(), weights.to(cm.dtype))
    return cm


def _prf(cm: np.ndarray):
    tp = np.diag(cm).astype(np.float64)
    support = cm.sum(axis=1).astype(np.float64)      # rows = true
    predicted = cm.sum(axis=0).astype(np.float64)    # cols = predicted
    with np.errstate(divide="ignore", invalid="ignore"):
        precision = np.where(predicted > 0, tp / predicted, 0.0)
        recall = np.where(support > 0, tp / support, 0.0)
        f1 = np.where(precision + recall > 0, 2 * precision * recall / (precision + recall), 0.0)
    return precision, recall, f1, support


def metrics_from_confusion(cm) -> dict:
    """accuracy, micro/macro/weighted F1 (sklearn conventions)."""
    cm = np.asarray(cm)
    total = cm.sum()
    correct = np.diag(cm).sum()
    acc = correct / total if total else 0.0
    precision, recall, f1, support = _prf(cm)
    macro_f1 = f1.mean() if cm.shape[0] else 0.0
    weighted_f1 = (f1 * support).sum() / total if total else 0.0
    return {
        "accuracy": float(acc),
        "micro_f1": float(acc),  # == micro F1 for single-label multi-class
        "macro_f1": float(macro_f1),
        "weighted_f1": float(weighted_f1),
    }


def classification_report(cm, label_names: list[str] | None = None) -> str:
    """Text report akin to sklearn's ``classification_report``."""
    cm = np.asarray(cm)
    C = cm.shape[0]
    names = label_names or [str(i) for i in range(C)]
    precision, recall, f1, support = _prf(cm)
    width = max(len(n) for n in names) + 2
    lines = [f"{'':>{width}}  precision  recall  f1-score  support"]
    for i, n in enumerate(names):
        lines.append(
            f"{n:>{width}}  {precision[i]:9.4f}  {recall[i]:6.4f}  {f1[i]:8.4f}  {int(support[i]):7d}"
        )
    m = metrics_from_confusion(cm)
    lines.append(
        f"{'accuracy':>{width}}  {'':9}  {'':6}  {m['accuracy']:8.4f}  {int(cm.sum()):7d}"
    )
    lines.append(
        f"{'macro avg':>{width}}  {precision.mean():9.4f}  {recall.mean():6.4f}  {m['macro_f1']:8.4f}  {int(cm.sum()):7d}"
    )
    w_p = (precision * support).sum() / max(cm.sum(), 1)
    w_r = (recall * support).sum() / max(cm.sum(), 1)
    lines.append(
        f"{'weighted avg':>{width}}  {w_p:9.4f}  {w_r:6.4f}  {m['weighted_f1']:8.4f}  {int(cm.sum()):7d}"
    )
    return "\n".join(lines)
