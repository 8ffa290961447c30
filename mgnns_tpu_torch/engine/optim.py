"""Optimizer: Adam (or SGD) with per-group learning-rate multipliers, global
norm clipping, L2 weight decay and step decay.

Port of the JAX package's ``mgnns_tpu/engine/optim.py``, whose optax chain
reproduces the reference's torch ``Adam(lr, weight_decay)`` over parameter
groups.  The update of one applied step, in the chain's order:

1. clip by the global norm over **every** gradient leaf, frozen ones
   included: ``g * max_norm / norm`` when ``norm >= max_norm`` (optax's
   ``clip_by_global_norm``; the norm has no epsilon);
2. add ``weight_decay * param`` to the gradient;
3. Adam moments with bias correction (b1 0.9, b2 0.999, eps 1e-8), or the
   identity for ``algo="sgd"``;
4. multiply by the group's factor: text x10, lstm x10, trunk x lrp, base x1,
   frozen -> no update;
5. subtract ``lr(step)``, the step-decayed learning rate.

``accumulation_steps > 1`` averages that many micro-step gradients and
applies the chain once, as ``optax.MultiSteps``.  The arithmetic runs on
``torch._foreach_*`` lists, so a step costs a few multi-tensor launches and
no host sync.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from mgnns_tpu_torch.models.mgnns import DEAD_MODULES
from mgnns_tpu_torch.utils import tree_leaves, tree_map

# param-subtree -> group name, in reference get_config_optim order
_GROUPS_LISTED = {
    "text_gcn": "text",            # text_features, lr*10
    "object_trunk": "trunk",       # lr*lrp
    "place_trunk": "trunk",
    "gc1": "base",
    "gc2": "base",
    "object_attention": "base",
    "place_attention": "base",
    "lstm": "lstm",                # lr*10
    "img_object_text_mha": "base",
    "img_place_text_mha": "base",
    "text_img_object_mha": "base",
    "text_img_place_mha": "base",
}
# the A matrices get no gradient (the reference detaches gen_adj's output);
# the dead reference modules are never run and sit in no reference group, so
# they are never updated (weight decay alone would otherwise move them)
_ALWAYS_FROZEN = {"object_A", "place_A", *DEAD_MODULES}


def label_params(params: dict, faithful: bool = False, freeze_trunks: bool = False) -> dict:
    """Tree of group labels matching ``params``' structure.  The reference's
    group list omits the sequence embedding, the image linear maps, the
    label-attention output linears and the classifier: ``faithful=True``
    freezes them as the reference does, ``faithful=False`` trains them at the
    base rate."""

    def subtree_label(name):
        if name in _ALWAYS_FROZEN:
            return "frozen"
        if freeze_trunks and _GROUPS_LISTED.get(name) == "trunk":
            return "frozen"
        if name in _GROUPS_LISTED:
            return _GROUPS_LISTED[name]
        return "frozen" if faithful else "base"

    return {name: tree_map(lambda _, n=name: subtree_label(n), sub)
            for name, sub in params.items()}


def lr_schedule(base_lr: float, steps_per_epoch: int, epoch_step: Sequence[int], decay: float):
    """Step decay: multiply by ``decay`` once the epoch index reaches each
    entry of ``epoch_step`` (reference ``adjust_learning_rate``)."""

    def schedule(step: int) -> float:
        epoch = step // max(steps_per_epoch, 1)
        lr = base_lr
        for e in epoch_step:
            if epoch >= e:
                lr *= decay
        return lr

    return schedule


class Optimizer:
    """The chain above over the leaves of a parameter tree, in the order of
    :func:`mgnns_tpu_torch.utils.tree_leaves`.  :meth:`init` makes the state
    (a dict of ints and tensor lists, which ``torch.save`` stores);
    :meth:`apply` updates the parameters and the state in place."""

    def __init__(self, params: dict, *, lr: float = 5e-5, lrp: float = 0.1,
                 weight_decay: float = 1e-5, grad_clip: float = 10.0,
                 steps_per_epoch: int = 1, epoch_step: Sequence[int] = (10,),
                 lr_decay: float = 0.2, faithful: bool = False, accumulation_steps: int = 1,
                 freeze_trunks: bool = False, algo: str = "adam"):
        if algo not in ("adam", "sgd"):
            raise ValueError(f"unknown optimizer algo {algo!r}")
        self.group_factors = {"base": 1.0, "text": 10.0, "lstm": 10.0, "trunk": lrp, "frozen": 0.0}
        self.faithful = faithful
        self.freeze_trunks = freeze_trunks
        self.label(params)
        self.schedule = lr_schedule(lr, steps_per_epoch, epoch_step, lr_decay)
        self.weight_decay = weight_decay
        self.grad_clip = grad_clip
        self.accumulation_steps = accumulation_steps
        self.algo = algo

    def label(self, params: dict) -> None:
        """The group factor of each leaf of ``params``, in leaf order; a tree
        of another structure (weights imported with their dead modules, a
        restored checkpoint) is labelled anew."""
        labels = tree_leaves(label_params(params, self.faithful, self.freeze_trunks))
        self.factors = [self.group_factors[lab] for lab in labels]
        self.trained = [i for i, f in enumerate(self.factors) if f != 0.0]

    def init(self, params: dict) -> dict:
        self.label(params)
        leaves = tree_leaves(params)
        state: dict = {"count": 0}
        if self.algo == "adam":
            state["mu"] = [torch.zeros_like(leaves[i]) for i in self.trained]
            state["nu"] = [torch.zeros_like(leaves[i]) for i in self.trained]
        if self.accumulation_steps > 1:
            state["mini_step"] = 0
            state["acc"] = [torch.zeros_like(p) for p in leaves]
        return state

    def apply(self, params: list[torch.Tensor], grads: list[torch.Tensor | None], state: dict) -> None:
        """One micro-step: ``grads`` (None = a zero gradient) of ``params``;
        under accumulation only every ``accumulation_steps``-th call moves
        the parameters."""
        if self.accumulation_steps > 1:
            n = state["mini_step"]
            acc = state["acc"]
            have = [i for i, g in enumerate(grads) if g is not None]
            miss = [a for a, g in zip(acc, grads) if g is None]
            # Welford mean, as optax.MultiSteps: acc + (g - acc) / (n + 1),
            # which for a missing (zero) gradient is acc * n / (n + 1)
            delta = torch._foreach_sub([grads[i] for i in have], [acc[i] for i in have])
            torch._foreach_div_(delta, float(n + 1))
            torch._foreach_add_([acc[i] for i in have], delta)
            if miss:
                torch._foreach_mul_(miss, n / (n + 1))
            if n + 1 < self.accumulation_steps:
                state["mini_step"] = n + 1
                return
            grads = [a.clone() for a in acc]
            for a in acc:
                a.zero_()
            state["mini_step"] = 0
        self._chain(params, grads, state)

    def _chain(self, params, grads, state) -> None:
        # 1. clip by the global norm of every leaf, frozen ones included; a
        # missing gradient is zeros and adds nothing to the norm
        present = [g for g in grads if g is not None]
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(present)))
        scale = torch.where(norm < self.grad_clip, torch.ones_like(norm), self.grad_clip / norm)
        p = [params[i] for i in self.trained]
        g = [grads[i] if grads[i] is not None else torch.zeros_like(params[i]) for i in self.trained]
        g = torch._foreach_mul(g, scale)
        # 2. L2 added to the gradient
        if self.weight_decay:
            torch._foreach_add_(g, p, alpha=self.weight_decay)
        count = state["count"]
        # 3. Adam moments
        if self.algo == "adam":
            b1, b2, eps = 0.9, 0.999, 1e-8
            mu, nu = state["mu"], state["nu"]
            torch._foreach_mul_(mu, b1)
            torch._foreach_add_(mu, g, alpha=1 - b1)
            torch._foreach_mul_(nu, b2)
            torch._foreach_addcmul_(nu, g, g, value=1 - b2)
            # bias corrections in float32, as optax computes them
            c = np.float32(count + 1)
            mu_hat = torch._foreach_div(mu, float(np.float32(1) - np.float32(b1) ** c))
            den = torch._foreach_sqrt(torch._foreach_div(nu, float(np.float32(1) - np.float32(b2) ** c)))
            torch._foreach_add_(den, eps)
            g = torch._foreach_div(mu_hat, den)
        # 4-5. the group factor, then -lr(step)
        torch._foreach_mul_(g, [self.factors[i] for i in self.trained])
        torch._foreach_mul_(g, -self.schedule(count))
        torch._foreach_add_(p, g)
        state["count"] = count + 1
