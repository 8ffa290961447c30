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
applies the chain once, as ``optax.MultiSteps``.

On a data axis of several ranks (:mod:`mgnns_tpu_torch.parallel`) each rank
holds its share of the gradient; :func:`reduce_gradients` sums the shares,
and the loss's, in one flat buffer before the chain, so that the clip, the
nan-guard's flag and the step count are the same on every rank.  On a model
axis a leaf may be this rank's shard (:meth:`Optimizer.set_model_axis`): the
clip's norm then sums the squares of the sharded leaves over the model axis
and counts each replicated leaf once, and the moments of a shard are its
own.  A gather table's zero padding rows get zero gradients, so their
moments, their weight decay and their updates stay zero.

On CUDA leaves the chain runs as the hand-written kernels of
:mod:`mgnns_tpu_torch.kernels.adam`: the clip's norm in two deterministic
passes, then one pass that reads each trained leaf's parameter, gradient and
moments once and writes them once, the guard inside; :func:`select_` is one
launch too.  CPU leaves take the plain chain, on ``torch._foreach_*`` lists:
after the clip's norm over every leaf, steps 2-5 run over buckets of
consecutive trained leaves of at most :data:`BUCKET_BYTES`
(:func:`buckets`), so that their temporaries are a few copies of a bucket
and not of every parameter; the arithmetic is elementwise, so the bits do
not depend on the buckets.  Neither reads a host value from the device.

The step state lives on the device: the applied-step ``count`` (from which
the step-decayed rate and the float32 bias corrections are computed) and,
under accumulation, the running mean and its divisor.  Only ``mini_step``,
the position in the accumulation window, is a host int: its sequence is
fixed, so a captured step (:mod:`mgnns_tpu_torch.engine.graphs`) is one of
two graphs, accumulate-only and accumulate-and-apply, picked by the host.
An update can be guarded by a device flag ``ok`` (the engine's nan-guard):
where it is false every parameter and state tensor keeps its old value.  A
guarded-out micro-step adds nothing to the running mean but still takes its
place in the window.
"""

from __future__ import annotations

from typing import Sequence

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
    base rate.  A MoE text encoder (``encoder``) is a group of its own, its
    routers' correction biases frozen."""
    from mgnns_tpu_torch.nn.moe import frozen_leaf
    from mgnns_tpu_torch.utils import tree_paths, tree_unflatten

    def encoder_labels(sub):
        return tree_unflatten(sub, ["frozen" if frozen_leaf(p) else "encoder"
                                    for p in tree_paths(sub)])

    def subtree_label(name):
        if name in _ALWAYS_FROZEN:
            return "frozen"
        if freeze_trunks and _GROUPS_LISTED.get(name) == "trunk":
            return "frozen"
        if name in _GROUPS_LISTED:
            return _GROUPS_LISTED[name]
        return "frozen" if faithful else "base"

    return {name: encoder_labels(sub) if name == "encoder" else
            tree_map(lambda _, n=name: subtree_label(n), sub)
            for name, sub in params.items()}


# the most bytes of trained leaves one pass of the chain takes: its
# temporaries are a few copies of a bucket.  The fusion model's whole trained
# set (363,989,256 bytes) is one bucket; a MoE text encoder's 2.7 B parameters are
# about twenty.
BUCKET_BYTES = 1 << 29


def buckets(leaves: list[torch.Tensor], limit: int) -> list[list[int]]:
    """Runs of consecutive positions into ``leaves``, each of at most
    ``limit`` bytes (a larger leaf alone)."""
    out: list[list[int]] = []
    size = 0
    for i, t in enumerate(leaves):
        n = t.numel() * t.element_size()
        if not out or size + n > limit:
            out.append([])
            size = 0
        out[-1].append(i)
        size += n
    return out


def reduce_gradients(grads: list[torch.Tensor | None], loss: torch.Tensor, axis
                     ) -> tuple[list[torch.Tensor | None], torch.Tensor]:
    """(the gradients, the loss) summed over the data ``axis`` in one
    collective: every present gradient leaf and the rank's share of the loss
    go through one flat float32 buffer.  A leaf without a gradient (a frozen
    trunk, a dead module) is left out, the same on every rank, since every
    rank runs the same model."""
    from mgnns_tpu_torch.parallel.collectives import all_reduce_sum

    have = [i for i, g in enumerate(grads) if g is not None]
    summed = all_reduce_sum([grads[i] for i in have] + [loss.reshape(1)], axis)
    out: list = list(grads)
    for i, g in zip(have, summed):
        out[i] = g
    return out, summed[-1].reshape(())


def select_(olds: list[torch.Tensor], news: list[torch.Tensor], ok: torch.Tensor | None) -> None:
    """``old = new`` where the device flag ``ok`` holds (always for None);
    a non-finite ``new`` is never multiplied into the kept value.  CUDA
    tensors take one guarded-copy launch (:func:`~mgnns_tpu_torch.kernels.
    adam.select`)."""
    if olds and olds[0].is_cuda:
        from mgnns_tpu_torch.kernels import adam

        adam.select(olds, news, ok)
    else:
        _plain_select_(olds, news, ok)


def _plain_select_(olds: list[torch.Tensor], news: list[torch.Tensor],
                   ok: torch.Tensor | None) -> None:
    """:func:`select_` as ``torch.where`` on each tensor, on any device: the
    plain chain's guard."""
    if ok is None:
        torch._foreach_copy_(olds, news)
        return
    for old, new in zip(olds, news):
        torch.where(ok, new, old, out=old)


class Optimizer:
    """The chain above over the leaves of a parameter tree, in the order of
    :func:`mgnns_tpu_torch.utils.tree_leaves`.  :meth:`init` makes the state
    (a dict of tensors and the host ``mini_step``, which ``torch.save``
    stores); :meth:`apply` updates the parameters and the state in place."""

    def __init__(self, params: dict, *, lr: float = 5e-5, lrp: float = 0.1,
                 weight_decay: float = 1e-5, grad_clip: float = 10.0,
                 steps_per_epoch: int = 1, epoch_step: Sequence[int] = (10,),
                 lr_decay: float = 0.2, faithful: bool = False, accumulation_steps: int = 1,
                 freeze_trunks: bool = False, algo: str = "adam"):
        if algo not in ("adam", "sgd"):
            raise ValueError(f"unknown optimizer algo {algo!r}")
        self.group_factors = {"base": 1.0, "text": 10.0, "lstm": 10.0, "trunk": lrp,
                              "encoder": 1.0, "frozen": 0.0}
        self.faithful = faithful
        self.freeze_trunks = freeze_trunks
        self.label(params)
        # step decay (reference adjust_learning_rate): the rate is multiplied
        # by lr_decay once the epoch index reaches each entry of epoch_step;
        # neg_lrs[k] is -lr after k decays
        self.steps_per_epoch = max(steps_per_epoch, 1)
        self.epoch_step = tuple(epoch_step)
        self.neg_lrs = [-lr * lr_decay ** k for k in range(len(self.epoch_step) + 1)]
        self.weight_decay = weight_decay
        self.grad_clip = grad_clip
        self.accumulation_steps = accumulation_steps
        self.algo = algo
        self._consts: dict = {}
        self.model = None

    def set_model_axis(self, axis, sharded: list[bool]) -> None:
        """Leaves ``i`` with ``sharded[i]`` are this rank's shards on the
        model ``axis`` (None: no model axis)."""
        self.model = None if axis is None else (axis, list(sharded))

    def label(self, params: dict) -> None:
        """The group factor of each leaf of ``params``, in leaf order; a tree
        of another structure (weights imported with their dead modules, a
        restored checkpoint) is labelled anew."""
        labels = tree_leaves(label_params(params, self.faithful, self.freeze_trunks))
        self.factors = [self.group_factors[lab] for lab in labels]
        self.trained = [i for i, f in enumerate(self.factors) if f != 0.0]
        leaves = tree_leaves(params)
        self.buckets = buckets([leaves[i] for i in self.trained], BUCKET_BYTES)

    def init(self, params: dict) -> dict:
        self.label(params)
        leaves = tree_leaves(params)
        device = leaves[0].device if leaves else torch.device("cpu")
        state: dict = {"count": torch.zeros((), dtype=torch.int64, device=device)}
        if self.algo == "adam":
            state["mu"] = [torch.zeros_like(leaves[i]) for i in self.trained]
            state["nu"] = [torch.zeros_like(leaves[i]) for i in self.trained]
        if self.accumulation_steps > 1:
            state["mini_step"] = 0
            state["acc"] = [torch.zeros_like(p) for p in leaves]
            state["acc_n"] = torch.zeros((), dtype=torch.float32, device=device)
        return state

    def adopt(self, state: dict, device) -> dict:
        """``state`` as :meth:`init` makes it, on ``device``: a checkpoint
        written when ``count`` was a host int, or without ``acc_n``, is
        brought up to date."""
        state = dict(state)
        state["count"] = torch.as_tensor(state["count"], dtype=torch.int64).to(device)
        if self.accumulation_steps > 1 and "acc_n" not in state:
            state["acc_n"] = torch.tensor(float(state.get("mini_step", 0)), device=device)
        return state

    def tensors(self, state: dict) -> list[torch.Tensor]:
        """Every tensor of ``state``, in a fixed order."""
        out = [state["count"]] + state.get("mu", []) + state.get("nu", []) + state.get("acc", [])
        return out + ([state["acc_n"]] if "acc_n" in state else [])

    def applies_now(self, state: dict) -> bool:
        """Whether the next micro-step applies the chain (always without
        accumulation)."""
        return self.accumulation_steps == 1 or state["mini_step"] + 1 == self.accumulation_steps

    def advance(self, state: dict) -> None:
        """Move the host's place in the accumulation window by one micro-step."""
        if self.accumulation_steps > 1:
            state["mini_step"] = (state["mini_step"] + 1) % self.accumulation_steps

    def apply(self, params: list[torch.Tensor], grads: list[torch.Tensor | None], state: dict,
              ok: torch.Tensor | None = None) -> None:
        """One micro-step: ``grads`` (None = a zero gradient) of ``params``;
        under accumulation only every ``accumulation_steps``-th call moves
        the parameters.  ``ok``: see the module's docstring."""
        self.update(params, grads, state, ok, self.applies_now(state))
        self.advance(state)

    def update(self, params, grads, state, ok, apply_now: bool) -> None:
        """The device work of one micro-step, without moving ``mini_step``:
        accumulate, and when ``apply_now`` run the chain.  It reads no host
        value that changes from step to step, so it can be captured."""
        if self.accumulation_steps > 1:
            acc, n = state["acc"], state["acc_n"]
            have = [i for i, g in enumerate(grads) if g is not None]
            miss = [i for i, g in enumerate(grads) if g is None]
            # Welford mean, as optax.MultiSteps: acc + (g - acc) / (n + 1),
            # which for a missing (zero) gradient is acc * n / (n + 1)
            new = torch._foreach_sub([grads[i] for i in have], [acc[i] for i in have])
            torch._foreach_div_(new, n + 1)
            torch._foreach_add_(new, [acc[i] for i in have])
            if miss:
                new += torch._foreach_mul([acc[i] for i in miss], n / (n + 1))
            order = have + miss
            news = [None] * len(acc)
            for i, t in zip(order, new):
                news[i] = t
            if not apply_now:
                select_(acc, news, ok)
                self._count_(n, 1.0, ok)
                return
            self._chain(params, news, state, ok)
            # a guarded-out apply keeps the window's sum for the next one
            if ok is None:
                torch._foreach_zero_(acc)
            else:
                for a in acc:
                    a.masked_fill_(ok, 0.0)
            self._count_(n, None, ok)
            return
        self._chain(params, grads, state, ok)

    def _clip_norm(self, grads, sumsq) -> torch.Tensor:
        """The clip's global norm over every present gradient, frozen leaves
        included; a missing gradient is zeros and adds nothing.
        ``sumsq(idx)`` gives (the sum of the squares of the gradients at
        positions ``idx``, its square root), device scalars.  On a model
        axis the squares of the sharded leaves are summed over the axis and
        each replicated leaf's are counted once."""
        have = [i for i, g in enumerate(grads) if g is not None]
        if self.model is None:
            return sumsq(have)[1]
        from mgnns_tpu_torch.parallel.collectives import model_sum

        axis, sharded = self.model

        def squares(split):
            part = [i for i in have if sharded[i] == split]
            if not part:
                return torch.zeros((), dtype=torch.float32, device=grads[have[0]].device)
            return sumsq(part)[0]

        return torch.sqrt(model_sum(squares(True), axis) + squares(False))

    @staticmethod
    def _count_(t: torch.Tensor, inc, ok) -> None:
        """``t += inc`` (``inc`` None: ``t = 0``) where ``ok`` holds."""
        new = torch.zeros_like(t) if inc is None else t + inc
        t.copy_(new if ok is None else torch.where(ok, new, t))

    def _const(self, name: str, value, dtype, device) -> torch.Tensor:
        key = (name, device)
        if key not in self._consts:
            self._consts[key] = torch.tensor(value, dtype=dtype, device=device)
        return self._consts[key]

    def _schedule(self, count: torch.Tensor):
        """(bc1, bc2, -lr(step)) from the device count: the bias corrections
        in float32, as optax computes them (None under SGD), and the step
        decay's rate, ``[1]``."""
        dev = count.device
        bc1 = bc2 = None
        if self.algo == "adam":
            c = (count + 1).to(torch.float32)
            bc1 = 1 - self._const("b1", 0.9, torch.float32, dev) ** c
            bc2 = 1 - self._const("b2", 0.999, torch.float32, dev) ** c
        epoch = torch.div(count, self.steps_per_epoch, rounding_mode="floor")
        decays = (epoch >= self._const("epoch_step", self.epoch_step, torch.int64, dev)).sum()
        neg_lr = self._const("neg_lrs", self.neg_lrs, torch.float32, dev).index_select(
            0, decays.view(1))
        return bc1, bc2, neg_lr

    def _chain(self, params, grads, state, ok) -> None:
        if state["count"].is_cuda:
            self._kernel_chain(params, grads, state, ok)
        else:
            self._plain_chain(params, grads, state, ok)

    def _kernel_chain(self, params, grads, state, ok) -> None:
        """The chain on CUDA leaves: the kernels of
        :mod:`mgnns_tpu_torch.kernels.adam`."""
        from mgnns_tpu_torch.kernels import adam

        grads = adam.match_layouts(params, grads)
        norm = self._clip_norm(grads, lambda idx: adam.sum_squares(
            [params[i] for i in idx], [grads[i] for i in idx]))
        count = state["count"]
        bc1, bc2, neg_lr = self._schedule(count)
        adam_ = self.algo == "adam"
        adam.update([params[i] for i in self.trained], [grads[i] for i in self.trained],
                    state["mu"] if adam_ else None, state["nu"] if adam_ else None,
                    [self.factors[i] for i in self.trained], norm=norm, clip=self.grad_clip,
                    weight_decay=self.weight_decay, bc1=bc1, bc2=bc2, neg_lr=neg_lr, ok=ok)
        self._count_(count, 1, ok)

    def _plain_chain(self, params, grads, state, ok) -> None:
        """The chain on ``torch._foreach_*`` lists, the plain version: CPU
        leaves take it, and on CUDA leaves it is the kernels' reference (its
        guard is ``torch.where`` there too)."""
        def sumsq(idx):
            norms = torch.stack(torch._foreach_norm([grads[i] for i in idx]))
            return (norms * norms).sum(), torch.linalg.vector_norm(norms)

        # 1. clip by the global norm
        norm = self._clip_norm(grads, sumsq)
        scale = torch.where(norm < self.grad_clip, torch.ones_like(norm), self.grad_clip / norm)
        count = state["count"]
        bc1, bc2, neg_lr = self._schedule(count)
        # 2-5 over buckets of the trained leaves: elementwise, so the bits do
        # not depend on the buckets, and the temporaries are a bucket's
        for bucket in self.buckets:
            self._bucket(bucket, params, grads, state, ok, scale, bc1, bc2, neg_lr)
        self._count_(count, 1, ok)

    def _bucket(self, bucket, params, grads, state, ok, scale, bc1, bc2, neg_lr) -> None:
        trained = [self.trained[k] for k in bucket]
        p = [params[i] for i in trained]
        g = [grads[i] if grads[i] is not None else torch.zeros_like(params[i]) for i in trained]
        g = torch._foreach_mul(g, scale)
        # 2. L2 added to the gradient
        if self.weight_decay:
            torch._foreach_add_(g, p, alpha=self.weight_decay)
        # 3. Adam moments
        if self.algo == "adam":
            b1, b2, eps = 0.9, 0.999, 1e-8
            old_mu = [state["mu"][k] for k in bucket]
            old_nu = [state["nu"][k] for k in bucket]
            mu = torch._foreach_mul(old_mu, b1)
            torch._foreach_add_(mu, g, alpha=1 - b1)
            nu = torch._foreach_mul(old_nu, b2)
            torch._foreach_addcmul_(nu, g, g, value=1 - b2)
            del g
            g = torch._foreach_div(mu, bc1)
            den = torch._foreach_div(nu, bc2)
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, eps)
            torch._foreach_div_(g, den)
            del den
            _plain_select_(old_mu, mu, ok)
            _plain_select_(old_nu, nu, ok)
            del mu, nu
        # 4-5. the group factor, then -lr(step)
        torch._foreach_mul_(g, [self.factors[i] for i in trained])
        torch._foreach_mul_(g, neg_lr[0])
        if ok is None:
            torch._foreach_add_(p, g)
        else:
            _plain_select_(p, torch._foreach_add(p, g), ok)
