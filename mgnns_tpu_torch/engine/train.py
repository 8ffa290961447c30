"""The training and evaluation engine: steps, epoch loops, checkpoints, results.

Port of the JAX package's ``mgnns_tpu/engine/train.py``:

- ``train_step``: forward, ``CE + aux_loss_weight * aux``, backward, the
  optimizer (:mod:`mgnns_tpu_torch.engine.optim`) and the confusion-matrix
  update.  The nan-guard is a device flag ``ok = isfinite(loss)``: where it
  is false the parameters, the optimizer state and the BN running
  statistics keep their old values (``torch.where`` on the CPU, kernels
  that store nothing on CUDA; never a multiply, since a NaN times 0 is NaN)
  and the step adds nothing to the confusion matrix;
  the host reads nothing per step;
- metrics accumulate on the device in a confusion matrix and are finalized
  per epoch; the per-step losses are read back once per epoch, stacked;
- step LR decay lives in the optimizer's schedule, on the device;
- a loader whose split lives in device tables hands the engine an epoch
  plan (``DeviceLoader.epoch_plan``), and the epoch runs as a captured step
  replayed once per batch (:mod:`mgnns_tpu_torch.engine.graphs`; eagerly on
  the CPU), the counterpart of the JAX engine's fused whole-epoch programs;
- ``torch.save`` checkpoints every epoch with best-by-val-accuracy tracking
  and resume; the test split's results go to the reference's
  experiment/pred text files; ``learning(profile_dir=)`` writes a
  ``torch.profiler`` trace of the first epoch.

The step's phases are :func:`mgnns_tpu_torch.tracing.stage` spans
(``engine.forward``, ``engine.backward``, ``engine.all_reduce`` under a
mesh, ``engine.optimizer``), and each epoch is an ``engine.epoch`` span
(``train`` true or false).  A stage's profiler range is recorded where the
step runs on the host: every eager step, and once at a step's capture, never
in its replays.  A captured step holds each stage's begin and end mark
kernels, so every replay shows its phases in the device trace.  The engine
never inspects the model: it takes an ``apply_fn`` of signature ``(params,
batch_stats, batch, *, train, generator[, axis]) -> (logits,
new_batch_stats[, aux])``, where ``aux`` is a scalar loss term.  Dropout
in step ``s`` draws from the engine's
:class:`~mgnns_tpu_torch.nn.core.SiteGenerators`, seeded by ``(seed, s)``.

``Engine(mesh=...)`` (:func:`mgnns_tpu_torch.parallel.mesh.create_mesh`),
the counterpart of the JAX engine's mesh branches, trains on the data axis
of one process per card: each rank runs its rows of the global batch, and
the step computes what one device computes on the global batch.

- at construction every rank takes rank 0's parameters, statistics and
  optimizer state;
- ``apply_fn`` gets ``axis=`` (train-mode BatchNorm over the global batch),
  and the dropout generators carry the axis (the global batch's masks);
- each rank's loss is its ``sum(ll * w)`` over the global batch's weight
  sum (``weight_total``, which the input plan carries, so it needs no
  collective), plus its share of ``aux``; :func:`~mgnns_tpu_torch.engine.
  optim.reduce_gradients` sums the gradients and the loss over the ranks in
  one collective, so the clip, the nan-guard and the reported loss are the
  global ones on every rank;
- an epoch runs over a loader built with the rank's input plan
  (``DeviceLoader(plan=...)``), and on several ranks any other loader is
  refused; the confusion matrix (and the eval losses) are summed over the
  ranks once per epoch;
- the test split's predictions are gathered and rank 0 writes the result
  files; rank 0 writes the checkpoints, every rank restores them.

A mesh with a model axis of N > 1 ranks (``create_mesh(data, model)``)
also splits the parameters, as the JAX engine's ``param_sharding_rules``
do (``mgnns_tpu/engine/train.py:150-155, 850-854``):

- at construction, and in :meth:`Engine.load_model_state` and
  :meth:`Engine.restore`, every rank takes global rank 0's whole trees and
  keeps its shards (:func:`~mgnns_tpu_torch.parallel.sharding.shard_tree`);
  the optimizer state is made from the shards;
- ``apply_fn`` also gets ``model=``, the
  :class:`~mgnns_tpu_torch.parallel.sharding.Shards` view whose layers run
  the model axis's collectives; the ranks of one data position run the same
  rows, draw the same dropout masks and compute the same loss;
- the gradient sum stays on the data axis; the clip's norm sums the
  sharded leaves' squares over the model axis;
- global rank 0 writes every file; a checkpoint holds whole, unpadded
  leaves (:func:`~mgnns_tpu_torch.parallel.sharding.unshard_tree`), the
  same as a 1-rank run's, so it restores on any mesh.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Callable, Iterable

import numpy as np
import torch

from mgnns_tpu_torch import tracing
from mgnns_tpu_torch.engine import metrics as M
from mgnns_tpu_torch.engine.graphs import StepGraphs
from mgnns_tpu_torch.engine.optim import Optimizer, reduce_gradients, select_
from mgnns_tpu_torch.nn.core import SiteGenerators, derive_seed
from mgnns_tpu_torch.utils import (
    resolve_device, torch_profile, tree_leaves, tree_paths, tree_to, tree_unflatten,
)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, weights: torch.Tensor,
                  total: torch.Tensor | None = None) -> torch.Tensor:
    """Weighted-mean CE over valid rows (reference ``nn.CrossEntropyLoss``).
    ``total``: the weight sum to divide by, when ``weights`` are one rank's
    rows of a global batch whose weight sum it is (this rank's share of the
    global mean); ``weights.sum()`` by default."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = logp.gather(1, labels.long()[:, None])[:, 0]
    w = weights.float()
    return -(ll * w).sum() / torch.clamp(w.sum() if total is None else total.float(), min=1.0)


def _unpack(out):
    # apply_fn may return (logits, new_bs) or (logits, new_bs, aux_loss)
    return (out[0], out[1], out[2]) if len(out) == 3 else (out[0], out[1], 0.0)


class Engine:
    def __init__(
        self,
        apply_fn: Callable,
        params: Any,
        batch_stats: Any,
        *,
        num_classes: int,
        lr: float = 5e-5,
        lrp: float = 0.1,
        weight_decay: float = 1e-5,
        grad_clip: float = 10.0,
        steps_per_epoch: int = 1,
        epoch_step=(10,),
        lr_decay: float = 0.2,
        faithful_param_groups: bool = False,
        accumulation_steps: int = 1,
        freeze_trunks: bool = False,
        aux_loss_weight: float = 0.0,
        nan_guard: bool = True,
        optimizer_algo: str = "adam",
        seed: int = 0,
        checkpoint_dir: str | None = None,
        max_to_keep: int = 3,
        eval_only: bool = False,
        device="cuda",
        mesh=None,
        param_sharding_rules=None,
        heads: int | None = None,
    ):
        """``params`` / ``batch_stats`` are moved to ``device``, which raises
        when it is CUDA and no card is present.  ``eval_only`` builds no
        optimizer state.  ``mesh``: train on its data and model axes (see
        the module's docstring); every rank of it builds the engine with the
        same whole trees.  ``param_sharding_rules``: the model axis's rules
        (:func:`~mgnns_tpu_torch.parallel.sharding.mgnns_param_rules`,
        ``text_model_param_rules``); without them every leaf is replicated
        on it.  ``heads``: the attention's head count, for the head rule of
        :func:`~mgnns_tpu_torch.parallel.sharding.place`."""
        self.device = resolve_device(device)
        self.apply_fn = apply_fn
        self.axis = self.model_axis = self._world = None
        if mesh is not None:
            from mgnns_tpu_torch.parallel.sharding import refuse_encoder

            refuse_encoder(params, "a mesh")
            from mgnns_tpu_torch.parallel.collectives import DataAxis, ModelAxis, world_axis

            self.axis = DataAxis.of(mesh, self.device)
            model = ModelAxis.of(mesh, self.device)
            self.model_axis = model if model.size > 1 else None
            # the axis of the writer's saves and barriers: every rank
            self._world = self.axis if self.model_axis is None else world_axis(self.device)
        self._rules = param_sharding_rules or []
        self._heads = heads
        self.placements = self.shards = None  # this rank's view of the model axis
        self.num_classes = num_classes
        self.aux_loss_weight = aux_loss_weight
        self.nan_guard = nan_guard
        self.seed = seed
        self.opt = None if eval_only else Optimizer(
            params, lr=lr, lrp=lrp, weight_decay=weight_decay, grad_clip=grad_clip,
            steps_per_epoch=steps_per_epoch, epoch_step=epoch_step, lr_decay=lr_decay,
            faithful=faithful_param_groups, accumulation_steps=accumulation_steps,
            freeze_trunks=freeze_trunks, algo=optimizer_algo)
        self._set_state(params, batch_stats)
        self.step = 0
        self.checkpointer = None
        if checkpoint_dir is not None:
            from mgnns_tpu_torch.engine.checkpoint import Checkpointer

            self.checkpointer = Checkpointer(checkpoint_dir, max_to_keep, axis=self._world)
        self.epoch = 0
        self.best_score = 0.0
        self._gens = SiteGenerators(self.device, self.axis)
        self._graphs = StepGraphs(self)

    @property
    def is_writer(self) -> bool:
        """Whether this rank writes the run's files (global rank 0 of a mesh)."""
        return self._world is None or self._world.rank == 0

    def _set_state(self, params, batch_stats) -> None:
        """Take whole trees: on the device, global rank 0's on every rank of
        a mesh, this rank's shards on a model axis, and a fresh optimizer
        state made from them."""
        self.params = tree_to(params, self.device)
        # a copy: the engine updates the running statistics in place
        self.batch_stats = tree_to(batch_stats, self.device, copy=True)
        from mgnns_tpu_torch.parallel.mesh import replicate_tree

        # data rank 0's on the data axis, then model rank 0's (global rank 0's)
        for axis in (self.axis, self.model_axis):
            if axis is not None:
                replicate_tree([self.params, self.batch_stats], axis)
        self._shard()
        self.opt_state = self.opt.init(self.params) if self.opt is not None else None

    def _paths(self) -> list[str]:
        return [p.lstrip("/") for p in tree_paths(self.params)]

    def _shard(self) -> None:
        """Keep this rank's shards of the whole parameters on a model axis."""
        if self.model_axis is None:
            return
        from mgnns_tpu_torch.parallel.sharding import Shards, shard_tree

        self.params, self.placements = shard_tree(self.params, self.model_axis, self._rules,
                                                  self._heads)
        self.shards = Shards(self.model_axis, self.placements)
        if self.opt is not None:
            self.opt.set_model_axis(self.model_axis, [self.placements[p].dim is not None
                                                      for p in self._paths()])

    def _map_opt_state(self, state: dict, fn) -> dict:
        """``state`` with ``fn(leaves, placements, model axis)`` applied to
        its per-leaf lists (the moments of the trained leaves, the
        accumulator of every leaf)."""
        placements = [self.placements[p] for p in self._paths()]
        state = dict(state)
        for key in ("mu", "nu", "acc"):
            if key in state:
                pl = placements if key == "acc" else [placements[i] for i in self.opt.trained]
                state[key] = fn(state[key], pl, self.model_axis)
        return state

    def full_params(self) -> dict:
        """The whole, unpadded parameters (on a model axis a collective:
        every rank calls it)."""
        if self.model_axis is None:
            return self.params
        from mgnns_tpu_torch.parallel.sharding import unshard_tree

        return unshard_tree(self.params, self.placements, self.model_axis)

    def _apply(self, *args, **kw):
        if self.axis is not None:
            kw["axis"] = self.axis
        if self.shards is not None:
            kw["model"] = self.shards
        return self.apply_fn(*args, **kw)

    def _state_tensors(self) -> list[torch.Tensor]:
        """Every tensor a train step reads and updates in place."""
        out = tree_leaves(self.params) + tree_leaves(self.batch_stats)
        if self.opt is not None and self.opt_state is not None:
            out += self.opt.tensors(self.opt_state)
        return [t for t in out if isinstance(t, torch.Tensor)]

    # ---------------------------------------------------------------- steps

    def _to_device(self, batch: dict) -> dict:
        return {k: torch.as_tensor(v).to(self.device, non_blocking=True) for k, v in batch.items()}

    def train_step(self, batch: dict, cm: torch.Tensor) -> torch.Tensor:
        """One optimizer (micro-)step on ``batch``; returns the loss, a device
        scalar.  Updates ``cm`` in place unless the nan-guard skips the step."""
        if self.opt is None:
            raise RuntimeError("Engine was built with eval_only=True; "
                               "it has no optimizer state to train with")
        if self.axis is not None and self.axis.size > 1 and "weight_total" not in batch:
            raise ValueError("a batch of a mesh engine needs 'weight_total', its global batch's "
                             "weight sum (DeviceLoader(plan=...) and "
                             "parallel.mesh.batch_device_put add it)")
        batch = self._to_device(batch)
        self._gens.reseed(derive_seed(self.seed, self.step))
        loss = self._train_core(batch, cm, self.opt.applies_now(self.opt_state))
        self.opt.advance(self.opt_state)
        self.step += 1
        return loss

    def _train_core(self, batch: dict, cm: torch.Tensor, apply_now: bool,
                    hold: bool = False) -> torch.Tensor:
        """The device work of a train step on a device batch, the same on the
        loop path, the eager plan path and in a captured step: it reads no
        host value that changes between steps.  ``hold``: the whole step's
        work with its update held, as the nan-guard holds a non-finite one
        (a capture's warm-up): the parameters, the optimizer state, the
        statistics and ``cm`` keep their values."""
        loss, grads, logits, new_bs = self._loss_and_grads(batch)
        with torch.no_grad(), tracing.stage("engine.optimizer"):
            ok = torch.isfinite(loss) if self.nan_guard else None
            if hold:
                ok = torch.zeros((), dtype=torch.bool, device=loss.device)
            self.opt.update(tree_leaves(self.params), grads, self.opt_state, ok, apply_now)
            stats = tree_leaves(self.batch_stats)
            if stats:
                select_(stats, [t.detach() for t in tree_leaves(new_bs)], ok)
            weight = batch["weight"] if ok is None else torch.where(ok, batch["weight"], 0.0)
            M.confusion_update(cm, logits.argmax(dim=-1), batch["label"], weight)
        return loss

    def _loss_and_grads(self, batch: dict):
        """(loss, gradients in leaf order, logits, new statistics) of a train
        step's forward and backward on a device batch; under a mesh the loss
        and the gradients are summed over the data axis (the global batch's)
        and the logits are this rank's rows."""
        leaves = tree_leaves(self.params)
        live = [p.detach().requires_grad_(p.is_floating_point()) for p in leaves]
        with tracing.stage("engine.forward"):
            logits, new_bs, aux = _unpack(self._apply(
                tree_unflatten(self.params, live), self.batch_stats, batch, train=True,
                generator=self._gens.root))
            loss = cross_entropy(logits, batch["label"], batch["weight"],
                                 batch.get("weight_total")) + self.aux_loss_weight * aux
        want = [i for i, p in enumerate(live) if p.requires_grad]
        grads: list = [None] * len(live)
        with tracing.stage("engine.backward"):
            for i, g in zip(want, torch.autograd.grad(loss, [live[i] for i in want], allow_unused=True)):
                grads[i] = g
        loss = loss.detach()
        if self.axis is not None:
            with torch.no_grad(), tracing.stage("engine.all_reduce"):
                grads, loss = reduce_gradients(grads, loss, self.axis)
        return loss, grads, logits.detach(), new_bs

    def eval_step(self, batch: dict, cm: torch.Tensor):
        """Returns (loss, preds) as device tensors; updates ``cm`` in place."""
        return self._eval_core(self._to_device(batch), cm)

    def _eval_core(self, batch: dict, cm: torch.Tensor):
        """Under a mesh the loss is this rank's share of the batch's."""
        with torch.no_grad(), tracing.stage("engine.forward"):
            logits, _, _ = _unpack(self._apply(self.params, self.batch_stats, batch,
                                               train=False, generator=None))
            loss = cross_entropy(logits, batch["label"], batch["weight"],
                                 batch.get("weight_total"))
            preds = logits.argmax(dim=-1)
            M.confusion_update(cm, preds, batch["label"], batch["weight"])
        return loss, preds

    # --------------------------------------------------------------- epochs

    @staticmethod
    def _finish_losses(out: dict, loss_values) -> None:
        out["step_losses"] = loss_values
        finite = [l for l in loss_values if np.isfinite(l)]
        out["loss"] = float(np.mean(finite)) if finite else float("nan")
        out["skipped_steps"] = len(loss_values) - len(finite)
        if out["skipped_steps"]:
            print(f"  [nan-guard] skipped {out['skipped_steps']} non-finite update(s)")

    def _check_loader(self, loader) -> None:
        """A mesh engine of several ranks runs only a loader of its rank's
        input plan (the counterpart of the JAX engine's refusal of a
        default-device plan): any other would feed every rank the whole
        batch.  On one rank every loader's batch is the global batch."""
        if self.axis is None or (self.axis.size == 1 and getattr(loader, "plan", None) is None):
            return
        plan = getattr(loader, "plan", None)
        if plan is None or plan.D != self.axis.size or plan.position != self.axis.rank:
            raise ValueError(
                f"a mesh engine (rank {self.axis.rank} of {self.axis.size}) needs a loader built "
                "for its data axis: DeviceLoader(plan=parallel.input.make_input_plan(...)) with "
                "this rank's position")

    def _epoch_plan(self, loader) -> dict | None:
        self._check_loader(loader)
        plan_fn = getattr(loader, "epoch_plan", None)
        return plan_fn() if plan_fn is not None else None

    def _sum_over_ranks(self, *arrays) -> list[np.ndarray]:
        """Host arrays summed over the data axis in one collective; as they
        are without a mesh."""
        if self.axis is None:
            return [np.asarray(a) for a in arrays]
        from mgnns_tpu_torch.parallel.collectives import all_reduce_sum

        ts = [torch.as_tensor(np.asarray(a)).to(self.axis.device) for a in arrays]
        return [t.cpu().numpy() for t in all_reduce_sum(ts, self.axis)]

    @staticmethod
    def _batch_totals(plan: dict) -> np.ndarray:
        """[nb] global weight sum of each batch of an epoch plan."""
        if "weight_total" in plan:
            return np.asarray(plan["weight_total"], np.float64)
        return plan["weight"].sum(axis=1).astype(np.float64)

    def _train_epoch_plan(self, plan: dict) -> dict:
        run = self._graphs.train(plan)
        cm, = self._sum_over_ranks(run["cm"])
        out = M.metrics_from_confusion(cm)
        self._finish_losses(out, run["losses"].astype(np.float64).tolist())
        n, dt = int(self._batch_totals(plan).sum()), run["seconds"]
        out.update(samples_per_sec=n / dt if dt > 0 else 0.0, epoch_seconds=dt,
                   capture_seconds=run["capture_seconds"], fused=True)
        return out

    def _eval_epoch_plan(self, plan: dict, collect_preds: bool) -> dict:
        run = self._graphs.eval(plan)
        cm, lv = self._sum_over_ranks(run["cm"], run["losses"])
        out = M.metrics_from_confusion(cm)
        lv = lv.astype(np.float64)
        wv = self._batch_totals(plan)
        out["loss"] = float((lv * wv).sum() / max(wv.sum(), 1.0)) if lv.size else 0.0
        n, dt = int(wv.sum()), run["seconds"]
        out.update(samples_per_sec=n / dt if dt > 0 else 0.0, epoch_seconds=dt,
                   capture_seconds=run["capture_seconds"], confusion=cm, fused=True)
        if collect_preds:
            w = plan["weight"].reshape(-1).astype(bool)
            out["preds"] = run["preds"].reshape(-1)[w]
            out["targets"] = plan["labels"].reshape(-1)[w]
            out["sample_index"] = plan.get("sample_index", plan["idx"]).reshape(-1)[w]
        return out

    @tracing.span("engine.epoch", train=True)
    def train_epoch(self, loader: Iterable[dict], log_every: int = 0) -> dict:
        """One epoch: over ``loader.epoch_plan()`` when the loader has one
        (captured steps on the card), else batch by batch."""
        if self.opt is None:
            raise RuntimeError("Engine was built with eval_only=True; "
                               "it has no optimizer state to train with")
        plan = self._epoch_plan(loader)
        if plan is not None:
            return self._train_epoch_plan(plan)
        cm = M.confusion_init(self.num_classes, self.device)
        losses = []
        t0 = time.time()
        n = 0
        t_steady, n_steady = None, 0
        for i, batch in enumerate(loader):
            losses.append(self.train_step(batch, cm))  # device scalars, read once below
            n += int(np.asarray(batch.get("weight_total", batch["weight"])).sum())
            if i == 0:
                # the steady clock starts once step 1 has finished: it absorbs
                # one-time costs (kernel build, library handles)
                float(losses[0])
                t_steady, n_steady = time.time(), n
            if log_every and (i + 1) % log_every == 0:
                print(f"  [train {i+1}] loss={float(losses[-1]):.4f}")
        # one stacked readback of the per-step losses, which also waits for
        # every step (the device runs them in order)
        loss_values = torch.stack(losses).double().cpu().tolist() if losses else []
        t_end = time.time()
        dt = t_end - t0
        out = M.metrics_from_confusion(self._sum_over_ranks(cm.cpu().numpy())[0])
        self._finish_losses(out, loss_values)
        out["samples_per_sec"] = n / dt if dt > 0 else 0.0
        if t_steady is not None and n > n_steady and t_end > t_steady:
            out["steady_samples_per_sec"] = (n - n_steady) / (t_end - t_steady)
        out["epoch_seconds"] = dt
        return out

    @tracing.span("engine.epoch", train=False)
    def eval_epoch(self, loader: Iterable[dict], collect_preds: bool = False) -> dict:
        plan = self._epoch_plan(loader)
        if plan is not None:
            return self._eval_epoch_plan(plan, collect_preds)
        cm = M.confusion_init(self.num_classes, self.device)
        losses, wsums, all_preds, all_ids, all_tgts = [], [], [], [], []
        t0 = time.time()
        n = 0
        t_steady, n_steady = None, 0
        offset = getattr(loader, "record_offset", 0)
        for batch in loader:
            loss, preds = self.eval_step(batch, cm)
            losses.append(loss)
            w = np.asarray(batch["weight"])
            wsums.append(float(np.asarray(batch.get("weight_total", w)).sum()))
            n += int(wsums[-1])
            if t_steady is None:
                float(loss)  # see train_epoch
                t_steady, n_steady = time.time(), n
            if collect_preds:
                keep = w.astype(bool)
                all_preds.append(preds.cpu().numpy()[keep])
                all_tgts.append(np.asarray(batch["label"])[keep])
                if "sample_index" in batch:
                    all_ids.append(np.asarray(batch["sample_index"])[keep] + offset)
        lv = torch.stack(losses).double().cpu().numpy() if losses else np.zeros(0)
        cm_host, lv = self._sum_over_ranks(cm.cpu().numpy(), lv)
        dt = time.time() - t0
        out = M.metrics_from_confusion(cm_host)
        # weight each batch-mean loss by its valid-sample count (the last
        # batch is usually short; an unweighted mean would over-count it)
        if losses:
            wv = np.array(wsums)
            out["loss"] = float((lv * wv).sum() / max(wv.sum(), 1.0))
        else:
            out["loss"] = 0.0
        out["samples_per_sec"] = n / dt if dt > 0 else 0.0
        if t_steady is not None and n > n_steady and dt + t0 > t_steady:
            out["steady_samples_per_sec"] = (n - n_steady) / (dt + t0 - t_steady)
        out["epoch_seconds"] = dt
        out["confusion"] = cm_host
        if collect_preds:
            out["preds"] = np.concatenate(all_preds) if all_preds else np.zeros(0, np.int64)
            out["targets"] = np.concatenate(all_tgts) if all_tgts else np.zeros(0, np.int32)
            out["sample_index"] = np.concatenate(all_ids) if all_ids else None
        return out

    # ------------------------------------------------------------- learning

    def learning(
        self,
        train_loader_fn: Callable[[], Iterable[dict]],
        val_loader_fn: Callable[[], Iterable[dict]],
        test_loader_fn: Callable[[], Iterable[dict]] | None = None,
        *,
        max_epochs: int = 10,
        resume: bool = False,
        log_every: int = 0,
        result_paths: dict | None = None,
        run_config: dict | None = None,
        profile_dir: str | None = None,
        metrics_path: str | None = None,
    ) -> dict:
        """Train/val per epoch, checkpoint and best tracking, then test with
        the best parameters (reference ``learning``).  ``profile_dir``: a
        ``torch.profiler`` trace of the first epoch's training goes there."""
        if resume and self.checkpointer is not None and self.checkpointer.latest_step() is not None:
            self.restore()
        history = []
        first_epoch = self.epoch
        for epoch in range(self.epoch, max_epochs):
            self.epoch = epoch
            with torch_profile(profile_dir if epoch == first_epoch else None, self.device):
                tr = self.train_epoch(train_loader_fn(), log_every=log_every)
            va = self.eval_epoch(val_loader_fn())
            va.pop("confusion", None)
            steady = tr.get("steady_samples_per_sec")
            rate = (f"{tr['samples_per_sec']:.1f} samples/s"
                    + (f", {steady:.1f} steady" if steady is not None else ""))
            print(
                f"epoch {epoch}: train loss {tr['loss']:.4f} acc {tr['accuracy']:.4f} "
                f"({rate}) | val loss {va['loss']:.4f} "
                f"acc {va['accuracy']:.4f} macroF1 {va['macro_f1']:.4f}"
            )
            history.append({"epoch": epoch, "train": tr, "val": va})
            if metrics_path and self.is_writer:
                self._append_metrics(metrics_path, epoch, tr, va)
            self.best_score = max(self.best_score, va["accuracy"])
            if self.checkpointer is not None:
                self.save(metrics={"val_accuracy": va["accuracy"]})
        result = {"history": history, "best_val_accuracy": self.best_score}
        if test_loader_fn is not None:
            if self.checkpointer is not None and self.checkpointer.best_step() is not None:
                self.restore(self.checkpointer.best_step())
            te = self.eval_epoch(test_loader_fn(), collect_preds=True)
            print(
                f"test: acc {te['accuracy']:.4f} micro {te['micro_f1']:.4f} "
                f"macro {te['macro_f1']:.4f} weighted {te['weighted_f1']:.4f}"
            )
            result["test"] = {k: v for k, v in te.items() if k not in ("confusion",)}
            if result_paths:
                self._dump_results(te, result_paths, run_config or {})
        return result

    @staticmethod
    def _append_metrics(path: str, epoch: int, tr: dict, va: dict) -> None:
        """One JSON line per epoch."""
        keep = ("loss", "accuracy", "micro_f1", "macro_f1", "weighted_f1",
                "samples_per_sec", "steady_samples_per_sec", "epoch_seconds",
                "capture_seconds", "skipped_steps", "fused")
        row = {
            "ts": time.time(),
            "epoch": epoch,
            "train": {k: float(tr[k]) for k in keep if k in tr},
            "val": {k: float(va[k]) for k in keep if k in va},
        }
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "a") as f:
            f.write(json.dumps(row) + "\n")

    def _gather_preds(self, ids, targets, preds):
        """Every rank's (record ids, targets, predictions), concatenated in
        rank order (``_gather_pred_blocks``, ``mgnns_tpu/engine/train.py:737-760``):
        one packed ``int64 [3, m]`` block per rank, blocks of any width.
        The ids are global record ids already (``DeviceLoader.record_offset``),
        so no host offset is added here.  A collective."""
        from mgnns_tpu_torch.parallel.collectives import gather_blocks

        if ids is None:
            ids = np.arange(len(preds))
        block = torch.from_numpy(np.stack([np.asarray(a, np.int64)
                                           for a in (ids, targets, preds)]).reshape(3, -1))
        got = torch.cat(gather_blocks(block, self.axis), dim=1).numpy()
        return got[0], got[1], got[2]

    def _dump_results(self, te: dict, paths: dict, run_config: dict) -> None:
        """Reference-style result files (``engine/...:447-507``).  Under a
        mesh every rank calls it (the prediction gather is a collective) and
        rank 0 writes the files, the prediction file holding every record of
        the split."""
        ids, targets, preds = te.get("sample_index"), te.get("targets"), te.get("preds")
        if self.axis is not None and preds is not None:
            ids, targets, preds = self._gather_preds(ids, targets, preds)
        if not self.is_writer:
            return
        exp_path = paths.get("experiment")
        if exp_path:
            os.makedirs(os.path.dirname(exp_path) or ".", exist_ok=True)
            with open(exp_path, "a") as f:
                f.write(f"config: {run_config}\n")
                f.write(
                    "acc: {accuracy:.6f} micro_f1: {micro_f1:.6f} macro_f1: "
                    "{macro_f1:.6f} weighted_f1: {weighted_f1:.6f}\n".format(**te)
                )
                f.write(M.classification_report(te["confusion"], paths.get("label_names")) + "\n")
        pred_path = paths.get("pred")
        if pred_path and preds is not None:
            os.makedirs(os.path.dirname(pred_path) or ".", exist_ok=True)
            if ids is None:
                ids = np.arange(len(preds))
            order = np.argsort(np.asarray(ids), kind="stable")  # ascending record id
            with open(pred_path, "w") as f:
                f.write("ID\tTarget\tPred\n")
                for i in order:
                    f.write(f"{int(ids[i])}\t{int(targets[i])}\t{int(preds[i])}\n")

    # ---------------------------------------------------------- checkpoints

    def _payload(self) -> dict:
        """The train state with whole, unpadded leaves (a collective on a
        model axis)."""
        opt_state = self.opt_state
        if self.model_axis is not None and self.opt is not None:
            from mgnns_tpu_torch.parallel.sharding import unshard_leaves

            opt_state = self._map_opt_state(opt_state, unshard_leaves)
        return {"params": self.full_params(), "batch_stats": self.batch_stats,
                "opt_state": opt_state, "step": self.step, "epoch": self.epoch,
                "best_score": self.best_score}

    def save(self, metrics: dict | None = None) -> None:
        """Checkpoint the train state; every rank of a mesh calls it."""
        assert self.checkpointer is not None
        self.checkpointer.save(self.step, self._payload(), metrics)

    def restore(self, step: int | None = None, checkpointer=None) -> None:
        """Load the full train state saved at ``step`` (default: the latest)
        onto the engine's device; training resumes at the next epoch.  The
        saved trees must have the leaves of the engine's (a checkpoint with
        dead modules needs an engine built with them); a missing or extra
        leaf raises ``ValueError``.  On a model axis the whole leaves are
        sharded for this mesh, whatever mesh wrote them."""
        checkpointer = checkpointer or self.checkpointer
        assert checkpointer is not None
        restored = checkpointer.restore(step, device=self.device)
        for name in ("params", "batch_stats"):
            want, got = set(tree_paths(getattr(self, name))), set(tree_paths(restored[name]))
            if want != got:
                raise ValueError(
                    f"checkpoint {name} do not match the engine's: missing "
                    f"{sorted(want - got)[:5]}, extra {sorted(got - want)[:5]}")
        self.params = restored["params"]
        self.batch_stats = restored["batch_stats"]
        self.opt_state = restored["opt_state"]
        self.step = int(restored["step"])
        self.epoch = int(restored["epoch"]) + 1
        self.best_score = float(restored["best_score"])
        self._shard()
        if self.opt is not None:
            self.opt.label(self.params)  # the saved dict order is the state's leaf order
            self.opt_state = self.opt.adopt(self.opt_state, self.device)
            if self.model_axis is not None:
                from mgnns_tpu_torch.parallel.sharding import shard_leaves

                self.opt_state = self._map_opt_state(self.opt_state, shard_leaves)
        self._graphs.clear()  # they read the tensors just replaced

    def restore_from_dir(self, path: str, step: int | None = None) -> None:
        """Resume the full train state from a directory of the port's
        checkpoints other than the engine's own; nothing in ``path`` is
        pruned or written."""
        from mgnns_tpu_torch.engine.checkpoint import Checkpointer

        self.restore(step, checkpointer=Checkpointer(path, max_to_keep=0))

    def load_model_state(self, params: Any, batch_stats: Any) -> None:
        """Replace the parameters and running statistics (for example weights
        converted from the JAX package or imported from a reference
        checkpoint, whose dead modules the optimizer then freezes) and start
        a fresh optimizer state, as the reference's resume does.  The trees
        are whole; on a model axis each rank keeps its shards."""
        self._set_state(params, batch_stats)
        self._graphs.clear()  # they read the tensors just replaced
