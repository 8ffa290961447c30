"""The training and evaluation engine: steps, epoch loop, checkpoints, results.

Port of the loop path of the JAX package's ``mgnns_tpu/engine/train.py``:

- ``train_step``: forward, ``CE + aux_loss_weight * aux``, backward, the
  optimizer (:mod:`mgnns_tpu_torch.engine.optim`) and the confusion-matrix
  update.  The nan-guard reads ``isfinite(loss)`` on the host once per step:
  a non-finite loss leaves the parameters, the optimizer state and the BN
  running statistics as they were and adds nothing to the epoch's metrics;
- metrics accumulate on the device in a confusion matrix and are finalized
  per epoch; the per-step losses are read back once per epoch, stacked;
- step LR decay lives in the optimizer's schedule;
- ``torch.save`` checkpoints every epoch with best-by-val-accuracy tracking
  and resume; the test split's results go to the reference's
  experiment/pred text files.

The step's three phases are ``torch.profiler`` ranges (``engine.forward``,
``engine.backward``, ``engine.optimizer``).  The engine never inspects the
model: it takes an ``apply_fn`` of signature
``(params, batch_stats, batch, *, train, generator) -> (logits,
new_batch_stats[, aux])``, where ``aux`` is a scalar loss term.  Dropout in
step ``s`` draws from a generator seeded by ``(seed, s)``.

Not ported (``ROADMAP.md``): the fused whole-epoch programs and the segment
ladder (XLA dispatch machinery; their CUDA counterpart would be graph
capture of the step), the mesh and multihost branches and the prediction
gather across hosts.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Callable, Iterable

import numpy as np
import torch
from torch.profiler import record_function

from mgnns_tpu_torch.engine import metrics as M
from mgnns_tpu_torch.engine.optim import Optimizer
from mgnns_tpu_torch.nn.core import derive_seed
from mgnns_tpu_torch.utils import (
    resolve_device, tree_leaves, tree_map, tree_paths, tree_to, tree_unflatten,
)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Weighted-mean CE over valid rows (reference ``nn.CrossEntropyLoss``)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = logp.gather(1, labels.long()[:, None])[:, 0]
    w = weights.float()
    return -(ll * w).sum() / torch.clamp(w.sum(), min=1.0)


def _unpack(out):
    # apply_fn may return (logits, new_bs) or (logits, new_bs, aux_loss)
    return (out[0], out[1], out[2]) if len(out) == 3 else (out[0], out[1], 0.0)


def _detach(tree):
    return tree_map(lambda t: t.detach() if isinstance(t, torch.Tensor) else t, tree)


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
    ):
        """``params`` / ``batch_stats`` are moved to ``device``, which raises
        when it is CUDA and no card is present.  ``eval_only`` builds no
        optimizer state."""
        self.device = resolve_device(device)
        self.apply_fn = apply_fn
        self.num_classes = num_classes
        self.aux_loss_weight = aux_loss_weight
        self.nan_guard = nan_guard
        self.seed = seed
        self.params = tree_to(params, self.device)
        self.batch_stats = tree_to(batch_stats, self.device)
        self.opt = None if eval_only else Optimizer(
            self.params, lr=lr, lrp=lrp, weight_decay=weight_decay, grad_clip=grad_clip,
            steps_per_epoch=steps_per_epoch, epoch_step=epoch_step, lr_decay=lr_decay,
            faithful=faithful_param_groups, accumulation_steps=accumulation_steps,
            freeze_trunks=freeze_trunks, algo=optimizer_algo)
        self.opt_state = self.opt.init(self.params) if self.opt is not None else None
        self.step = 0
        self.checkpointer = None
        if checkpoint_dir is not None:
            from mgnns_tpu_torch.engine.checkpoint import Checkpointer

            self.checkpointer = Checkpointer(checkpoint_dir, max_to_keep)
        self.epoch = 0
        self.best_score = 0.0

    # ---------------------------------------------------------------- steps

    def _to_device(self, batch: dict) -> dict:
        return {k: torch.as_tensor(v).to(self.device, non_blocking=True) for k, v in batch.items()}

    def train_step(self, batch: dict, cm: torch.Tensor) -> torch.Tensor:
        """One optimizer (micro-)step on ``batch``; returns the loss, a device
        scalar.  Updates ``cm`` in place unless the nan-guard skips the step."""
        if self.opt is None:
            raise RuntimeError("Engine was built with eval_only=True; "
                               "it has no optimizer state to train with")
        batch = self._to_device(batch)
        gen = torch.Generator(device=self.device).manual_seed(derive_seed(self.seed, self.step))
        leaves = tree_leaves(self.params)
        live = [p.detach().requires_grad_(p.is_floating_point()) for p in leaves]
        with record_function("engine.forward"):
            logits, new_bs, aux = _unpack(self.apply_fn(
                tree_unflatten(self.params, live), self.batch_stats, batch, train=True, generator=gen))
            loss = cross_entropy(logits, batch["label"], batch["weight"]) + self.aux_loss_weight * aux
        want = [i for i, p in enumerate(live) if p.requires_grad]
        grads: list = [None] * len(live)
        with record_function("engine.backward"):
            for i, g in zip(want, torch.autograd.grad(loss, [live[i] for i in want], allow_unused=True)):
                grads[i] = g
        self.step += 1
        if self.nan_guard and not bool(torch.isfinite(loss)):
            return loss.detach()
        with torch.no_grad(), record_function("engine.optimizer"):
            self.opt.apply(leaves, grads, self.opt_state)
            self.batch_stats = _detach(new_bs)
            M.confusion_update(cm, logits.argmax(dim=-1), batch["label"], batch["weight"])
        return loss.detach()

    def eval_step(self, batch: dict, cm: torch.Tensor):
        """Returns (loss, preds) as device tensors; updates ``cm`` in place."""
        batch = self._to_device(batch)
        with torch.no_grad():
            logits, _, _ = _unpack(self.apply_fn(self.params, self.batch_stats, batch,
                                                 train=False, generator=None))
            loss = cross_entropy(logits, batch["label"], batch["weight"])
            preds = logits.argmax(dim=-1)
            M.confusion_update(cm, preds, batch["label"], batch["weight"])
        return loss, preds

    # --------------------------------------------------------------- epochs

    @staticmethod
    def _finish_losses(out: dict, loss_values) -> None:
        finite = [l for l in loss_values if np.isfinite(l)]
        out["loss"] = float(np.mean(finite)) if finite else float("nan")
        out["skipped_steps"] = len(loss_values) - len(finite)
        if out["skipped_steps"]:
            print(f"  [nan-guard] skipped {out['skipped_steps']} non-finite update(s)")

    def train_epoch(self, loader: Iterable[dict], log_every: int = 0) -> dict:
        cm = M.confusion_init(self.num_classes, self.device)
        losses = []
        t0 = time.time()
        n = 0
        t_steady, n_steady = None, 0
        for i, batch in enumerate(loader):
            losses.append(self.train_step(batch, cm))  # device scalars, read once below
            n += int(np.asarray(batch["weight"]).sum())
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
        out = M.metrics_from_confusion(cm.cpu().numpy())
        self._finish_losses(out, loss_values)
        out["samples_per_sec"] = n / dt if dt > 0 else 0.0
        if t_steady is not None and n > n_steady and t_end > t_steady:
            out["steady_samples_per_sec"] = (n - n_steady) / (t_end - t_steady)
        out["epoch_seconds"] = dt
        return out

    def eval_epoch(self, loader: Iterable[dict], collect_preds: bool = False) -> dict:
        cm = M.confusion_init(self.num_classes, self.device)
        losses, wsums, all_preds, all_ids, all_tgts = [], [], [], [], []
        t0 = time.time()
        n = 0
        t_steady, n_steady = None, 0
        for batch in loader:
            loss, preds = self.eval_step(batch, cm)
            losses.append(loss)
            w = np.asarray(batch["weight"])
            wsums.append(float(w.sum()))
            n += int(wsums[-1])
            if t_steady is None:
                float(loss)  # see train_epoch
                t_steady, n_steady = time.time(), n
            if collect_preds:
                keep = w.astype(bool)
                all_preds.append(preds.cpu().numpy()[keep])
                all_tgts.append(np.asarray(batch["label"])[keep])
                if "sample_index" in batch:
                    all_ids.append(np.asarray(batch["sample_index"])[keep])
        lv = torch.stack(losses).double().cpu().numpy() if losses else np.zeros(0)
        dt = time.time() - t0
        cm_host = cm.cpu().numpy()
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
        metrics_path: str | None = None,
    ) -> dict:
        """Train/val per epoch, checkpoint and best tracking, then test with
        the best parameters (reference ``learning``)."""
        if resume and self.checkpointer is not None and self.checkpointer.latest_step() is not None:
            self.restore()
        history = []
        for epoch in range(self.epoch, max_epochs):
            self.epoch = epoch
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
            if metrics_path:
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
                "skipped_steps")
        row = {
            "ts": time.time(),
            "epoch": epoch,
            "train": {k: float(tr[k]) for k in keep if k in tr},
            "val": {k: float(va[k]) for k in keep if k in va},
        }
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "a") as f:
            f.write(json.dumps(row) + "\n")

    @staticmethod
    def _dump_results(te: dict, paths: dict, run_config: dict) -> None:
        """Reference-style result files (``engine/...:447-507``)."""
        ids, targets, preds = te.get("sample_index"), te.get("targets"), te.get("preds")
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
        return {"params": self.params, "batch_stats": self.batch_stats,
                "opt_state": self.opt_state, "step": self.step, "epoch": self.epoch,
                "best_score": self.best_score}

    def save(self, metrics: dict | None = None) -> None:
        assert self.checkpointer is not None
        self.checkpointer.save(self.step, self._payload(), metrics)

    def restore(self, step: int | None = None, checkpointer=None) -> None:
        """Load the full train state saved at ``step`` (default: the latest)
        onto the engine's device; training resumes at the next epoch.  The
        saved trees must have the leaves of the engine's (a checkpoint with
        dead modules needs an engine built with them); a missing or extra
        leaf raises ``ValueError``."""
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
        if self.opt is not None:
            self.opt.label(self.params)  # the saved dict order is the state's leaf order

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
        a fresh optimizer state, as the reference's resume does."""
        self.params = tree_to(params, self.device)
        self.batch_stats = tree_to(batch_stats, self.device)
        self.opt_state = self.opt.init(self.params) if self.opt is not None else None
