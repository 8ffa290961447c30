"""Checkpoints of the full train state with ``torch.save``.

Port of the JAX package's ``mgnns_tpu/engine/checkpoint.py`` (Orbax there).
Each save writes ``<dir>/step_<n>.pt`` atomically (a temporary file, then
``os.replace``).  Retention keeps the newest ``max_to_keep`` steps plus the
best step by validation accuracy, which ``<dir>/best.json`` records, so a
resume never rolls back past the latest step.  Reading the JAX package's
Orbax checkpoints is queued in ``ROADMAP.md``.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any

import torch

from mgnns_tpu_torch.utils import resolve_device

_STEP_FILE = re.compile(r"^step_(\d+)\.pt$")


class Checkpointer:
    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self._best_path = os.path.join(self.directory, "best.json")

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}.pt")

    def all_steps(self) -> list[int]:
        return sorted(int(m.group(1)) for m in map(_STEP_FILE.match, os.listdir(self.directory)) if m)

    # ----------------------------------------------------------------- best

    def _read_best(self) -> dict | None:
        if os.path.exists(self._best_path):
            with open(self._best_path) as f:
                return json.load(f)
        return None

    def best_step(self) -> int | None:
        best = self._read_best()
        return None if best is None else int(best["step"])

    # ----------------------------------------------------------------- save

    def save(self, step: int, state: Any, metrics: dict | None = None) -> None:
        path = self._path(step)
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save(state, tmp)
        os.replace(tmp, path)
        score = (metrics or {}).get("val_accuracy")
        if score is not None:
            best = self._read_best()
            if best is None or score > best["score"]:
                tmp = f"{self._best_path}.{os.getpid()}.tmp"
                with open(tmp, "w") as f:
                    json.dump({"step": int(step), "score": float(score)}, f)
                os.replace(tmp, self._best_path)
        self._prune()

    def _prune(self) -> None:
        steps = self.all_steps()
        keep = set(steps[-self.max_to_keep:]) if self.max_to_keep else set(steps)
        best = self.best_step()
        if best is not None:
            keep.add(best)
        for s in steps:
            if s not in keep:
                os.remove(self._path(s))

    # -------------------------------------------------------------- restore

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int | None = None, device="cuda") -> Any:
        """The state saved at ``step`` (default: the latest), with its tensors
        on ``device``, which raises when it is CUDA and no card is present."""
        dev = resolve_device(device)
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        return torch.load(self._path(step), map_location=dev)
