"""Checkpoints of the full train state with ``torch.save``.

Port of the JAX package's ``mgnns_tpu/engine/checkpoint.py`` (Orbax there).
Each save writes ``<dir>/step_<n>.pt`` atomically (a temporary file, then
``os.replace``).  Retention keeps the newest ``max_to_keep`` steps plus the
best step by validation accuracy, which ``<dir>/best.json`` records, so a
resume never rolls back past the latest step; ``max_to_keep=0`` keeps every
step, and a ``Checkpointer`` that only restores removes nothing.  The port
reads no Orbax checkpoint: weights cross from the reference or the JAX
package as reference-named ``state_dict``s in ``.pth[.tar]`` files, through
:mod:`mgnns_tpu_torch.models.import_reference`.

On a mesh of several ranks (``Checkpointer(axis=...)``, which every rank
constructs; the engine passes the whole world) rank 0 writes and prunes, a
barrier follows each save, and every rank restores.  The engine hands it
whole, unpadded leaves on a model axis too, so what is saved does not
depend on the mesh.  The directory must be one path that every rank
sees: the constructor probes it (the JAX package's
``_verify_shared_directory``, ``mgnns_tpu/engine/checkpoint.py:32-90``)
and raises on every rank when it is not, where per-rank directories would
leave each rank reading checkpoints that only rank 0 wrote.
"""

from __future__ import annotations

import json
import os
import re
import time
from typing import Any

import torch

from mgnns_tpu_torch.utils import resolve_device

_STEP_FILE = re.compile(r"^step_(\d+)\.pt$")


class Checkpointer:
    def __init__(self, directory: str, max_to_keep: int = 3, axis=None):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self._best_path = os.path.join(self.directory, "best.json")
        self.axis = axis if axis is not None and axis.size > 1 else None
        if self.axis is not None:
            self._verify_shared_directory()

    def _verify_shared_directory(self) -> None:
        """Raise on every rank (so that none is left waiting in a collective)
        unless the directory is one path that every rank sees: rank 0 writes
        a token there, broadcast to all, and every rank must read it back."""
        from mgnns_tpu_torch.parallel.collectives import all_true, barrier, broadcast_

        axis = self.axis
        token = torch.tensor([int.from_bytes(os.urandom(4), "little") & 0x7FFFFFFF],
                             dtype=torch.int64, device=axis.device)
        broadcast_([token], axis)
        token = int(token.item())
        probe = os.path.join(self.directory, ".shared_fs_probe")
        if axis.rank == 0:
            try:
                with open(probe, "w") as f:
                    f.write(str(token))
            except OSError:
                pass  # the reads below fail too; never skip the barrier
        barrier(axis)
        deadline = time.monotonic() + 5.0
        while True:
            try:
                with open(probe) as f:
                    ok = int(f.read()) == token
            except (OSError, ValueError):
                ok = False
            # a shared mount's attribute cache can lag a peer's create
            if ok or time.monotonic() > deadline:
                break
            time.sleep(0.25)
        all_ok = all_true(ok, axis)
        if axis.rank == 0:
            try:
                os.remove(probe)
            except OSError:
                pass
        if not all_ok:
            raise RuntimeError(
                f"checkpoint directory {self.directory!r} is not shared across the "
                f"{axis.size} ranks (rank 0's probe file was not readable on every rank: "
                "unshared, or not writable by rank 0). Training on several hosts needs one "
                "writable checkpoint directory on a filesystem every host reaches.")

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
        """Write ``state`` as step ``step``; under an axis rank 0 writes and
        every rank returns once the files are in place."""
        if self.axis is None or self.axis.rank == 0:
            self._write(step, state, metrics)
        if self.axis is not None:
            from mgnns_tpu_torch.parallel.collectives import barrier

            barrier(self.axis)

    def _write(self, step: int, state: Any, metrics: dict | None) -> None:
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
