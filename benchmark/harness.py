"""The harness: what a run reads by name, and what it prints.

A cell (``workloads/<cell>.json``) names its configuration
(``configs/<config>.json``) and its traffic mix's driver
(``mixes/<mix>.py``, a ``run(cell) -> Outcome``); a per-layer metric is a
reader of its own (``metrics/<metric>.py``, a ``read(ctx) -> float | None``).
All are found by the names in ``BENCHMARK.json``, so a later cell, mix or
metric is a file added, not an edit.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
import time
from dataclasses import dataclass, field

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# what a run must not have loaded: JAX and the package the port was ported from
FORBIDDEN = ("jax", "jaxlib", "flax", "mgnns_tpu")


def load_json(kind: str, name: str) -> dict:
    with open(os.path.join(HERE, kind, f"{name}.json")) as f:
        return json.load(f)


def load_code(kind: str, name: str):
    """The module ``benchmark/<kind>/<name>.py`` (names may hold dots)."""
    path = os.path.join(HERE, kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"benchmark.{kind}.{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def benchmark_json() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def config_of(cell: str, name: str | None = None) -> dict:
    """The configuration of ``cell``: ``name``'s, or the one BENCHMARK.json
    gives the cell."""
    if name is None:
        bench = benchmark_json()
        name = next(w["config"] for w in bench["workloads"] if w["name"] == cell)
    return load_json("configs", name)


@dataclass
class Cell:
    """One run of one cell."""

    name: str
    config: dict           # configs/<config>.json
    params: dict           # workloads/<cell>.json
    seed: int
    seconds: float
    trace: bool
    device: torch.device


@dataclass
class Check:
    """One compared number: it passes at or under its limit."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value == self.value and self.value <= self.limit


@dataclass
class Outcome:
    """What a mix's run hands back."""

    end_to_end: dict                  # metric name -> value
    attempted: int
    failed: int
    checks: list                      # [Check]
    counters: dict = field(default_factory=dict)
    trace: object = None              # benchmark.trace.Trace of the traced stretch
    memory_peak_bytes: int = 0


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def device_block(device: torch.device, peak: int, trace=None) -> dict:
    """The result's ``device``: one card (every cell asks for one)."""
    out = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    if trace is not None:
        out["busy_s"] = trace.busy_s
        out["window_s"] = trace.window_s
    return out


def per_layer(cell: Cell, outcome: Outcome, specs: list) -> dict:
    """Each per-layer metric of the cell that its reader finds something for."""
    ctx = {"config": cell.config, "params": cell.params,
           "counters": outcome.counters, "trace": outcome.trace}
    out = {}
    for spec in specs:
        value = load_code("metrics", spec["name"]).read(ctx)
        if value is not None:
            out[spec["name"]] = {"value": float(value), "unit": spec["unit"]}
    return out


def cell_metrics(bench: dict, cell_name: str) -> tuple[list, list]:
    """(end-to-end, per-layer) metric entries that ``cell_name`` reports."""
    e2e = [m for m in bench["end_to_end"] if cell_name in m.get("workloads", [cell_name])]
    pl = [m for m in bench["per_layer"] if cell_name in m.get("workloads", [cell_name])]
    return e2e, pl


def result_line(cell: Cell, outcome: Outcome, e2e: list, pl: list) -> dict:
    ok = all(c.ok for c in outcome.checks)
    if cell.trace:
        metrics = per_layer(cell, outcome, pl)
    else:
        units = {m["name"]: m["unit"] for m in e2e}
        metrics = {k: {"value": float(v), "unit": units[k]}
                   for k, v in outcome.end_to_end.items() if k in units}
    out = {"correct": ok, "attempted": int(outcome.attempted), "failed": int(outcome.failed),
           "metrics": metrics,
           "device": device_block(cell.device, outcome.memory_peak_bytes,
                                  outcome.trace if cell.trace else None)}
    if cell.trace and outcome.trace is not None:
        out["breakdown"] = {"device_ops": outcome.trace.top_ops(),
                            "idle_gaps": outcome.trace.idle_gaps()}
    out["compared"] = {c.name: {"value": c.value, "limit": c.limit} for c in outcome.checks}
    return out


def print_checks(checks: list) -> None:
    for c in checks:
        print(f"compared {c.name} {c.value!r} limit {c.limit!r} "
              f"{'ok' if c.ok else 'OVER'}", file=sys.stderr, flush=True)


class Phases:
    """Seconds of each phase of set-up, from the process's start, printed
    on one line of standard error by ``done()``."""

    def __init__(self, t_start: float):
        self.last, self.parts = t_start, []

    def mark(self, name: str) -> None:
        now = time.perf_counter()
        self.parts.append(f"{name} {now - self.last:.2f} s")
        self.last = now

    def done(self) -> None:
        print("set-up: " + ", ".join(self.parts), file=sys.stderr, flush=True)


def settle() -> None:
    """End of set-up: collect, and move what set-up made out of the
    collector's reach, so that no long collection pauses the window."""
    import gc

    gc.collect()
    gc.freeze()


def free_device() -> None:
    """Free what the program held on the card (its reference cycles too)."""
    import gc

    gc.unfreeze()
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
