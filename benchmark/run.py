"""Run one cell of the benchmark once and print its result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the repository's root.  The cell's entry in ``BENCHMARK.json`` names
its configuration; ``benchmark/workloads/<cell>.json`` holds its traffic
parameters and the mix that drives them.  With ``--trace 0`` the result's
metrics are the cell's end-to-end metrics, with ``--trace 1`` its per-layer
metrics, read from a profiled stretch of the window.  The numbers that
decide ``correct`` are printed beside their limits as the last lines of
standard error, and under ``"compared"`` at the end of the result line,
the last line of standard output.  Without a CUDA card, or with fewer than
the cell needs, it prints no result and exits 2.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

if __package__ in (None, ""):  # run as a file: the repository root on the path
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from benchmark import harness as H  # noqa: E402


def main(argv=None, device: str | None = None) -> int:
    """``device``: run there instead of the first CUDA card, with no check
    for one (the CPU tests drive whole runs of toy cells this way)."""
    p = argparse.ArgumentParser(description="one run of one benchmark cell")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    bench = H.benchmark_json()
    entry = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if entry is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    if device is None and (not torch.cuda.is_available()
                           or torch.cuda.device_count() < entry["chips"]):
        print(f"{args.workload} needs {entry['chips']} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    with open(os.path.join(H.ROOT, conf["file"])) as f:
        config = json.load(f)
    params = H.load_json("workloads", args.workload)
    cell = H.Cell(name=args.workload, config=config, params=params, seed=args.seed,
                  seconds=args.seconds, trace=bool(args.trace),
                  device=torch.device(device or "cuda:0"))
    outcome = H.load_code("mixes", params["mix"]).run(cell, T_START)
    found = H.forbidden_modules()
    if found:
        print(f"the run loaded {found}: it must not load JAX or the package it was ported "
              "from", file=sys.stderr)
        return 3
    e2e, pl = H.cell_metrics(bench, args.workload)
    line = H.result_line(cell, outcome, e2e, pl)
    H.print_checks(outcome.checks)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
