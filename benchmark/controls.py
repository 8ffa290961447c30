"""Read the numbers that decide ``correct`` on many seeds in one process,
beside the control's and the planted faults' readings.

    python3 -m benchmark.controls --workload <cell> --seeds 11,12,13 --seconds 3 \\
        [--variants control,half_batch] [--out chiprun_out/controls.jsonl]

For each seed it runs the cell as ``benchmark.run`` does (a short window),
then prints one JSON line: the program's readings (the lower readings of
each limit) and, for each variant, the reading of the reference put in the
program's place in that variant (the upper readings): ``control``, the
reference one precision below the cell's (float8 trunks for bf16, TF32
for float32), and for a training cell ``half_batch``, each batch's loss
taken over half of its rows.  The benchmark's own runs do not run these.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from benchmark import harness as H


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="the readings behind a cell's limits")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--variants", default="control")
    p.add_argument("--out", default=None)
    p.add_argument("--config", default=None,
                   help="the cell's configuration, where BENCHMARK.json does not list the cell")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("the readings are taken on a CUDA card", file=sys.stderr)
        return 2
    config = H.config_of(args.workload, args.config)
    variants = [v for v in args.variants.split(",") if v]
    for seed in (int(s) for s in args.seeds.split(",")):
        params = dict(H.load_json("workloads", args.workload), variants=variants)
        cell = H.Cell(name=args.workload, config=config,
                      params=params, seed=seed, seconds=args.seconds, trace=False,
                      device=torch.device("cuda:0"))
        t = time.perf_counter()
        out = H.load_code("mixes", params["mix"]).run(cell, t)
        row = {"seed": seed, "seconds": time.perf_counter() - t,
               "program": {c.name: c.value for c in out.checks},
               **{v: {c.name: c.value for c in out.counters.get(v, [])} for v in variants},
               "end_to_end": out.end_to_end}
        print(json.dumps(row), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(row) + "\n")
        H.free_device()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
