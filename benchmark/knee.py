"""Find a serving cell's knee: the highest offered rate at which the backlog
does not grow through the window.

    python3 -m benchmark.knee --workload <serve cell> --rates 20,40,60 --seconds 10

sets the cell up once on the card, then offers each rate's open loop for
``--seconds`` in turn and prints one JSON line a rate: requests, answers,
refusals, the percentiles, the deepest request queue seen, and
``growth``, the median latency of the window's last quarter of requests
over its first quarter's.  A rate the system sustains keeps ``growth``
near 1, refuses nothing and keeps the queue shallow; past the knee the
queue and the latencies grow all through the window.  The cell's rate is
set by hand to about four fifths of the knee found.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from benchmark import compare as C
from benchmark import harness as H


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="the knee of a serving cell")
    p.add_argument("--workload", required=True)
    p.add_argument("--rates", required=True, help="comma-separated requests a second")
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--seed", type=int, default=12345)
    p.add_argument("--config", default=None,
                   help="the cell's configuration, where BENCHMARK.json does not list the cell")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("the knee is found on a CUDA card", file=sys.stderr)
        return 2
    config = H.config_of(args.workload, args.config)
    cell = H.Cell(name=args.workload, config=config,
                  params=H.load_json("workloads", args.workload), seed=args.seed,
                  seconds=args.seconds, trace=False, device=torch.device("cuda:0"))
    served = H.load_code("mixes", cell.params["mix"]).Served(cell)
    H.settle()
    try:
        for k, rate in enumerate(float(x) for x in args.rates.split(",")):
            r = served.window(rate, args.seconds, args.seed + k)
            lat = np.array(r["lat"])
            q = max(len(lat) // 4, 1)
            first, last = np.nanmedian(lat[:q]), np.nanmedian(lat[-q:])
            print(json.dumps({
                "rate": rate, "requests": len(r["due"]), "answered": len(r["ok_lat"]),
                "refused": len(r["refused"]), "unanswered": len(r["unanswered"]),
                "p50_ms": C.percentile(r["ok_lat"], r["failed"], 50) * 1e3,
                "p95_ms": C.percentile(r["ok_lat"], r["failed"], 95) * 1e3,
                "max_queue_depth": max(d for _, d in r["depth"]),
                "growth": float(last / first), "late_max_ms": float(r["late"].max() * 1e3)}),
                flush=True)
    finally:
        served.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
