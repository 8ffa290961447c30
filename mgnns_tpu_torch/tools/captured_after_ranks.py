"""Run ``chip_smoke.py``'s phase 9a and then the card test of captured
against eager steps, in turns, several times in one process tree.

    python3 -m mgnns_tpu_torch.tools.captured_after_ranks [--runs 5] [--out DIR]

Run from the repository root on a machine with a CUDA card.  Phase 9a
starts two gloo ranks that share ``cuda:0`` and train the full-width fusion
model; right after it, ``python -m pytest --noconftest tests/test_torch_cuda.py
-k captured_steps_equal_eager_steps`` holds three captured train steps to
three eager ones at 1e-6 of each leaf's scale (dropout 0 and 0.5, with and
without per-block remat).  Each run's pytest output goes to
``<out>/run<i>.log``; one line per run gives the exit code and the test's
printed errors (losses, parameters with the worst leaf, BN statistics).  The
last line is a JSON summary with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--out", default=os.path.join("build", "captured_after_ranks"))
    args = ap.parse_args(argv)
    sys.path.insert(0, os.getcwd())
    import chip_smoke as S

    os.makedirs(args.out, exist_ok=True)
    data = S.flagship_data("synthetic")  # phase 3's data
    setup = {"vocab": data.vocab, "texts": data.ds.text.texts, "graph": data.graph,
             "object_A": data.consts_np["object_A"], "place_A": data.consts_np["place_A"]}
    runs = []
    for i in range(args.runs):
        t0 = time.perf_counter()
        S.phase9a(setup)
        t1 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "pytest", "--noconftest", "tests/test_torch_cuda.py", "-q",
             "-s", "-p", "no:cacheprovider", "-k", "captured_steps_equal_eager_steps"],
            capture_output=True, text=True, timeout=900)
        with open(os.path.join(args.out, f"run{i}.log"), "w") as f:
            f.write(proc.stdout + proc.stderr)
        # pytest -q prints a test's dot before the next test's output
        lines = [ln.lstrip(".") for ln in proc.stdout.splitlines() if "captured vs eager" in ln]
        runs.append({"run": i, "rc": proc.returncode, "phase9a_s": t1 - t0,
                     "pytest_s": time.perf_counter() - t1, "errors": lines})
        print(f"run {i}: pytest exit {proc.returncode}", flush=True)
        for ln in lines:
            print(f"  {ln}", flush=True)
    card = S.card_line()
    print(card)
    print(json.dumps({"runs": len(runs), "failed": sum(r["rc"] != 0 for r in runs),
                      "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
