"""Profile one captured train epoch many times, with and without idle margins
around each profiled run, and find where the kernels a run loses sit.

    python3 -m mgnns_tpu_torch.tools.profiler_drops [--runs 5] [--mesh] [--out DIR]

Run from the repository root on a machine with a CUDA card.  The epoch is
the fusion model's at full width in float32 (batch BatchNorm, 64 synthetic
records at B=16: four CUDA-graph replays of the train step over device
tables), as ``chip_smoke.py``'s phase 8 trains it; with ``--mesh``, on
the engine of a 1-rank NCCL process group, as phase 9b trains it.  Each
run reads the epoch's device events through
:func:`mgnns_tpu_torch.tools._bench_util.device_events`, in turns with no
margin and with ``PROFILE_MARGIN_S`` of idle before and after each call.  A
complete run sees K1 and K2 once per step and the most launches of all runs.

Every run's kernels, in the order they started, are held against those of
the run with the most launches: where its first and last ``EDGE`` kernels
sit in that run says how many it lost at the trace window's start and at
its end (``at_start``, ``at_end``); ``inside`` is the rest.  (Between the
edges the order of kernels that start together varies from run to run, so
only the edges are compared.)  Kineto's log
(``KINETO_LOG_LEVEL=1``: info and warnings) goes to ``<out>/kineto.log``;
each run's lines that speak of dropped records or an overflow are printed
beside its counts, as CUPTI's full activity buffers would show.  The last
line is a JSON summary with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
from array import array

WORDS = re.compile(r"drop|overflow", re.IGNORECASE)


def one_rank_mesh():
    """A process group of this process alone over NCCL, joined as
    ``torchrun --nproc_per_node 1`` would describe it, and its mesh."""
    import socket

    from mgnns_tpu_torch.parallel import multihost
    from mgnns_tpu_torch.parallel.mesh import create_mesh

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK="0", WORLD_SIZE="1",
                      LOCAL_RANK="0", LOCAL_WORLD_SIZE="1")
    if not multihost.initialize(device="cuda"):
        raise SystemExit("the 1-rank NCCL process group did not form")
    return create_mesh(1, device="cuda")


EDGE = 32


def edges(seq: array, ref: array) -> dict:
    """How many of ``ref``'s kernels ``seq`` lacks before its first ``EDGE``
    kernels and after its last (None where they are not found in ``ref``
    within the count lost), and the rest."""
    lost = len(ref) - len(seq)
    head, tail = seq[:EDGE].tobytes(), seq[len(seq) - EDGE:].tobytes()
    at_start = next((d for d in range(lost + 1) if ref[d:d + EDGE].tobytes() == head), None)
    at_end = next((d for d in range(lost + 1)
                   if ref[len(ref) - d - EDGE:len(ref) - d].tobytes() == tail), None)
    inside = None if None in (at_start, at_end) else lost - at_start - at_end
    return {"lost": lost, "at_start": at_start, "at_end": at_end, "inside": inside}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=5, help="runs of each margin")
    ap.add_argument("--mesh", action="store_true",
                    help="train on a 1-rank NCCL mesh (phase 9b's engine)")
    ap.add_argument("--out", default=os.path.join("build", "profiler_drops"))
    args = ap.parse_args(argv)
    # read when the profiler starts up, so before its first use
    os.environ.setdefault("KINETO_LOG_LEVEL", "1")
    import torch

    from mgnns_tpu_torch.data.loader import DeviceLoader
    from mgnns_tpu_torch.engine.train import Engine
    from mgnns_tpu_torch.tools import _bench_util as U

    if not torch.cuda.is_available():
        raise SystemExit("profiler_drops needs a CUDA card")
    os.makedirs(args.out, exist_ok=True)
    data = U.flagship_data("synthetic", n_records=64)
    model = U.flagship_model(data, device="cuda", compute_dtype="float32", bn_mode="batch")
    mesh = one_rank_mesh() if args.mesh else None
    eng = Engine(model.apply_fn, model.params, model.bstats, num_classes=data.ds.num_classes,
                 steps_per_epoch=4, mesh=mesh, device="cuda")
    loader = DeviceLoader(data.ds, 16, shuffle=True, device_images=True, device_text=True,
                          device="cuda")
    first = eng.train_epoch(loader)  # table upload and capture
    steps = len(loader)
    ids: dict = {}

    def sequence(prof) -> array:
        kernels = sorted(U.kernel_events(prof.events()), key=lambda e: e.time_range.start)
        return array("i", (ids.setdefault(e.key, len(ids)) for e in kernels))

    log_path = os.path.join(args.out, "kineto.log")
    saved = os.dup(2)
    runs, seqs = [], []
    with open(log_path, "w+b") as log:
        os.dup2(log.fileno(), 2)
        try:
            for i in range(2 * args.runs):
                margin = 0.0 if i % 2 == 0 else U.PROFILE_MARGIN_S
                start = log.seek(0, os.SEEK_END)
                ev = U.device_events(lambda: eng.train_epoch(loader),
                                     {"k1": "edge_max_fwd_kernel", "k2": "edge_max_bwd_kernel"},
                                     margin_s=margin, inspect=sequence)
                sys.stderr.flush()
                log.seek(start)
                said = [ln for ln in log.read().decode(errors="replace").splitlines()
                        if WORDS.search(ln)]
                seqs.append(ev["inspected"])
                runs.append({"run": i, "margin_s": margin, "launches": ev["launches"],
                             "k1": ev["k1"], "k2": ev["k2"], "busy_ms": ev["busy_ms"],
                             "wall_ms": ev["wall_ms"], "kineto_lines": said[:5]})
        finally:
            os.dup2(saved, 2)
            os.close(saved)
    if mesh is not None:
        torch.distributed.destroy_process_group()
    ref = max(range(len(runs)), key=lambda i: runs[i]["launches"])
    names = {v: k for k, v in ids.items()}
    for r, seq in zip(runs, seqs):
        r["complete"] = r["launches"] == runs[ref]["launches"] and r["k1"] == r["k2"] == steps
        r.update(edges(seq, seqs[ref]))
        if r["at_start"]:  # the first kernels missing
            r["first_lost"] = [names[k][:80] for k in seqs[ref][:3]]
        if r["at_end"]:  # the last kernels missing
            r["last_lost"] = [names[k][:80] for k in seqs[ref][len(seqs[ref]) - 3:]]
        print(json.dumps(r), flush=True)
    card = U.device_info(torch.device("cuda", 0))
    print(f"{card['name']}, {card['power_limit']}")
    summary = {"mesh": args.mesh, "steps": steps, "fused": bool(first.get("fused")),
               "most_launches": runs[ref]["launches"]}
    for margin in (0.0, U.PROFILE_MARGIN_S):
        arm = [r for r in runs if r["margin_s"] == margin]
        summary[f"margin_{margin}"] = {
            "runs": len(arm), "incomplete": sum(not r["complete"] for r in arm),
            "lost_at_start_end_inside": [[r["at_start"], r["at_end"], r["inside"]]
                                         for r in arm if r["lost"] > 0],
            "with_kineto_lines": sum(bool(r["kineto_lines"]) for r in arm)}
    print(json.dumps({**summary, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
