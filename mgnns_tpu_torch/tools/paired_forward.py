"""Time the 16-record fusion serving forward of several trees of this
repository in turns on one card.

    python3 -m mgnns_tpu_torch.tools.paired_forward TREE_A TREE_B [--turns 8] [--per_turn 3]

Each ``TREE`` is a directory holding a copy of the repository (for example
one commit unpacked with ``git archive`` under ``build/``).  One worker
process per tree imports that tree's ``mgnns_tpu_torch``, builds its kernels
into that tree's ``build/``, makes the fusion model of ``ModelConfig()`` from
a seed, a 10,000-document synthetic corpus over a 20,153-word vocabulary and
one 16-record request, and warms its ``Predictor``.  The parent then asks the
workers in turns (A B B A A B B A ...) for ``per_turn`` forwards each
(``Predictor._forward`` and a synchronize, on the host clock), and last for
one profiled forward each: device busy time, kernel launches, and the host
time of the model's stage ranges.  It prints one JSON line per tree and the
card's name and power limit.

Both workers hold a model on the card at once; only the one in its turn
runs.  Trees from before the package pinned its float32 convolutions get
torch's TF32 switched off for cuDNN, as the smoke test of that time did, so
every tree runs its trunk convolutions in IEEE float32.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

VOCAB_SIZE = 20153
N_DOCS = 10_000
LABELS = {name: i for i, name in enumerate(
    ["angry", "bored", "calm", "fear", "happy", "love", "sad"])}


def _worker(tree: str) -> None:
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    import mgnns_tpu_torch
    from mgnns_tpu_torch.config import ModelConfig, TextGraphConfig
    from mgnns_tpu_torch.graphs.cooccur import gen_A
    from mgnns_tpu_torch.graphs.pmi import cal_pmi
    from mgnns_tpu_torch.kernels import edge_max
    from mgnns_tpu_torch.models.mgnns import mgnns_init
    from mgnns_tpu_torch.nn import resnet
    from mgnns_tpu_torch.serving import Predictor

    if not os.path.abspath(mgnns_tpu_torch.__file__).startswith(tree + os.sep):
        raise SystemExit(f"worker imported {mgnns_tpu_torch.__file__}, not the tree {tree}")
    if not hasattr(resnet, "ieee_float32_convs"):
        torch.backends.cudnn.allow_tf32 = False
    r = np.random.default_rng(0)
    vocab = ["PAD", "UNK"] + [f"w{i}" for i in range(VOCAB_SIZE - 2)]
    p = 1.0 / np.arange(1, VOCAB_SIZE - 1) ** 1.1
    lens = r.integers(5, 91, N_DOCS)
    toks = r.choice(VOCAB_SIZE - 2, size=int(lens.sum()), p=p / p.sum())
    words = np.array(vocab[2:])[toks]
    texts = [" ".join(d) for d in np.split(words, np.cumsum(lens)[:-1])]
    graph = cal_pmi(texts, vocab, window_size=6, min_cooccurrence=2)
    r = np.random.default_rng(1)
    cfg = ModelConfig(edges_num=graph.num_edges)

    def cooccurrence(c):
        return {"nums": r.integers(1, 200, c).astype(float),
                "adj": r.integers(0, 60, (c, c)).astype(float)}

    object_A, _ = gen_A(80, cfg.object_t, cooccurrence(80), cfg.gama)
    place_A, _ = gen_A(365, cfg.place_t, cooccurrence(365), cfg.gama)
    made = mgnns_init(cfg, num_edges=graph.num_edges,
                      label_embedding=r.standard_normal((7, 300)).astype(np.float32),
                      object_A=object_A, place_A=place_A,
                      object_inp=r.standard_normal((80, 300)).astype(np.float32),
                      place_inp=r.standard_normal((365, 300)).astype(np.float32),
                      seed=0, device="cuda")
    # before the training slice mgnns_init returned (params, consts)
    model = dict(zip(("params", "batch_stats", "consts") if len(made) == 3
                     else ("params", "consts"), made))
    pred = Predictor(vocab=vocab, graph=graph, graph_cfg=TextGraphConfig(), label_map=LABELS,
                     cfg=cfg, image_backend="synthetic", max_batch=16, device="cuda", **model)
    pred.warm()
    batch_np, _ = pred._encode_host([{"id": f"t{i}", "text": texts[i]} for i in range(16)])
    print(json.dumps({"ready": tree}), flush=True)

    for line in sys.stdin:
        cmd = json.loads(line)
        if cmd["op"] == "time":
            walls = []
            for _ in range(cmd["n"]):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                pred._forward(batch_np)
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
            print(json.dumps({"wall_ms": walls}), flush=True)
        elif cmd["op"] == "profile":
            edge_max.launches = 0
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                pred._forward(batch_np)
                torch.cuda.synchronize()
            events = prof.key_averages()
            kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
                       and not e.key.startswith("mgnns.")]
            stages = {e.key: e.cpu_time_total / 1e3 for e in events
                      if e.key.startswith("mgnns.")
                      and e.device_type != torch.autograd.DeviceType.CUDA}
            print(json.dumps({
                "busy_ms": sum(e.self_device_time_total for e in kernels) / 1e3,
                "kernel_launches": sum(e.count for e in kernels),
                "k1_launches": edge_max.launches,
                "host_ms_profiled_by_stage": stages}), flush=True)
        else:
            break


def _ask(proc, cmd: dict) -> dict:
    proc.stdin.write(json.dumps(cmd) + "\n")
    proc.stdin.flush()
    line = proc.stdout.readline()
    if not line:
        raise SystemExit(f"worker {proc.args[-1]} ended without an answer")
    return json.loads(line)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--turns", type=int, default=8, help="turns of each tree")
    ap.add_argument("--per_turn", type=int, default=3, help="timed forwards a turn")
    args = ap.parse_args(argv)
    trees = [os.path.abspath(t) for t in args.trees]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--worker", t],
                              cwd=t, stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
             for t in trees]
    try:
        for pr in procs:
            line = pr.stdout.readline()
            if not line:
                raise SystemExit(f"worker {pr.args[-1]} failed to start")
            print(line.strip(), flush=True)
        walls: list[list[float]] = [[] for _ in procs]
        order = list(range(len(procs)))
        for turn in range(args.turns):
            for i in (order if turn % 2 == 0 else order[::-1]):
                walls[i] += _ask(procs[i], {"op": "time", "n": args.per_turn})["wall_ms"]
        profiles = [_ask(pr, {"op": "profile"}) for pr in procs]
        for pr in procs:
            pr.stdin.write(json.dumps({"op": "stop"}) + "\n")
            pr.stdin.flush()
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              check=True).stdout.strip()
        for t, w, prof in zip(args.trees, walls, profiles):
            print(json.dumps({"tree": t, "wall_ms_median": statistics.median(w),
                              "wall_ms": w, **prof, "card": card}), flush=True)
        print(card)
    finally:
        for pr in procs:
            pr.stdin.close()  # a worker still waiting for a command ends
            try:
                pr.wait(timeout=60)
            except subprocess.TimeoutExpired:
                pr.kill()
    return 0 if all(pr.returncode == 0 for pr in procs) else 1


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--worker":
        _worker(sys.argv[2])
    else:
        sys.exit(main())
