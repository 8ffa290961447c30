#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``mgnns_tpu_torch``) on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card::

    python3 chip_smoke.py

Phases (any failure exits non-zero, and no result line is printed):

0. the card: name and power limit, TF32 off for convolutions and matmuls
   (the port's float32 serving computes in full float32);
1. build every CUDA kernel of the serving path from ``mgnns_tpu_torch/kernels/csrc``;
2. each kernel against its plain PyTorch version on the card, at the serving
   shapes and a small odd one, exactly; kernel and plain times;
3. the serving path at the full width of the fusion model: a seeded
   synthetic corpus over a 20,153-word vocabulary, its PMI graph, 80/365-class
   label graphs, ``ModelConfig()`` weights from a seed, and a
   ``Predictor(max_batch=16)`` answering requests of 1, 5, 16 and 37 records;
   the launch counts of the run, one batch's logits against the same forward
   with K1's plain version, and one record's logits against the CPU; then the
   text-only model the same way.

It prints a ``{"kernels": [...]}`` line and, last, the ``{"ok": true, ...}``
line.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import torch

from mgnns_tpu_torch.config import ModelConfig, TextGraphConfig
from mgnns_tpu_torch.graphs.cooccur import gen_A
from mgnns_tpu_torch.graphs.pmi import cal_pmi
from mgnns_tpu_torch.kernels import build, edge_max
from mgnns_tpu_torch.models.mgnns import mgnns_apply, mgnns_init
from mgnns_tpu_torch.models.text_only import text_model_init
from mgnns_tpu_torch.serving import Predictor
from mgnns_tpu_torch.utils import tree_map, tree_to

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and float32 non-tensor-core FLOP/s
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
VOCAB_SIZE = 20153          # ModelConfig.vocab_size
N_DOCS = 10_000
REQUEST_SIZES = (1, 5, 16, 37)
REPEATS = 3
LABELS = {name: i for i, name in enumerate(
    ["angry", "bored", "calm", "fear", "happy", "love", "sad"])}


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def cuda_ms(fn, iters: int, reps: int = 5) -> float:
    """Median over ``reps`` of the mean time of ``iters`` back-to-back calls,
    by CUDA events, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


# ------------------------------------------------------------------ phase 2


def k1_inputs(B, L, D, ngram, seed):
    """Lens 0, 1 and L; negative and zero weights; exact ties (a repeated
    source row with equal weights); one NaN message."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    W = 2 * ngram + 1
    emb = torch.randn(B, L, D, generator=g, device="cuda")
    w = torch.randn(B, L, W, generator=g, device="cuda")
    lens = torch.randint(0, L + 1, (B,), generator=g, device="cuda", dtype=torch.int32)
    lens[0], lens[1], lens[-1] = 0, 1, L
    w[:, ::3, 0] = 0.0
    emb[:, 2, :] = emb[:, 0, :]          # row 1 sees rows 0 and 2 with equal weights
    w[:, 1, ngram - 1] = w[:, 1, ngram + 1]
    emb[-1, L // 2, D // 2] = float("nan")
    return emb, w, lens


def k1_bound_ms(lens: torch.Tensor, L: int, D: int, ngram: int) -> tuple[float, str]:
    """Least time for K1 on these inputs: bytes it must move (the valid rows
    of emb and w read once, lens read, out written) against the float32
    multiply+max of each valid window slot."""
    ln = lens.clamp(0, L).long().cpu()
    W = 2 * ngram + 1
    nbytes = int(ln.sum()) * D * 4 + int(ln.sum()) * W * 4 + ln.numel() * 4 + ln.numel() * L * D * 4
    pairs = sum(sum(1 for j in range(n) for o in range(-ngram, ngram + 1) if 0 <= j + o < n)
                for n in ln.tolist())
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * pairs * D / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase2_k1() -> dict:
    max_err = 0.0
    for shape in ((16, 100, 300, 4), (3, 7, 5, 2)):
        emb, w, lens = k1_inputs(*shape, seed=sum(shape))
        got = edge_max.window_max_aggregate(emb, w, lens, shape[3])
        torch.cuda.synchronize()
        want = edge_max.window_max_aggregate_plain(emb, w, lens, shape[3])
        nan = torch.isnan(want)
        if not torch.equal(torch.isnan(got), nan) or not nan.any():
            raise SystemExit(f"K1 {shape}: NaN pattern differs from the plain version")
        if not torch.equal(got[~nan], want[~nan]):
            bad = (got != want) & ~nan
            raise SystemExit(f"K1 {shape}: {int(bad.sum())} elements differ from the plain version")
        fin = torch.isfinite(want)
        max_err = max(max_err, float((got[fin] - want[fin]).abs().max()))
        log(f"phase 2: K1 {shape} equals its plain version exactly "
            f"(lens {sorted(lens.tolist())[:3]}..., NaN and -inf rows included)")
    B, L, D, ngram = 16, 100, 300, 4
    emb, w, lens = k1_inputs(B, L, D, ngram, seed=1)
    ms = cuda_ms(lambda: edge_max.window_max_aggregate(emb, w, lens, ngram), iters=200)
    plain_ms = cuda_ms(lambda: edge_max.window_max_aggregate_plain(emb, w, lens, ngram), iters=50)
    bound_ms, bound_by = k1_bound_ms(lens, L, D, ngram)
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(50):
            edge_max.window_max_aggregate(emb, w, lens, ngram)
        torch.cuda.synchronize()
    k = [e for e in device_kernels(prof) if "edge_max" in e.key]
    device_us = k[0].self_device_time_total / k[0].count if k else float("nan")
    log(f"phase 2: K1 at B={B} L={L} D={D} g={ngram}: {ms * 1e3} us per call back to back "
        f"(CUDA events), {device_us} us of kernel time per launch (profiler), plain "
        f"{plain_ms * 1e3} us, bound {bound_ms * 1e3} us ({bound_by}); {card_line()}")
    return {"name": "edge_max_fwd (K1)", "route": "cuda",
            "source": "mgnns_tpu_torch/kernels/csrc/edge_max.cu",
            "replaces": "mgnns_tpu/kernels/edge_max.py:36",
            "launches": 0, "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


# ------------------------------------------------------------------ phase 3


def synthetic_corpus(seed: int = 0):
    """10k documents of 5-90 tokens, Zipf-like over the 20,151 non-special
    words of a 20,153-word vocabulary (PAD, UNK first)."""
    r = np.random.default_rng(seed)
    vocab = ["PAD", "UNK"] + [f"w{i}" for i in range(VOCAB_SIZE - 2)]
    p = 1.0 / np.arange(1, VOCAB_SIZE - 1) ** 1.1
    lens = r.integers(5, 91, N_DOCS)
    toks = r.choice(VOCAB_SIZE - 2, size=int(lens.sum()), p=p / p.sum())
    words = np.array(vocab[2:])[toks]
    cuts = np.cumsum(lens)[:-1]
    return vocab, [" ".join(d) for d in np.split(words, cuts)]


def cooccurrence(C: int, r) -> dict:
    return {"nums": r.integers(1, 200, C).astype(float),
            "adj": r.integers(0, 60, (C, C)).astype(float)}


def serve(pred: Predictor, texts: list[str], label: str) -> dict:
    """Answer each request size REPEATS times with the launch count reset
    just before and read just after; returns latencies and counts."""
    lat = {n: [] for n in REQUEST_SIZES}
    forwards = 0
    torch.cuda.reset_peak_memory_stats()
    edge_max.launches = 0
    for rep in range(REPEATS):
        for n in REQUEST_SIZES:
            recs = [{"id": f"req{rep}-{n}-{i}", "text": texts[(rep * 97 + n * 13 + i) % len(texts)]}
                    for i in range(n)]
            t0 = time.perf_counter()
            out = pred.predict(recs)
            lat[n].append((time.perf_counter() - t0) * 1e3)
            forwards += math.ceil(n / pred.max_batch)
            probs = np.array([list(o["probs"].values()) for o in out])
            if len(out) != n or probs.shape != (n, len(LABELS)) or not np.isfinite(probs).all():
                raise SystemExit(f"{label}: bad answer for a {n}-record request")
            if np.abs(probs.sum(1) - 1).max() > 1e-5:
                raise SystemExit(f"{label}: probabilities do not sum to 1")
    launches = edge_max.launches
    peak = torch.cuda.max_memory_allocated()
    if launches != forwards:
        raise SystemExit(f"{label}: K1 launched {launches} times for {forwards} forwards")
    for n in REQUEST_SIZES:
        log(f"phase 3: {label} {n}-record request latency ms {lat[n]} "
            f"(median {statistics.median(lat[n])})")
    log(f"phase 3: {label} K1 launches {launches} for {forwards} forwards; "
        f"peak device memory {peak} bytes; last chunk stages {pred.last_timings}; {card_line()}")
    return {"launches": launches, "forwards": forwards}


def device_kernels(prof):
    """Kernel events of a profile averaged by name (the GPU side of the
    model's named ranges is left out)."""
    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and not e.key.startswith("mgnns.")]


def profile_forward(pred: Predictor, batch_np: dict) -> None:
    """Where one 16-record forward spends its time: host wall time without
    the profiler, then device time by stage and by kernel with it."""
    from torch.profiler import ProfilerActivity, profile

    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        pred._forward(batch_np)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall_ms = statistics.median(walls)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        pred._forward(batch_np)
        torch.cuda.synchronize()
    kernels = device_kernels(prof)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    log(f"phase 3: 16-record forward: wall {wall_ms} ms (median of {walls}); device busy "
        f"{busy_ms} ms over {sum(e.count for e in kernels)} kernel launches; device idle "
        f"share {1 - busy_ms / wall_ms}")
    stages: dict = {}
    for e in prof.key_averages():
        if e.key.startswith("mgnns."):
            st = stages.setdefault(e.key, {})
            if e.device_type == torch.autograd.DeviceType.CUDA:
                st["device_span_ms"] = e.device_time_total / 1e3
            else:
                st["kernel_ms"] = e.device_time_total / 1e3
                st["host_ms_profiled"] = e.cpu_time_total / 1e3
    for name, st in stages.items():
        log(f"  stage {name}: {st}")
    for e in sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:10]:
        log(f"  kernel {e.self_device_time_total / 1e3:9.3f} ms x{e.count:<5} {e.key[:100]}")


def phase3(k1: dict) -> None:
    t0 = time.perf_counter()
    vocab, texts = synthetic_corpus()
    graph = cal_pmi(texts, vocab, window_size=6, min_cooccurrence=2)
    log(f"phase 3: corpus {len(texts)} docs, vocab {len(vocab)}, PMI edges "
        f"{graph.num_edges} ({time.perf_counter() - t0} s on the host)")
    r = np.random.default_rng(1)
    cfg = ModelConfig(edges_num=graph.num_edges)
    object_A, _ = gen_A(80, cfg.object_t, cooccurrence(80, r), cfg.gama)
    place_A, _ = gen_A(365, cfg.place_t, cooccurrence(365, r), cfg.gama)
    t0 = time.perf_counter()
    params, consts = mgnns_init(
        cfg, num_edges=graph.num_edges,
        label_embedding=r.standard_normal((7, 300)).astype(np.float32),
        object_A=object_A, place_A=place_A,
        object_inp=r.standard_normal((80, 300)).astype(np.float32),
        place_inp=r.standard_normal((365, 300)).astype(np.float32),
        seed=0, device="cuda")
    numels: list[int] = []
    tree_map(lambda t: numels.append(t.numel()), params)
    n_params = sum(numels)
    log(f"phase 3: fusion model initialized, {n_params} parameters "
        f"({time.perf_counter() - t0} s)")
    graph_cfg = TextGraphConfig()
    pred = Predictor(vocab=vocab, graph=graph, graph_cfg=graph_cfg, label_map=LABELS,
                     params=params, consts=consts, cfg=cfg, image_backend="synthetic",
                     max_batch=16, device="cuda")
    t0 = time.perf_counter()
    pred.warm()
    log(f"phase 3: warm() over buckets {pred.batch_buckets}: {time.perf_counter() - t0} s")

    k1["launches"] = serve(pred, texts, "fusion")["launches"]

    # one batch with K1 against the same forward with K1's plain version
    batch_np, _ = pred._encode_host([{"id": f"cmp{i}", "text": texts[i]} for i in range(16)])
    batch = {k: torch.from_numpy(v).cuda() for k, v in batch_np.items()}
    with torch.inference_mode():
        logits = mgnns_apply(pred.params, pred.consts, batch, cfg=cfg)
        with mock.patch.object(edge_max, "window_max_aggregate",
                               edge_max.window_max_aggregate_plain):
            logits_plain = mgnns_apply(pred.params, pred.consts, batch, cfg=cfg)
    scale = float(logits.abs().max())
    diff = float((logits - logits_plain).abs().max())
    # K1 equals its plain version exactly, so a difference can only come from
    # run-to-run summation order in the library kernels around it
    tol = 1e-5 * max(1.0, scale)
    log(f"phase 3: 16-record logits with K1 vs plain K1: max |diff| {diff} "
        f"(tolerance {tol}, logits scale {scale})")
    if not (logits.shape == (16, 7) and torch.isfinite(logits).all() and diff <= tol):
        raise SystemExit("phase 3: logits with K1 disagree with the plain version")

    # one record on the card against the same forward on the CPU
    one = {k: v[:1] for k, v in batch.items()}
    with torch.inference_mode():
        card = mgnns_apply(pred.params, pred.consts, one, cfg=cfg).cpu()
        host = mgnns_apply(tree_to(pred.params, torch.device("cpu")),
                           tree_to(pred.consts, torch.device("cpu")),
                           {k: v.cpu() for k, v in one.items()}, cfg=cfg)
    diff = float((card - host).abs().max())
    tol = 1e-3 * max(1.0, float(host.abs().max()))  # two full-depth trunks, sums in another order
    log(f"phase 3: 1-record logits card vs CPU: max |diff| {diff} (tolerance {tol})")
    if diff > tol:
        raise SystemExit("phase 3: card and CPU forwards disagree")

    profile_forward(pred, batch_np)
    pred.close()

    # the text-only model through the same Predictor
    text_params = text_model_init(len(vocab), len(LABELS), graph.num_edges, seed=0, device="cuda")
    tpred = Predictor(vocab=vocab, graph=graph, graph_cfg=graph_cfg, label_map=LABELS,
                      params=text_params, max_batch=16, text_only=True, device="cuda")
    tpred.warm()
    serve(tpred, texts, "text-only")
    tpred.close()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this test needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    name = torch.cuda.get_device_name(0)
    log(f"phase 0: {card_line()}; torch {torch.__version__} CUDA {torch.version.cuda}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log(f"phase 0: torch.backends.cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
        f"torch.backends.cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")

    t0 = time.perf_counter()
    libs = build.build_all()
    log(f"phase 1: built {sorted(libs)} in {time.perf_counter() - t0} s")
    for lib in libs.values():
        log(lib.log.strip())

    k1 = phase2_k1()
    phase3(k1)

    log(f"total {time.perf_counter() - t_start} s")
    log(card_line())
    print(json.dumps({"kernels": [k1]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
