#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``mgnns_tpu_torch``) on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card::

    python3 chip_smoke.py

Phases (any failure exits non-zero, and no result line is printed):

0. the card: name and power limit, TF32 off for convolutions and matmuls
   (the port computes in full float32);
1. build every CUDA kernel (K1, K2) from ``mgnns_tpu_torch/kernels/csrc``;
   ptxas's registers, stack and spills of K1 and K2 at the model's window
   (g=4), which must use no local memory;
2. K1 against its plain PyTorch version on the card, exactly, at the model's
   shape, a small odd one, g=0 and g=16 at full width and D=33 (the scalar
   path); kernel, plain and bound times, and the time of a pass that only
   writes K1's output (the floor of a kernel of that size);
2b. K2 against its plain backward the same way, and at g=0 and g=16:
   ``d_emb`` exactly, ``d_w`` within 1e-5 of scale (its sum over D runs in
   another order), the constant-input tie case exactly; kernel and plain
   times;
3. the serving path at the full width of the fusion model: a seeded
   synthetic corpus over a 20,153-word vocabulary, its PMI graph, 80/365-class
   label graphs, ``ModelConfig()`` weights from a seed, and a
   ``Predictor(max_batch=16)`` answering requests of 1, 5, 16 and 37 records;
   the launch counts of the run, one batch's logits against the same forward
   with K1's plain version, and one record's logits against the CPU; then the
   text-only model the same way;
4. the training path at full width: ``Engine.learning`` (Adam, the default
   learning rates, train-mode BatchNorm) for 2 epochs of 64 synthetic
   records in batches of 16 from the port's loader, validation on 32 and a
   test pass, with checkpoints and result files; the launch counts of the
   run, the best checkpoint restored, one step with K1/K2 against the same
   step with their plain versions, a text-only step on the card against the
   CPU, 10 steps on one batch lowering its loss; step time, samples/s, peak
   memory and one profiled step.

It prints a ``{"kernels": [...]}`` line and, last, the ``{"ok": true, ...}``
line.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import random
import re
import statistics
import subprocess
import sys
import tempfile
import time
from unittest import mock

import numpy as np
import torch

from mgnns_tpu_torch.config import DataConfig, ModelConfig, TextGraphConfig
from mgnns_tpu_torch.data.dataset import TumblrDataset
from mgnns_tpu_torch.data.loader import DeviceLoader
from mgnns_tpu_torch.engine.metrics import confusion_init
from mgnns_tpu_torch.engine.train import Engine, cross_entropy
from mgnns_tpu_torch.graphs.cooccur import gen_A
from mgnns_tpu_torch.graphs.pmi import cal_pmi
from mgnns_tpu_torch.kernels import build, edge_max
from mgnns_tpu_torch.models.mgnns import mgnns_apply, mgnns_init
from mgnns_tpu_torch.models.text_only import text_model_apply, text_model_init
from mgnns_tpu_torch.serving import Predictor
from mgnns_tpu_torch.utils import tree_leaves, tree_map, tree_to, tree_unflatten

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and float32 non-tensor-core FLOP/s
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
VOCAB_SIZE = 20153          # ModelConfig.vocab_size
N_DOCS = 10_000
REQUEST_SIZES = (1, 5, 16, 37)
REPEATS = 3
# the mangled names of K1's (float4, bulk copy) and K2's g=4 instantiations
K1_PTXAS_NAME = "edge_max_fwd_kernelILi4ELb1E"
K2_PTXAS_NAME = "edge_max_bwd_kernelILi4E"
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
    if ngram > 0:
        emb[:, 2, :] = emb[:, 0, :]      # row 1 sees rows 0 and 2 with equal weights
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
    # the model's shape, a small odd one, the smallest and largest windows at
    # full width, and D = 33, which takes the scalar path
    for shape in ((16, 100, 300, 4), (3, 7, 5, 2), (16, 100, 300, 0), (16, 100, 300, 16),
                  (4, 20, 33, 4)):
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
    device_us = kernel_us(lambda: edge_max.window_max_aggregate(emb, w, lens, ngram),
                          "edge_max_fwd")
    # a pass that only writes K1's output; the fill is the only kernel it runs
    out = torch.empty_like(emb)
    floor_us = kernel_us(lambda: out.fill_(float("-inf")), "")
    log(f"phase 2: K1 at B={B} L={L} D={D} g={ngram}: {ms * 1e3} us per call back to back "
        f"(CUDA events), {device_us} us of kernel time per launch (profiler), plain "
        f"{plain_ms * 1e3} us, bound {bound_ms * 1e3} us ({bound_by}); store-only floor "
        f"(out.fill_, profiler) {floor_us} us; {card_line()}")
    return {"name": "edge_max_fwd (K1)", "route": "cuda",
            "source": "mgnns_tpu_torch/kernels/csrc/edge_max.cu",
            "replaces": "mgnns_tpu/kernels/edge_max.py:36",
            "launches": 0, "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


# ----------------------------------------------------------------- phase 2b


def k2_bound_ms(lens: torch.Tensor, L: int, D: int, ngram: int) -> tuple[float, str]:
    """Least time for K2 on these inputs: bytes it must move (the valid rows
    of emb, w and the incoming gradient read once, lens read, d_emb and d_w
    written) against its float32 work per valid window slot and lane: the
    forward's multiply and max again, two compares and the tie split
    (multiply, divide, twice), and a multiply-add each into d_emb and d_w."""
    ln = lens.clamp(0, L).long().cpu()
    W = 2 * ngram + 1
    rows = int(ln.sum())
    nbytes = rows * D * 4 * 2 + rows * W * 4 + ln.numel() * 4 + ln.numel() * L * (D + W) * 4
    pairs = sum(sum(1 for j in range(n) for o in range(-ngram, ngram + 1) if 0 <= j + o < n)
                for n in ln.tolist())
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 12 * pairs * D / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase2b_k2() -> dict:
    max_err = 0.0
    # the model's shape (g=4), a small odd one, and the smallest and largest
    # windows the kernel instantiates
    for shape in ((16, 100, 300, 4), (3, 7, 5, 2), (16, 100, 300, 0), (16, 100, 300, 16)):
        emb, w, lens = k1_inputs(*shape, seed=sum(shape) + 1)
        up = torch.randn(emb.shape, generator=torch.Generator(device="cuda").manual_seed(7),
                         device="cuda")
        d_emb, d_w = edge_max._backward(emb, w, lens, up, shape[3])
        torch.cuda.synchronize()
        want_e, want_w = edge_max.window_max_aggregate_backward_plain(emb, w, lens, up, shape[3])
        for name, got, want in (("d_emb", d_emb, want_e), ("d_w", d_w, want_w)):
            nan = torch.isnan(want)
            if not torch.equal(torch.isnan(got), nan):
                raise SystemExit(f"K2 {shape}: {name} NaN pattern differs from the plain backward")
            err = float((got[~nan] - want[~nan]).abs().max())
            scale = max(1.0, float(want[~nan].abs().max()))
            tol = 0.0 if name == "d_emb" else 1e-5 * scale
            if err > tol:
                raise SystemExit(f"K2 {shape}: {name} differs from the plain backward by {err} "
                                 f"(tolerance {tol})")
            max_err = max(max_err, err)
            log(f"phase 2b: K2 {shape} {name} max |diff| {err} against the plain backward "
                f"(tolerance {tol}, NaN pattern equal, {int(nan.sum())} NaN)")
    # the constant-input case of tests/test_kernels.py:78: every message ties
    emb = torch.full((2, 8, 4), 0.5, device="cuda")
    w = torch.ones(2, 8, 5, device="cuda")
    lens = torch.tensor([8, 5], dtype=torch.int32, device="cuda")
    up = torch.arange(1, 5, dtype=torch.float32, device="cuda").expand(2, 8, 4).contiguous()
    got = edge_max._backward(emb, w, lens, up, 2)
    want = edge_max.window_max_aggregate_backward_plain(emb, w, lens, up, 2)
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise SystemExit("K2: the constant-input tie case differs from the plain backward")
    log(f"phase 2b: K2 tie case exact ({len(torch.unique(want[1]))} distinct d_w values)")

    B, L, D, ngram = 16, 100, 300, 4
    emb, w, lens = k1_inputs(B, L, D, ngram, seed=1)
    up = torch.randn(emb.shape, generator=torch.Generator(device="cuda").manual_seed(8), device="cuda")
    ms = cuda_ms(lambda: edge_max._backward(emb, w, lens, up, ngram), iters=200)
    plain_ms = cuda_ms(lambda: edge_max.window_max_aggregate_backward_plain(emb, w, lens, up, ngram),
                       iters=20)
    bound_ms, bound_by = k2_bound_ms(lens, L, D, ngram)
    device_us = kernel_us(lambda: edge_max._backward(emb, w, lens, up, ngram), "edge_max_bwd")
    log(f"phase 2b: K2 at B={B} L={L} D={D} g={ngram}: {ms * 1e3} us per call back to back "
        f"(CUDA events), {device_us} us of kernel time per launch (profiler), plain "
        f"{plain_ms * 1e3} us, bound {bound_ms * 1e3} us ({bound_by}); {card_line()}")
    return {"name": "edge_max_bwd (K2)", "route": "cuda",
            "source": "mgnns_tpu_torch/kernels/csrc/edge_max.cu",
            "replaces": "mgnns_tpu/kernels/edge_max.py:91",
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


def kernel_us(fn, name: str) -> float:
    """Device time a launch of the kernel whose name contains ``name``, by
    the profiler over 50 calls of ``fn``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(50):
            fn()
        torch.cuda.synchronize()
    k = [e for e in device_kernels(prof) if name in e.key]
    return k[0].self_device_time_total / k[0].count if k else float("nan")


def ptxas_report(nvcc_log: str, kernel: str) -> str:
    """ptxas's lines (registers, stack, spills) for the kernel whose mangled
    name contains ``kernel``, from the output of ``nvcc -Xptxas -v``."""
    lines, keep = [], False
    for line in nvcc_log.splitlines():
        if "Compiling entry function" in line:
            keep = kernel in line
        if keep:
            lines.append(line.strip())
    return "\n".join(lines)


def local_memory_bytes(report: str) -> list[int]:
    """Stack frame, spill store and spill load bytes of a ``ptxas_report``."""
    m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                  report)
    if m is None:
        raise SystemExit(f"no stack/spill line in ptxas's report:\n{report}")
    return [int(x) for x in m.groups()]


def device_kernels(prof):
    """Kernel events of a profile averaged by name (the GPU side of the
    model's and the engine's named ranges is left out)."""
    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.key.startswith(("mgnns.", "engine."))]


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
    params, stats, consts = mgnns_init(
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
                     params=params, batch_stats=stats, consts=consts, cfg=cfg,
                     image_backend="synthetic",
                     max_batch=16, device="cuda")
    t0 = time.perf_counter()
    pred.warm()
    log(f"phase 3: warm() over buckets {pred.batch_buckets}: {time.perf_counter() - t0} s")

    k1["launches"] = serve(pred, texts, "fusion")["launches"]

    # one batch with K1 against the same forward with K1's plain version
    batch_np, _ = pred._encode_host([{"id": f"cmp{i}", "text": texts[i]} for i in range(16)])
    batch = {k: torch.from_numpy(v).cuda() for k, v in batch_np.items()}
    with torch.inference_mode():
        logits = mgnns_apply(pred.params, pred.batch_stats, pred.consts, batch, cfg=cfg)[0]
        with mock.patch.object(edge_max, "window_max_aggregate",
                               edge_max.window_max_aggregate_plain):
            logits_plain = mgnns_apply(pred.params, pred.batch_stats, pred.consts, batch,
                                       cfg=cfg)[0]
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
        card = mgnns_apply(pred.params, pred.batch_stats, pred.consts, one, cfg=cfg)[0].cpu()
        host = mgnns_apply(tree_to(pred.params, torch.device("cpu")),
                           tree_to(pred.batch_stats, torch.device("cpu")),
                           tree_to(pred.consts, torch.device("cpu")),
                           {k: v.cpu() for k, v in one.items()}, cfg=cfg)[0]
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
    return {"vocab": vocab, "texts": texts, "graph": graph, "cfg": cfg, "object_A": object_A,
            "place_A": place_A, "r": r}


# ------------------------------------------------------------------ phase 4

N_TRAIN, N_VAL, TRAIN_BATCH, EPOCHS = 64, 32, 16, 2


def _records(texts, n, offset, r) -> list[dict]:
    names = list(LABELS)
    return [{"id": f"t{offset + i}", "text": texts[(offset + i * 7) % len(texts)],
             "image": f"t{offset + i}.jpg", "label": names[int(r.integers(0, len(names)))]}
            for i in range(n)]


def _timed_step(engine: Engine, batch: dict) -> dict:
    """One train step split by phase on the host clock, synchronizing the
    card after each: the same forward, backward and optimizer calls as
    ``Engine.train_step``."""
    times = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    batch = engine._to_device(batch)
    leaves = tree_leaves(engine.params)
    live = [p.detach().requires_grad_(True) for p in leaves]
    gen = torch.Generator(device="cuda").manual_seed(0)
    logits, new_bs, aux = engine.apply_fn(tree_unflatten(engine.params, live), engine.batch_stats,
                                          batch, train=True, generator=gen)
    loss = cross_entropy(logits, batch["label"], batch["weight"])
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    grads = torch.autograd.grad(loss, live, allow_unused=True)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    with torch.no_grad():
        engine.opt.apply(leaves, list(grads), engine.opt_state)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    engine.batch_stats = new_bs
    times.update(forward_ms=(t1 - t0) * 1e3, backward_ms=(t2 - t1) * 1e3,
                 optimizer_ms=(t3 - t2) * 1e3)
    return times


def _loss_and_text_grads(engine: Engine, batch: dict, seed: int):
    """Loss and the text GCN's gradients of one train forward/backward at the
    engine's parameters, with dropout from ``seed``; nothing is updated."""
    batch = engine._to_device(batch)
    leaves = tree_leaves(engine.params)
    live = [p.detach().requires_grad_(True) for p in leaves]
    tree = tree_unflatten(engine.params, live)
    logits, _, aux = engine.apply_fn(tree, engine.batch_stats, batch, train=True,
                                     generator=torch.Generator(device="cuda").manual_seed(seed))
    loss = cross_entropy(logits, batch["label"], batch["weight"]) + engine.aux_loss_weight * aux
    tg = tree["text_gcn"]
    g = torch.autograd.grad(loss, [tg["node_embedding"], tg["edge_weight"]])
    return float(loss.detach()), g


def profile_train_step(engine: Engine, batch: dict) -> None:
    from torch.profiler import ProfilerActivity, profile

    cm = confusion_init(engine.num_classes, "cuda")
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.train_step(batch, cm)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall_ms = statistics.median(walls)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        engine.train_step(batch, cm)
        torch.cuda.synchronize()
    kernels = device_kernels(prof)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    log(f"phase 4: one 16-record fusion train step: wall {wall_ms} ms (median of {walls}); "
        f"device busy {busy_ms} ms over {sum(e.count for e in kernels)} kernel launches; device "
        f"idle share {1 - busy_ms / wall_ms}; {card_line()}")
    for e in prof.key_averages():
        if e.key.startswith(("mgnns.", "engine.")) and e.device_type != torch.autograd.DeviceType.CUDA:
            log(f"  range {e.key}: kernel ms {e.device_time_total / 1e3}, "
                f"host ms (profiled) {e.cpu_time_total / 1e3}")
    for e in sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:10]:
        log(f"  kernel {e.self_device_time_total / 1e3:9.3f} ms x{e.count:<5} {e.key[:100]}")
    split = [_timed_step(engine, batch) for _ in range(3)]
    log(f"phase 4: train step by phase, card synchronized after each (3 steps): "
        f"{split}; {card_line()}")


def phase4(setup: dict, k1: dict, k2: dict) -> None:
    cfg = setup["cfg"]
    vocab, graph, texts, r = setup["vocab"], setup["graph"], setup["texts"], np.random.default_rng(4)
    params, stats, consts = mgnns_init(
        cfg, num_edges=graph.num_edges,
        label_embedding=r.standard_normal((7, 300)).astype(np.float32),
        object_A=setup["object_A"], place_A=setup["place_A"],
        object_inp=r.standard_normal((80, 300)).astype(np.float32),
        place_inp=r.standard_normal((365, 300)).astype(np.float32), seed=1, device="cuda")
    workdir = tempfile.mkdtemp(prefix="mgnns_train_")
    with open(os.path.join(workdir, "label.json"), "w") as f:
        json.dump(LABELS, f)
    data_cfg = DataConfig(data_root_path=workdir, image_backend="synthetic")
    graph_cfg = TextGraphConfig()
    train_ds = TumblrDataset(data_cfg, graph_cfg, "train", vocab, graph, image_size=cfg.image_size,
                             train_transforms=True, records=_records(texts, N_TRAIN, 0, r))
    val_ds = TumblrDataset(data_cfg, graph_cfg, "val", vocab, graph, image_size=cfg.image_size,
                           records=_records(texts, N_VAL, N_TRAIN, r))

    def apply_fn(p, bs, batch, *, train, generator):
        logits, new_bs, aux = mgnns_apply(p, bs, consts, batch, cfg=cfg, train=train,
                                          generator=generator)
        return logits, new_bs, aux.get("head_diversity", 0.0)

    steps = N_TRAIN // TRAIN_BATCH
    engine = Engine(apply_fn, params, stats, num_classes=len(LABELS), optimizer_algo="adam",
                    steps_per_epoch=steps, checkpoint_dir=os.path.join(workdir, "ckpt"),
                    device="cuda")
    saved: dict = {}
    save = engine.save

    def save_and_keep(metrics=None):
        saved[engine.step] = [t.detach().cpu().clone() for t in tree_leaves(engine.params)]
        save(metrics)

    engine.save = save_and_keep
    train_loader = DeviceLoader(train_ds, TRAIN_BATCH, shuffle=True, seed=0, device="cuda")
    val_loader = DeviceLoader(val_ds, TRAIN_BATCH, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    edge_max.launches = edge_max.bwd_launches = 0
    t0 = time.perf_counter()
    result = engine.learning(
        lambda: train_loader, lambda: val_loader, lambda: val_loader, max_epochs=EPOCHS,
        result_paths={"experiment": os.path.join(workdir, "result.txt"),
                      "pred": os.path.join(workdir, "pred.txt"), "label_names": list(LABELS)},
        metrics_path=os.path.join(workdir, "metrics.jsonl"))
    torch.cuda.synchronize()
    launches, bwd_launches = edge_max.launches, edge_max.bwd_launches
    learn_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    n_val = math.ceil(N_VAL / TRAIN_BATCH)
    forwards = EPOCHS * steps + EPOCHS * n_val + n_val
    train_steps = EPOCHS * steps
    hist = result["history"]
    losses = [h["train"]["loss"] for h in hist] + [h["val"]["loss"] for h in hist]
    skipped = sum(h["train"]["skipped_steps"] for h in hist)
    log(f"phase 4: learning() {EPOCHS} epochs of {steps} steps ({N_TRAIN} records, batch "
        f"{TRAIN_BATCH}), val {N_VAL}, test pass: {learn_s} s; train loss per epoch "
        f"{[h['train']['loss'] for h in hist]}, val loss {[h['val']['loss'] for h in hist]}, "
        f"skipped steps {skipped}; train samples/s {[h['train']['samples_per_sec'] for h in hist]} "
        f"(steady {[h['train'].get('steady_samples_per_sec') for h in hist]}), eval samples/s "
        f"{[h['val'].get('steady_samples_per_sec') for h in hist]}; test {result['test']['accuracy']}; "
        f"peak device memory {peak} bytes; {card_line()}")
    log(f"phase 4: K1 launches {launches} for {forwards} forwards, K2 launches {bwd_launches} for "
        f"{train_steps} train backward passes")
    if not all(math.isfinite(v) for v in losses) or skipped:
        raise SystemExit("phase 4: a non-finite loss or a skipped step")
    if launches != forwards or bwd_launches != train_steps:
        raise SystemExit("phase 4: kernel launch counts do not match the training run")
    k1["launches"], k2["launches"] = launches, bwd_launches
    for name in ("result.txt", "pred.txt", "metrics.jsonl"):
        if not os.path.getsize(os.path.join(workdir, name)):
            raise SystemExit(f"phase 4: {name} is empty")

    # the best checkpoint, as learning() restored it before the test pass
    best = engine.checkpointer.best_step()
    if not all(torch.equal(a, b.cpu()) for a, b in zip(saved[best], tree_leaves(engine.params))):
        raise SystemExit("phase 4: the restored parameters differ from the saved ones")
    log(f"phase 4: checkpoint of step {best} (best of {sorted(saved)}) restored equal to what "
        f"was saved")

    # one step with K1/K2 against the same step with their plain versions
    batch = train_loader._assemble(np.arange(TRAIN_BATCH), None, random.Random(0))
    loss_k, grads_k = _loss_and_text_grads(engine, batch, seed=5)
    with mock.patch.object(edge_max, "_launch", edge_max.window_max_aggregate_plain), \
            mock.patch.object(edge_max, "_launch_bwd", edge_max.window_max_aggregate_backward_plain):
        loss_p, grads_p = _loss_and_text_grads(engine, batch, seed=5)
    rel = abs(loss_k - loss_p) / abs(loss_p)
    gerr = [float((a - b).abs().max()) for a, b in zip(grads_k, grads_p)]
    gtol = [1e-4 * max(1.0, float(b.abs().max())) for b in grads_p]
    log(f"phase 4: 16-record train step with K1/K2 vs plain versions: loss {loss_k} vs {loss_p} "
        f"(relative {rel}, tolerance 1e-5); text GCN gradient max |diff| node_embedding "
        f"{gerr[0]} (tolerance {gtol[0]}), edge_weight {gerr[1]} (tolerance {gtol[1]})")
    if rel > 1e-5 or gerr[0] > gtol[0] or gerr[1] > gtol[1]:
        raise SystemExit("phase 4: the step with K1/K2 disagrees with the plain versions")

    # a text-only SGD step on the card against the same step on the CPU
    results = []
    text_params = text_model_init(len(vocab), len(LABELS), graph.num_edges, seed=2, device="cpu")
    for dev in ("cuda", "cpu"):
        tp = tree_to(text_params, torch.device(dev))

        def text_apply(p, bs, b, *, train, generator):
            # dropout 0: a CUDA and a CPU generator draw different masks
            return text_model_apply(p, b, ngram=graph_cfg.ngram, dropout_rate=0.0, train=train,
                                    generator=generator), bs

        teng = Engine(text_apply, tp, {}, num_classes=len(LABELS), optimizer_algo="sgd", lr=0.05,
                      device=dev)
        tb = {k: batch[k] for k in ("ids", "lens", "eids", "label", "weight")}
        tl = float(teng.train_step(tb, confusion_init(len(LABELS), dev)))
        results.append((tl, [t.cpu() for t in tree_leaves(teng.params)]))
    (lc, pc), (lh, ph) = results
    perr = max(float((a - b).abs().max()) / max(1.0, float(b.abs().max())) for a, b in zip(pc, ph))
    log(f"phase 4: text-only train step card vs CPU: loss {lc} vs {lh}, updated parameters max "
        f"|diff| / max(1, scale) {perr} (tolerance 1e-4)")
    if abs(lc - lh) > 1e-4 * max(1.0, abs(lh)) or perr > 1e-4:
        raise SystemExit("phase 4: the text-only step on the card disagrees with the CPU")

    # 10 steps on one repeated batch lower its loss
    cm = confusion_init(len(LABELS), "cuda")
    step_ms, first = [], None
    for i in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = float(engine.train_step(batch, cm))
        step_ms.append((time.perf_counter() - t0) * 1e3)
        first = loss if first is None else first
    log(f"phase 4: 10 Adam steps (lr {engine.opt.schedule(engine.opt_state['count'])}, lrp 0.1) "
        f"on one 16-record batch: loss {first} -> {loss}; step ms (host clock, loss read each "
        f"step) {step_ms}, median after the first {statistics.median(step_ms[1:])}; {card_line()}")
    if not loss < first:
        raise SystemExit("phase 4: 10 steps on one batch did not lower its loss")

    # what the nan-guard's per-step host read of isfinite(loss) costs: steps
    # with and without it, in turns
    guard_ms: dict = {True: [], False: []}
    for guard in (True, False, False, True, True, False, False, True):
        engine.nan_guard = guard
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.train_step(batch, cm)
        torch.cuda.synchronize()
        guard_ms[guard].append((time.perf_counter() - t0) * 1e3)
    engine.nan_guard = True
    log(f"phase 4: train step ms with the nan-guard {guard_ms[True]} (median "
        f"{statistics.median(guard_ms[True])}), without {guard_ms[False]} (median "
        f"{statistics.median(guard_ms[False])}); {card_line()}")
    profile_train_step(engine, batch)

    # peak memory of one forward/backward without remat and with per-block remat
    peaks, block_losses = {}, {}
    for policy in ("none", "block"):
        bcfg = dataclasses.replace(cfg, remat_policy=policy)

        def remat_apply(p, bs, b, *, train, generator, bcfg=bcfg):
            return (*mgnns_apply(p, bs, consts, b, cfg=bcfg, train=train, generator=generator)[:2], 0.0)

        reng = Engine(remat_apply, engine.params, engine.batch_stats, num_classes=len(LABELS),
                      eval_only=True, device="cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        block_losses[policy] = _loss_and_text_grads(reng, batch, seed=5)[0]
        torch.cuda.synchronize()
        peaks[policy] = torch.cuda.max_memory_allocated()
    log(f"phase 4: one 16-record forward/backward, peak device memory without remat "
        f"{peaks['none']} bytes, with remat_policy='block' {peaks['block']} bytes; losses "
        f"{block_losses}; {card_line()}")
    if abs(block_losses["block"] - block_losses["none"]) > 1e-5 * abs(block_losses["none"]):
        raise SystemExit("phase 4: the block-remat step disagrees with the plain step")


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
    # K1's chain and K2's register rings must stay in registers at the model's
    # window (g=4); the log is the one kept beside the library, built in this
    # run or before
    for kernel, mangled in (("K1", K1_PTXAS_NAME), ("K2", K2_PTXAS_NAME)):
        report = ptxas_report(libs["edge_max"].log, mangled)
        local = local_memory_bytes(report)
        log(f"phase 1: ptxas, {kernel} at g=4: {' | '.join(report.splitlines())}")
        if any(local):
            raise SystemExit(f"phase 1: {kernel} at g=4 uses local memory (stack, spill "
                             f"stores, spill loads: {local} bytes)")

    k1 = phase2_k1()
    k2 = phase2b_k2()
    setup = phase3(k1)
    phase4(setup, k1, k2)

    log(f"total {time.perf_counter() - t_start} s")
    log(card_line())
    print(json.dumps({"kernels": [k1, k2]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
