#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``mgnns_tpu_torch``) on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card::

    python3 chip_smoke.py

Phases (any failure exits non-zero, and no result line is printed):

0. the card: name and power limit, torch's global TF32 flags as found (left
   as they are) and the conv precision the package pins for its float32
   trunk convolutions;
1. build every CUDA kernel (K1, K2, the BiLSTM's two, the optimizer's)
   from ``mgnns_tpu_torch/kernels/csrc``; ptxas's registers, stack and
   spills of K1 and K2 at the model's window (g=4), of the BiLSTM's kernels
   and of ``adam.cu``'s, which must use no local memory;
2. K1 against its plain PyTorch version on the card, exactly, at the model's
   shape, a small odd one, g=0 and g=16 at full width and D=33 (the scalar
   path), the benchmark's and the eval ladder's batches (32 to 512) and the dry
   run's (1 and 2 rows of L=16); kernel, plain and bound times, and the time
   of a pass that only writes K1's output (the floor of a kernel of that
   size);
2b. K2 against its plain backward the same way, at g=0 and g=16 and at the
   dry run's shapes:
   ``d_emb`` exactly, ``d_w`` within 1e-5 of scale (its sum over D runs in
   another order), the constant-input tie case exactly; kernel and plain
   times;
2c. the BiLSTM's forward and backward kernels (``kernels/lstm.py``) against
   the plain step loop and reverse recurrence on the card, one layer of the
   model's widths (H=150) at the train and eval batches (16, 128) with the
   benchmark's 5-90-token lengths and with 0, 1 and L: the outputs within
   1e-5, dgates within 1e-4 of scale; kernel (profiler), plain, cuDNN's
   unmasked bidirectional layer (the yardstick) and bound times;
2d. the optimizer's kernels (``kernels/adam.py``) against the plain chain
   (``torch._foreach_*`` and ``torch.where``) on the card, one Adam step
   from the same state over the fusion model's trained leaf set at full
   width (its trunk conv gradients channels_last, as the bf16 convs give
   them), over 256 M elements in 8 leaves and over the moonlight cell's 960
   trained leaves (its encoder at small widths: two update launches), with
   moments that cancel nothing: moments within 1e-6 of the larger of the
   plain chain's value and the step's start, each parameter's step within
   1e-6 of the plain chain's plus a unit in the last place; the guarded copy byte-equal to
   ``torch.where`` on the fusion model's BN running statistics, ``ok`` true
   and false; the chain's time, its kernels' (profiler), the bound (bytes
   over 3.35 TB/s) and the plain chain's, the launches and
   ``adam.grad_copies``;
3. the serving path at the full width of the fusion model: a seeded
   synthetic corpus over a 20,153-word vocabulary, its PMI graph, 80/365-class
   label graphs, ``ModelConfig()`` weights from a seed, and a
   ``Predictor(max_batch=16)`` answering requests of 1, 5, 16 and 37 records;
   the launch counts of the run, one batch's logits against the same forward
   with K1's plain version, and one record's logits against the CPU under the
   package's default (within 1e-5 of scale), then the same with the
   precision pin removed and TF32 allowed, which must differ more; the
   native host preprocessing (``mgnns_tpu_torch.native``, built from
   ``mgnns_tpu_torch/csrc/host_preproc.cpp``) against its numpy paths on the
   corpus, equal array for array (pair counts, ``cal_pmi``'s graph, window
   edge ids of a request and of the corpus), with host times; the trunk
   gradients of a 1-record train step (running-statistics BatchNorm, dropout
   0) on the card against the CPU the same two ways (Frobenius-relative
   5e-3, and TF32 further); then the text-only model as the fusion model;
4. the training path at full width: ``Engine.learning`` (Adam, the default
   learning rates, train-mode BatchNorm) for 2 epochs of 64 synthetic
   records in batches of 16 from the port's loader, validation on 32 and a
   test pass, with checkpoints and result files; the launch counts of the
   run, the best checkpoint restored, one step with K1/K2 against the same
   step with their plain versions, a text-only step on the card against the
   CPU, 10 steps on one batch lowering its loss; step time, samples/s, peak
   memory and one profiled step;
4b. bf16 trunks at full width on phase 4's weights and batch: the logits'
   drift from float32 (within the JAX package's bf16 bound, 4e-2 of scale,
   and on one record within twice the CPU's drift), one bf16
   step's loss and gradients (finite, trunk gradients non-zero, master
   parameters float32), step ms of bf16 and float32 in turns, the peak
   memory of each, and the kernel ms of the two trunk ranges;
5. the training CLI on the card: a data tree built here (annotations, GloVe
   pickles, adjacency pickles and a vocabulary by ``mgnns_tpu_torch.cli.
   prepare``); ``mgnns_tpu_torch.cli.main`` trains the text-only model to
   above 0.8 validation and test accuracy, and the full-width fusion model
   at bf16 for one epoch, with K1 launched once per forward and K2 once per
   train step, and the result, metrics and preprocessing files written;
6. serving what phase 5 wrote, on the card: ``Predictor.from_engine_artifacts``
   of the text-only and the fusion checkpoint (float32) answers a 37-record
   request with K1 once per forward, the fusion answer held against K1's
   plain version; ``mgnns_tpu_torch.cli.predict`` on the same records equals
   it; a full-width fusion model with its dead modules exported as a
   reference ``.pth.tar`` wrapper serves bit-equal probabilities through
   ``reference_ckpt``, and ``cli.main --init_from_reference`` trains from it
   (K1 and K2 counted); ``BatchingFrontend`` under 8 clients x 4 requests
   equals direct ``predict``; ``cli.serve.make_server`` answers ``/healthz``,
   ``/predict`` and a 404 over loopback;
7. export on the card: phase 5's float32 fusion and text-only checkpoints
   served as in phase 6, each written by ``mgnns_tpu_torch.export.
   export_predictor`` and loaded again by ``load_exported``: a 37-record
   request within 1e-5 of the live ``Predictor`` with K1 once per forward of
   the exported program; the 16-record forward of the live and the exported
   fusion model timed in turns and profiled once each (device busy, kernel
   launches, host ops by self time); ``cli.predict --from_exported`` of the
   text-only artifact in a fresh process within 1e-5; a text-only model
   exported on the CPU and served on the card (K1 counted); ``cli.serve
   --from_exported`` of the fusion artifact over loopback;
8. device-resident training through captured steps: the full-width fusion
   model (phase 3's vocabulary and label graphs, dropout 0.5, Adam, batch
   16) trains 64 records from device tables (``DeviceLoader(device_text=
   True, device_images=True)``), float32 and then bf16 trunks, so that each
   epoch runs as CUDA-graph replays of the whole train step
   (``mgnns_tpu_torch.engine.graphs``), and the same model from the same
   weights trains on the loop path beside it: one epoch of 4 steps each,
   whose per-step losses and parameters must agree within 1e-6 of scale,
   and 32 records of eval through a captured eval step, whose predictions
   must be equal; the same epoch again under the library defaults must be
   bit-equal (the trunk convs' pin sets cuDNN's deterministic algorithms,
   fault 3.4; the ``deterministic_cudnn()`` epoch stays as a second
   witness); then the paths in turns (loop, graph, mesh, mesh, graph, loop)
   for the per-step wall time, one profiled epoch of each captured path for
   the device busy time, idle share, launches, NCCL kernels, and K1 and K2
   once per replay; capture seconds and peak memory; last
   ``cli.main --device_text --device_images --cache_eval_batches
   --profile_dir`` on phase 5's tree for 2 epochs at bf16, which must print
   its budget line, run every epoch through captured steps and leave a
   trace with K1 and K2 events;
9. data-parallel training (``mgnns_tpu_torch.parallel``):
   9a. two ranks sharing the card over gloo (NCCL refuses two ranks on one
   device), started as ``torchrun`` would start them (this script with
   ``--phase9-rank``): the full-width fusion model at float32, 64 train
   and 32 val records in device tables split by each rank's input plan,
   global batch 16, dropout 0.5, Adam, 4 train steps and an eval epoch;
   per step the wall time, the bytes and number of all-reduces and each
   rank's peak memory; K1 and K2 once per rank per forward and backward;
   held to the 1-rank run of the same global batches on this card: losses
   within 1e-5 relative, parameters and BN statistics within 1e-4 of each
   leaf's scale (floored at 1e-3 of the largest leaf's), eval predictions
   equal; with two cards or more, the same 2 ranks over NCCL;
   9b. (inside phase 8) a process group of one rank over NCCL: the mesh
   engine's captured train and eval steps, float32 and bf16, held to phase
   8's captured step from the same state within 1e-6 of scale;
   9c. ``python -m torch.distributed.run --nproc_per_node 1 -m
   mgnns_tpu_torch.cli.main --multihost --mesh_data 1`` with phase 8's CLI
   flags, whose prediction file must equal phase 8's non-distributed run's
   (with two cards or more, 2 ranks over NCCL too, whose file must hold
   every record);
10. the model axis (``mgnns_tpu_torch.parallel.sharding``): two ranks
   sharing the card over gloo (this script with ``--phase10-rank``) on a
   ``(data 1, model 2)`` mesh, each holding its shards of the sharded
   leaves, run phase 9a's global batches (4 train steps, the eval batches)
   and are held to phase 9a's own 1-rank run: losses within 1e-5
   relative, parameters and BN statistics within 9a's bound, eval
   predictions equal, the replicated leaves bit-equal across the ranks;
   per step the wall time, the model axis's all-reduces and bytes beside
   the other ones, each rank's peak memory and its K1 and K2 launches;
   the checkpoint's whole leaves of the 1-rank run's shapes and the
   tables' padding rows zero; then a 16-record ``Predictor(mesh=...)``
   forward of the trained weights against one device's (labels equal,
   probabilities within 1e-5); then ``cli.serve``'s HTTP server and frontend
   on rank 0 over loopback, handing each chunk to rank 1
   (``serving.MeshLink``), under 8 clients x 2 requests: answers against the
   ranks' in-process mesh ``predict`` and one device's (labels equal,
   probabilities within 1e-5), K1 once a chunk on each rank, and both ranks
   stopped by ``shutdown()``.  NCCL refuses two ranks on one card, so the
   model axis at N > 1 runs over gloo only here;
12. the entry surface (``mgnns_tpu_torch.entry``, the counterpart of
   ``__graft_entry__.py``) and the last measuring tools: ``entry()``'s
   flagship forward on cuda:0 (448 px, L=100, bf16 trunks, B=2), finite
   ``[2, 7]`` logits within 1e-5 of scale of the same forward with K1's
   plain version and K1 launched once; ``dryrun_multichip(2)``, 2 gloo
   ranks sharing cuda:0 (geometries (2, 1) and (1, 2): each sharded SGD
   step against one device from the same state, the eval epoch from device
   tables, the sharded checkpoint's round trip, the bf16 forward and step),
   K1 and K2 launched on each rank; then ``tools.warmup_breakdown``,
   ``tools.full_split_fused_eval`` and ``tools.eval_batch_ladder`` (B 32
   and 64) on 64 synthetic records, each printing its JSON line with
   positive rates, the full split's epochs fused.

It prints a ``{"kernels": [...]}`` line and, last, the ``{"ok": true, ...}``
line.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import io
import json
import math
import os
import random
import re
import socket
import statistics
import subprocess
import sys
import tempfile
import time
import types
from unittest import mock

import numpy as np
import torch

from mgnns_tpu_torch import tracing
from mgnns_tpu_torch.config import DataConfig, ModelConfig, MoeEncoderConfig, TextGraphConfig
from mgnns_tpu_torch.data.dataset import TumblrDataset
from mgnns_tpu_torch.data.loader import DeviceLoader
from mgnns_tpu_torch.engine.metrics import confusion_init
from mgnns_tpu_torch.engine.optim import Optimizer
from mgnns_tpu_torch.engine.train import Engine, cross_entropy
from mgnns_tpu_torch.graphs.pmi import cal_pmi
from mgnns_tpu_torch.kernels import build, edge_max
from mgnns_tpu_torch.kernels import lstm as lstm_kernel
from mgnns_tpu_torch.models.mgnns import mgnns_apply, mgnns_init
from mgnns_tpu_torch.models.text_only import text_model_apply, text_model_init
from mgnns_tpu_torch.nn import resnet
from mgnns_tpu_torch.serving import Predictor
from mgnns_tpu_torch.tools._bench_util import (
    cli_tree, device_events, device_kernels, flagship_data, fusion_apply_fn,
)
from mgnns_tpu_torch.utils import tree_leaves, tree_map, tree_paths, tree_to, tree_unflatten

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and float32 non-tensor-core FLOP/s
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
REQUEST_SIZES = (1, 5, 16, 37)
REPEATS = 3
# the mangled names of K1's (float4, bulk copy) and K2's g=4 instantiations
K1_PTXAS_NAME = "edge_max_fwd_kernelILi4ELb1E"
K2_PTXAS_NAME = "edge_max_bwd_kernelILi4E"
LABELS = {name: i for i, name in enumerate(
    ["angry", "bored", "calm", "fear", "happy", "love", "sad"])}


def log(*a):
    print(*a, flush=True)


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


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
    for row, n in ((0, 0), (1, 1), (B - 1, L)):  # a batch of 1 keeps only the full row
        if row < B:
            lens[row] = n
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
    # full width, D = 33, which takes the scalar path, the batches the
    # benchmark and the eval ladder launch it at (phase 12's 32 and 64, the
    # eval cell's 128, the ladder's 256 and 512), and the dry run's
    # (phase 12: a data-axis rank's 1 row and the whole batch of 2, L = 16)
    for shape in ((16, 100, 300, 4), (3, 7, 5, 2), (16, 100, 300, 0), (16, 100, 300, 16),
                  (4, 20, 33, 4), (32, 100, 300, 4), (64, 100, 300, 4), (128, 100, 300, 4),
                  (256, 100, 300, 4), (512, 100, 300, 4), (1, 16, 300, 4), (2, 16, 300, 4)):
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
    # the model's shape (g=4), a small odd one, the smallest and largest
    # windows the kernel instantiates, and the dry run's (phase 12: a
    # data-axis rank's 1 row and the whole batch of 2, L = 16)
    for shape in ((16, 100, 300, 4), (3, 7, 5, 2), (16, 100, 300, 0), (16, 100, 300, 16),
                  (1, 16, 300, 4), (2, 16, 300, 4)):
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


# ----------------------------------------------------------------- phase 2c


def lstm_bound_ms(lens: torch.Tensor, L: int, H: int, backward: bool) -> tuple[float, str]:
    """Least time for one BiLSTM layer's kernel on these inputs: the bytes
    it must move against the float32 product of each valid step, row and
    direction with w_hh (2 * H * 4H operations; the cell's few are left
    out).  The forward reads xw at valid steps and w_hh, and writes out and
    the saved gates and cells of every step and the final states; the
    backward reads the gates, cells and output gradient at valid steps and
    w_hh, and writes dgates."""
    valid = int(lens.clamp(0, L).long().sum()) * 2
    B = lens.numel()
    if backward:
        nbytes = (valid * (4 * H + H + H) + 2 * H * 4 * H + B * L * 2 * 4 * H) * 4
    else:
        nbytes = (valid * 4 * H + 2 * H * 4 * H + B * L * 2 * (H + 4 * H + H) + 4 * B * H) * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = valid * 2 * H * 4 * H / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase2c_lstm() -> dict:
    from mgnns_tpu_torch.nn import lstm

    H = 150
    g = torch.Generator(device="cuda").manual_seed(2)
    w_hh = torch.randn(2, H, 4 * H, generator=g, device="cuda") / H ** 0.5
    b_hh = torch.randn(2, 4 * H, generator=g, device="cuda") / H ** 0.5
    out = {}
    for B in (16, 128):
        L = 100
        xw = torch.randn(2, B, L, 4 * H, generator=g, device="cuda")
        up = torch.randn(B, L, 2 * H, generator=g, device="cuda")
        for edge in (True, False):  # the 5-90 lens last: the timed ones
            lens = torch.randint(5, 91, (B,), generator=g, device="cuda", dtype=torch.int32)
            if edge:
                lens[:3] = torch.tensor([0, 1, L], dtype=torch.int32)
            got = torch.ops.mgnns.lstm_forward(xw, w_hh, b_hh, lens, True)
            dgot = torch.ops.mgnns.lstm_backward(got[3], got[4], w_hh, lens, up, None, None)
            want = lstm.lstm_layer_plain(xw, w_hh, b_hh, lens, True)
            dwant = lstm.lstm_layer_backward_plain(want[3], want[4], w_hh, lens, up, None, None)
            torch.cuda.synchronize()
            err = max(float((a - b).abs().max()) for a, b in zip(got, want))
            derr = float((dgot - dwant).abs().max()) / float(dwant.abs().max())
            if not err <= 1e-5 or not derr <= 1e-4:
                raise SystemExit(f"LSTM B={B} lens {'0/1/L' if edge else '5-90'}: forward "
                                 f"{err}, backward {derr} of scale from the plain versions")
            log(f"phase 2c: LSTM layer B={B} L={L} H={H}, lens {'with 0, 1, L' if edge else '5-90'}"
                f": outputs, gates and cells within {err} of the plain loop, dgates within "
                f"{derr} of scale of the plain reverse recurrence")
        fwd_us = kernel_us(lambda: torch.ops.mgnns.lstm_forward(xw, w_hh, b_hh, lens, True),
                           "mgnns_lstm_fwd_kernel")
        fwd_eval_us = kernel_us(lambda: torch.ops.mgnns.lstm_forward(xw, w_hh, b_hh, lens, False),
                                "mgnns_lstm_fwd_kernel")
        saved = torch.ops.mgnns.lstm_forward(xw, w_hh, b_hh, lens, True)
        bwd_us = kernel_us(lambda: torch.ops.mgnns.lstm_backward(saved[3], saved[4], w_hh, lens,
                                                                  up, None, None),
                           "mgnns_lstm_bwd_kernel")
        plain_ms = cuda_ms(lambda: lstm.lstm_layer_plain(xw, w_hh, b_hh, lens, False), iters=3)
        plain_bwd_ms = cuda_ms(lambda: lstm.lstm_layer_backward_plain(
            saved[3], saved[4], w_hh, lens, up, None, None), iters=3)
        # the yardstick: cuDNN's bidirectional layer over the whole L, unmasked
        ref = torch.nn.LSTM(2 * H, H, batch_first=True, bidirectional=True).cuda()
        x = torch.randn(B, L, 2 * H, generator=g, device="cuda")
        with torch.no_grad():
            library_ms = cuda_ms(lambda: ref(x), iters=20)
        bound_ms, bound_by = lstm_bound_ms(lens, L, H, backward=False)
        bwd_bound_ms, bwd_bound_by = lstm_bound_ms(lens, L, H, backward=True)
        p = lstm_kernel.plan(H, B, 2, torch.cuda.get_device_properties(0).multi_processor_count)
        log(f"phase 2c: LSTM layer B={B} L={L} H={H} (lens 5-90, max {int(lens.max())}; plan "
            f"{p}): forward kernel {fwd_us} us a launch saving gates, {fwd_eval_us} us not "
            f"(profiler), plain loop {plain_ms * 1e3} us, bound {bound_ms * 1e3} us "
            f"({bound_by}), cuDNN's unmasked layer {library_ms * 1e3} us; backward kernel "
            f"{bwd_us} us, plain {plain_bwd_ms * 1e3} us, bound {bwd_bound_ms * 1e3} us "
            f"({bwd_bound_by}); {card_line()}")
        out[B] = {"fwd_us": fwd_us, "fwd_eval_us": fwd_eval_us, "bwd_us": bwd_us,
                  "plain_ms": plain_ms, "plain_bwd_ms": plain_bwd_ms,
                  "library_ms": library_ms, "bound_ms": bound_ms, "bwd_bound_ms": bwd_bound_ms}
    return out


# ----------------------------------------------------------------- phase 2d

P2D_EDGES = 321_876  # the benchmark's PMI edge table (321,875 edges and id 0)
P2D_BIG = (8, 32 << 20)  # leaves x elements of the 256 M-element set
# Moonlight-16B-A3B's encoder stack (27 layers, the first dense, 8 of 64
# routed experts held) at small widths, in the fusion model: the moonlight
# cell's leaf list, 960 trained leaves, so its update takes two launches
# (MAX_UPDATE_LEAVES) and its chunk size is the cell's, at 85 M elements
P2D_MOE = MoeEncoderConfig(hidden_size=64, num_heads=2, kv_lora_rank=16, qk_nope_head_dim=8,
                           qk_rope_head_dim=8, v_head_dim=8, intermediate_size=64,
                           moe_intermediate_size=16, vocab_rows=64)
P2D_LR = 1e-3  # steps far above a unit in the last place of the parameters


def adam_bound_ms(n_grad: int, n_trained: int) -> float:
    """Least time of one step of the chain: read every gradient for the
    norm (4 B an element), read p, g, m, v and write p, m, v of every
    trained element (28 B), at 3.35 TB/s."""
    return (4 * n_grad + 28 * n_trained) / HBM_BYTES_PER_S * 1e3


def _ulp(t: torch.Tensor) -> torch.Tensor:
    """The spacing of float32 values at ``|t|``, in float64."""
    a = t.abs()
    return (torch.nextafter(a, torch.full_like(a, math.inf)) - a).double()


def _worst(triples, bound) -> float:
    """The largest ``|a - b| / bound(a, b, before)`` over float32 ``(a, b,
    before)``, in float64."""
    worst = 0.0
    for a, b, before in triples:
        if a.numel():
            err = (a.double() - b.double()).abs() / bound(a, b, before)
            worst = max(worst, float(err.max()))
    return worst


def adam_against_plain(tree: dict, g: torch.Generator) -> dict:
    """One Adam step of the kernels (``_kernel_chain``) and of the plain
    chain (``_plain_chain``: ``torch._foreach_*`` and ``torch.where``) on
    the card from the same state: the parameters, gradients of 1e-2 (the
    trunk convs' channels_last, as the bf16 convs give them) and moments
    whose m has each gradient's sign, so that no sum of the chain cancels.
    The worst of each check over its bound: the moments within 1e-6 of the
    larger of the plain chain's value and the step's start, and each
    parameter's step within 1e-6 of the plain chain's step plus one unit in
    the last place of the larger parameter (each chain rounds ``p + step``;
    a bound on the parameters' own size would be blind to the step where
    ``|p|`` is large, and too tight where ``p + step`` cancels)."""
    from mgnns_tpu_torch.kernels import adam

    opt = Optimizer(tree, lr=P2D_LR, lrp=0.1, weight_decay=1e-5, grad_clip=10.0)
    leaves = tree_leaves(tree)
    grads = [(torch.randn(t.shape, generator=g, device="cuda") * 1e-2).contiguous(
        memory_format=torch.channels_last if t.dim() == 4 and t.shape[2] > 1 else
        torch.contiguous_format) for t in leaves]
    state = opt.init(tree)
    for m, v, i in zip(state["mu"], state["nu"], opt.trained):
        m.copy_(grads[i].sign() * (0.5 + torch.rand(m.shape, generator=g, device="cuda")) * 1e-3)
        v.copy_(torch.rand(m.shape, generator=g, device="cuda") * 1e-5)
    moments = [t.clone() for t in state["mu"] + state["nu"]]
    pk, pp = [t.clone() for t in leaves], [t.clone() for t in leaves]
    sk = {"count": state["count"].clone(), "mu": state["mu"], "nu": state["nu"]}
    sp = {"count": state["count"].clone(), "mu": [t.clone() for t in state["mu"]],
          "nu": [t.clone() for t in state["nu"]]}
    ok = torch.tensor(True, device="cuda")
    adam.launches = adam.norm_launches = 0
    opt._kernel_chain(pk, grads, sk, ok)
    launches, norm_launches = adam.launches, adam.norm_launches
    opt._plain_chain(pp, grads, sp, ok)
    torch.cuda.synchronize()
    out = {
        "moments": _worst(zip(sk["mu"] + sk["nu"], sp["mu"] + sp["nu"], moments),
                          lambda a, b, c: torch.maximum(b.abs(), c.abs()).double() * 1e-6
                          + 1e-12),
        # the parameters' difference is the steps' difference: bound it by
        # the plain chain's step and the rounding of each chain's p + step
        "steps": _worst(zip(pk, pp, leaves),
                        lambda a, b, c: (b.double() - c.double()).abs() * 1e-6
                        + _ulp(torch.maximum(a.abs(), b.abs()))),
        "launches": launches, "norm_launches": norm_launches, "grad_copies": adam.grad_copies,
        "trained": len(opt.trained), "elements": sum(leaves[i].numel() for i in opt.trained),
        "grad_elements": sum(t.numel() for t in leaves)}
    out["chains"] = (opt, grads, pk, sk, pp, sp, ok)
    return out


def select_against_where(stats: list[torch.Tensor], g: torch.Generator) -> None:
    """The guarded copy (``adam.select``, one launch) against ``torch.where``
    on ``stats`` (the fusion model's BN running statistics), new values with
    a NaN in each: every byte equal for ``ok`` true and false."""
    from mgnns_tpu_torch.kernels import adam

    news = []
    for t in stats:
        new = t * 1.5 + torch.rand(t.shape, generator=g, device="cuda")
        new.view(-1)[0] = math.nan
        news.append(new)
    for flag in (True, False):
        ok = torch.tensor(flag, device="cuda")
        kernel, plain = [t.clone() for t in stats], [t.clone() for t in stats]
        adam.select_launches = 0
        adam.select(kernel, news, ok)
        launches = adam.select_launches
        for old, new in zip(plain, news):
            torch.where(ok, new, old, out=old)
        torch.cuda.synchronize()
        same = all(torch.equal(a.view(-1).view(torch.uint8), b.view(-1).view(torch.uint8))
                   for a, b in zip(kernel, plain))
        log(f"phase 2d: guarded copy of the fusion model's {len(stats)} BN statistics "
            f"({sum(t.numel() for t in stats)} elements), ok {flag}: {launches} launch, "
            f"{'byte-equal to' if same else 'UNLIKE'} torch.where")
        if not same or launches != 1:
            raise SystemExit("phase 2d: the guarded copy disagrees with torch.where")


def phase2d_adam() -> dict:
    from mgnns_tpu_torch.kernels import adam

    t_phase = time.perf_counter()
    r = np.random.default_rng(5)
    init = dict(num_edges=P2D_EDGES, label_embedding=r.standard_normal((7, 300)),
                object_A=np.eye(80), place_A=np.eye(365),
                object_inp=r.standard_normal((80, 300)),
                place_inp=r.standard_normal((365, 300)), device="cuda")
    fusion, stats, _ = mgnns_init(ModelConfig(edges_num=P2D_EDGES), **init)
    g = torch.Generator(device="cuda").manual_seed(5)
    select_against_where(tree_leaves(stats), g)
    del stats
    out = {}
    sets = (("fusion", lambda: fusion),
            ("256M", lambda: {"gc1": [torch.randn(P2D_BIG[1], generator=g, device="cuda")
                                      for _ in range(P2D_BIG[0])]}),
            ("moonlight-leaves", lambda: mgnns_init(
                ModelConfig(edges_num=P2D_EDGES, text_encoder=P2D_MOE), **init)[0]))
    for name, make in sets:
        tree = make()
        res = adam_against_plain(tree, g)
        opt, grads, pk, sk, pp, sp, ok = res.pop("chains")
        split = name == "moonlight-leaves"
        line = (f"phase 2d: Adam over the {name} set ({res['trained']} trained leaves, "
                f"{res['elements']} elements): kernels against the plain chain on the card, "
                f"worst over its bound: moments {res['moments']}, steps {res['steps']}; "
                f"{res['launches']} update, {res['norm_launches']} norm launches, "
                f"{res['grad_copies']} gradients copied")
        if not split:
            res["chain_ms"] = cuda_ms(lambda: opt._kernel_chain(pk, grads, sk, ok), iters=5,
                                      reps=3)
            res["update_us"], res["norm_us"] = (
                kernel_us(lambda: opt._kernel_chain(pk, grads, sk, ok), kernel, 10)
                for kernel in ("mgnns_adam_update_kernel", "mgnns_adam_sumsq_kernel"))
            res["plain_ms"] = cuda_ms(lambda: opt._plain_chain(pp, grads, sp, ok), iters=3,
                                      reps=3)
            res["bound_ms"] = adam_bound_ms(res["grad_elements"], res["elements"])
            line += (f"; the chain {res['chain_ms']} ms a step, update kernel "
                     f"{res['update_us']} us and norm kernel {res['norm_us']} us a launch "
                     f"(profiler), bound {res['bound_ms']} ms (bytes), plain chain "
                     f"{res['plain_ms']} ms")
        log(f"{line}; {card_line()}")
        want = -(-res["trained"] // adam.MAX_UPDATE_LEAVES)
        if not max(res["moments"], res["steps"]) <= 1.0 or \
                res["launches"] != want or (split and want < 2):
            raise SystemExit(f"phase 2d: the optimizer kernels disagree with the plain chain on "
                             f"the {name} set")
        out[name] = res
        del tree, opt, grads, pk, sk, pp, sp
    log(f"phase 2d: {time.perf_counter() - t_phase} s")
    return out


# ------------------------------------------------------------------ phase 3


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
        f"peak device memory {peak} bytes; last chunk stages {last_chunk_stages_ms()}; "
        f"{card_line()}")
    return {"launches": launches, "forwards": forwards}


def span_ms(span: tracing.Span) -> float:
    return (span.end_ns - span.start_ns) / 1e6


def last_chunk_stages_ms() -> dict:
    """Milliseconds of each serving span of the last chunk read back."""
    done = tracing.spans("serving.readback")
    if not done:
        return {}
    chunk = done[-1].attrs.get("chunk")
    return {s.name: span_ms(s) for s in tracing.spans("serving.")
            if s.attrs.get("chunk") == chunk}


def kernel_us(fn, name: str, calls: int = 50) -> float:
    """Device time a launch of the kernel whose name contains ``name``, by
    the profiler over ``calls`` calls of ``fn``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
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


def _ms(fn):
    """(fn(), its wall ms on the host clock)."""
    t0 = time.perf_counter()
    out = fn()
    return out, (time.perf_counter() - t0) * 1e3


def phase3_native(vocab: list[str], texts: list[str], graph, pred: Predictor) -> None:
    """The native host preprocessing (``mgnns_tpu_torch.native``) on phase
    3's corpus against its numpy paths, equal array for array: the pair
    counts (the native counter forced below its corpus-size threshold),
    ``cal_pmi``'s graph, the window edge ids of a 16-record request and of
    the whole corpus, and the 16-record request's encode in turns.  Host
    times, of the card machine's CPU."""
    from mgnns_tpu_torch import native
    from mgnns_tpu_torch.data.text import encode_texts
    from mgnns_tpu_torch.graphs import pmi
    from mgnns_tpu_torch.graphs.vocab import make_word_to_id

    t0 = time.perf_counter()
    ok = native.available()
    lib = build.load_host("host_preproc")
    log(f"phase 3: native host preprocessing available {ok}: {lib.lib._name if lib else None}, "
        f"built in {lib.seconds if lib else None} s (0.0: built before) with "
        f"{' '.join(build.CXX_FLAGS)}; first use {time.perf_counter() - t0} s")
    if not ok:
        raise SystemExit("phase 3: the native library is unavailable (no C++ compiler?)")
    no_native = mock.patch.object(native, "_load", lambda: None)
    forced = mock.patch.object(native, "_NATIVE_PAIR_THRESHOLD", 0)
    w2i = make_word_to_id(vocab)
    V = len(vocab)
    ids = pmi._corpus_to_ids(pmi.pad_and_filter(texts, max_len=100), w2i)
    with forced:
        nat, nat_ms = _ms(lambda: native.pmi_pair_count(ids, V, 6))
    ref, np_ms = _ms(lambda: native.pmi_pair_count_numpy(ids, V, 6))
    counts_equal = all(np.array_equal(a, b) for a, b in zip(nat, ref))
    with forced:
        g_nat, gnat_ms = _ms(lambda: cal_pmi(texts, vocab, window_size=6, min_cooccurrence=2))
    with no_native:
        g_np, gnp_ms = _ms(lambda: cal_pmi(texts, vocab, window_size=6, min_cooccurrence=2))
    graph_equal = all(np.array_equal(a, b) for a, b in ((g_nat.keys, g_np.keys),
                                                        (g_nat.pmi, g_np.pmi),
                                                        (g_np.keys, graph.keys)))
    log(f"phase 3: pmi_pair_count on {ids.shape[0]} documents x {ids.shape[1]} "
        f"({ids.shape[0] * ids.shape[1] * 12} candidate pairs, threshold "
        f"{native._NATIVE_PAIR_THRESHOLD}): native {nat_ms} ms, numpy {np_ms} ms, "
        f"{len(nat[0])} distinct pairs, keys, counts and word counts equal {counts_equal}; "
        f"cal_pmi on the native counter {gnat_ms} ms, on numpy {gnp_ms} ms, graphs equal "
        f"{graph_equal} ({g_nat.num_edges} edges); host times of the card's machine")
    g = graph
    recs = [{"id": f"nat{i}", "text": texts[(i * 37) % len(texts)]} for i in range(16)]
    cfg = TextGraphConfig()
    req_ids, req_lens, _, _ = encode_texts([r["text"] for r in recs], w2i, g, cfg)
    all_ids, all_lens, _, _ = encode_texts(texts, w2i, g, cfg)
    lines, eids_equal = [], True
    for label, a, b in (("16-record request", req_ids, req_lens),
                        (f"corpus of {len(texts)}", all_ids, all_lens)):
        e_nat, t_nat = _ms(lambda: native.window_edge_ids(a, b, cfg.ngram, g.keys, g.vocab_size))
        e_np, t_np = _ms(lambda: pmi.doc_window_edge_ids_numpy(a, b, cfg.ngram, g))
        eids_equal &= np.array_equal(e_nat, e_np)
        lines.append(f"{label}: native {t_nat} ms, numpy {t_np} ms, equal "
                     f"{np.array_equal(e_nat, e_np)}, {int((e_nat > 0).sum())} edges found")
    turns: dict = {"native": [], "numpy": []}
    batches: dict = {}
    for path in ("native", "numpy", "numpy", "native") * 3:
        with (no_native if path == "numpy" else contextlib.nullcontext()):
            batches[path], _ = pred._encode_host(recs)
        turns[path].append(span_ms(tracing.spans("serving.encode_text")[-1]))
    encode_equal = all(np.array_equal(batches["native"][k], batches["numpy"][k])
                       for k in batches["native"])
    log(f"phase 3: doc_window_edge_ids (ngram {cfg.ngram}) {'; '.join(lines)}; the 16-record "
        f"request's encode_text_ms in turns: native {turns['native']} (median "
        f"{statistics.median(turns['native'])}), numpy {turns['numpy']} (median "
        f"{statistics.median(turns['numpy'])}), batches equal {encode_equal}; host times of "
        f"the card's machine; {card_line()}")
    if not (counts_equal and graph_equal and eids_equal and encode_equal):
        raise SystemExit("phase 3: the native host preprocessing disagrees with numpy")


def phase3(k1: dict) -> None:
    t0 = time.perf_counter()
    # the flagship data: the seeded corpus, its PMI graph and the label constants
    data = flagship_data("synthetic")
    vocab, texts, graph, c = data.vocab, data.ds.text.texts, data.graph, data.consts_np
    log(f"phase 3: corpus {len(texts)} docs, vocab {len(vocab)}, PMI edges "
        f"{graph.num_edges} ({time.perf_counter() - t0} s on the host)")
    cfg = ModelConfig(edges_num=graph.num_edges)
    object_A, place_A = c["object_A"], c["place_A"]
    t0 = time.perf_counter()
    params, stats, consts = mgnns_init(
        cfg, num_edges=graph.num_edges, label_embedding=c["label_embedding"],
        object_A=object_A, place_A=place_A, object_inp=c["object_inp"],
        place_inp=c["place_inp"], seed=0, device="cuda")
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
    phase3_native(vocab, texts, graph, pred)

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

    # one record on the card against the same forward on the CPU, under the
    # package's default and then with its conv precision pin removed and TF32
    # allowed: the first must hold float32's tolerance, the second differ more
    one = {k: v[:1] for k, v in batch.items()}
    cpu = torch.device("cpu")
    with torch.inference_mode():
        host = mgnns_apply(tree_to(pred.params, cpu), tree_to(pred.batch_stats, cpu),
                           tree_to(pred.consts, cpu), {k: v.cpu() for k, v in one.items()},
                           cfg=cfg)[0]
    diffs = {}
    for label in ("pinned", "unpinned TF32"):
        with (tf32_unpinned() if label == "unpinned TF32" else contextlib.nullcontext()), \
                torch.inference_mode():
            card = mgnns_apply(pred.params, pred.batch_stats, pred.consts, one, cfg=cfg)[0].cpu()
        diffs[label] = float((card - host).abs().max())
    # two full-depth trunks in float32, sums in another order
    tol = 1e-5 * max(1.0, float(host.abs().max()))
    log(f"phase 3: 1-record logits card vs CPU: max |diff| {diffs['pinned']} under the "
        f"package's default (tolerance {tol}), {diffs['unpinned TF32']} with the pin removed "
        f"and TF32 allowed; global conv precision after: "
        f"{torch.backends.cudnn.conv.fp32_precision}")
    if diffs["pinned"] > tol:
        raise SystemExit("phase 3: card and CPU forwards disagree")
    if not diffs["unpinned TF32"] > diffs["pinned"]:
        raise SystemExit("phase 3: the TF32 forward is no further from the CPU than the pinned "
                         "one, so the card-vs-CPU check cannot see the conv precision")

    profile_forward(pred, batch_np)
    pred.close()
    trunk_grads_card_vs_cpu(cfg, graph.num_edges, object_A, place_A, batch_np)

    # the text-only model through the same Predictor
    text_params = text_model_init(len(vocab), len(LABELS), graph.num_edges, seed=0, device="cuda")
    tpred = Predictor(vocab=vocab, graph=graph, graph_cfg=graph_cfg, label_map=LABELS,
                      params=text_params, max_batch=16, text_only=True, device="cuda")
    tpred.warm()
    serve(tpred, texts, "text-only")
    tpred.close()
    return {"vocab": vocab, "texts": texts, "graph": graph, "cfg": cfg, "object_A": object_A,
            "place_A": place_A}


@contextlib.contextmanager
def tf32_unpinned():
    """The package's conv precision pin replaced by a no-op, and TF32 allowed
    for cuDNN's float32 convolutions; both restored after."""
    conv = torch.backends.cudnn.conv
    saved = conv.fp32_precision
    conv.fp32_precision = "tf32"
    try:
        with mock.patch.object(resnet, "ieee_float32_convs", contextlib.nullcontext):
            yield
    finally:
        conv.fp32_precision = saved


def trunk_grads_card_vs_cpu(cfg, num_edges, object_A, place_A, batch_np) -> None:
    """The trunk gradients of a 1-record train step (running-statistics
    BatchNorm, dropout 0) on the card against the CPU, with weights made on
    the CPU and moved to the card: under the package's default, and with the
    precision pin removed and TF32 allowed, which must differ more.

    They are compared by the Frobenius norm of the difference over all
    trunk leaves, relative to the CPU's: the largest single difference is a
    few 1e-3 of scale even in IEEE float32, because where two inputs of the
    global max pool or a ReLU's input nearly tie, float32 sums in another
    order send the gradient down another path.  The tolerance, 5e-3, sits
    several times above the float32 readings on an H100 and an order of
    magnitude under the TF32 ones (``PERF.md``, section 6)."""
    cfg = dataclasses.replace(cfg, bn_mode="frozen", dropout=0.0, text_dropout=0.0)
    r = np.random.default_rng(3)
    weights = mgnns_init(cfg, num_edges=num_edges,
                         label_embedding=r.standard_normal((7, 300)).astype(np.float32),
                         object_A=object_A, place_A=place_A,
                         object_inp=r.standard_normal((80, 300)).astype(np.float32),
                         place_inp=r.standard_normal((365, 300)).astype(np.float32),
                         seed=3, device="cpu")
    one = {k: torch.from_numpy(v[:1]) for k, v in batch_np.items()}
    label, weight = torch.tensor([2]), torch.ones(1)

    def trunk_grads(dev):
        params, stats, consts = (tree_to(t, torch.device(dev)) for t in weights)
        live = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
        tree = tree_unflatten(params, live)
        logits = mgnns_apply(tree, stats, consts, {k: v.to(dev) for k, v in one.items()},
                             cfg=cfg, train=True)[0]
        loss = cross_entropy(logits, label.to(dev), weight.to(dev))
        trunk = tree_leaves({k: tree[k] for k in ("object_trunk", "place_trunk")})
        return [g.cpu().double() for g in torch.autograd.grad(loss, trunk)]

    host = trunk_grads("cpu")
    norm = float(torch.sqrt(sum((g ** 2).sum() for g in host)))
    scale = max(float(g.abs().max()) for g in host)
    errs = {}
    for label_ in ("pinned", "unpinned TF32"):
        with tf32_unpinned() if label_ == "unpinned TF32" else contextlib.nullcontext():
            card = trunk_grads("cuda")
        if not all(torch.isfinite(g).all() for g in card):
            raise SystemExit(f"phase 3: non-finite trunk gradients on the card ({label_})")
        fro = float(torch.sqrt(sum(((a - b) ** 2).sum() for a, b in zip(card, host)))) / norm
        mx = max(float((a - b).abs().max()) for a, b in zip(card, host)) / scale
        errs[label_] = fro
        log(f"phase 3: trunk gradients of a 1-record step card vs CPU ({len(host)} leaves), "
            f"{label_}: Frobenius |diff| / |CPU| {fro}, max |diff| / scale {mx}")
    if errs["pinned"] > 5e-3 or not errs["unpinned TF32"] > errs["pinned"]:
        raise SystemExit("phase 3: the card's trunk gradients disagree with the CPU's, or the "
                         "TF32 backward is no further from them")


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


def phase4(setup: dict, k1: dict, k2: dict) -> dict:
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

    apply_fn = fusion_apply_fn(cfg, consts)
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
    log(f"phase 4: 10 Adam steps (base lr {-engine.opt.neg_lrs[0]}, lrp 0.1) "
        f"on one 16-record batch: loss {first} -> {loss}; step ms (host clock, loss read each "
        f"step) {step_ms}, median after the first {statistics.median(step_ms[1:])}; {card_line()}")
    if not loss < first:
        raise SystemExit("phase 4: 10 steps on one batch did not lower its loss")

    # what the nan-guard's device-side selects cost: steps with and without
    # it, in turns
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
    return {"engine": engine, "batch": batch, "consts": consts, "cfg": cfg}


# ----------------------------------------------------------------- phase 4b


def phase4b(p4: dict) -> None:
    engine, batch, consts, cfg = p4["engine"], p4["batch"], p4["consts"], p4["cfg"]
    cfgs = {"float32": cfg, "bfloat16": dataclasses.replace(cfg, compute_dtype="bfloat16")}
    dev_batch = engine._to_device(batch)

    # bf16 against float32 logits, eval mode, on phase 4's trained weights: the
    # 16-record batch on the card, and its first record on the card and on the
    # CPU, whose bf16 path the CPU tests hold to the JAX package's
    def drift(batch_, params, stats, consts_):
        with torch.inference_mode():
            lg = {dt: mgnns_apply(params, stats, consts_, batch_, cfg=c)[0].float()
                  for dt, c in cfgs.items()}
        ok = bool(torch.isfinite(lg["bfloat16"]).all())
        return ok, float((lg["bfloat16"] - lg["float32"]).abs().max() / lg["float32"].abs().max())

    cpu = torch.device("cpu")
    ok16, d16 = drift(dev_batch, engine.params, engine.batch_stats, consts)
    one = {k: v[:1] for k, v in dev_batch.items()}
    ok1, d_card = drift(one, engine.params, engine.batch_stats, consts)
    _, d_cpu = drift({k: v.cpu() for k, v in one.items()}, tree_to(engine.params, cpu),
                     tree_to(engine.batch_stats, cpu), tree_to(consts, cpu))
    log(f"phase 4b: eval logits, bf16 trunks vs float32, max |diff| / scale: 16 records on the "
        f"card {d16} (tolerance 4e-2, the JAX package's bf16 bound); 1 record on the card "
        f"{d_card}, on the CPU {d_cpu} (tolerance for the card: twice the CPU's)")
    if not (ok16 and ok1) or d16 > 4e-2 or d_card > 2 * d_cpu:
        raise SystemExit("phase 4b: bf16 logits are not finite, too far from float32, or "
                         "further from it on the card than twice the CPU's drift")

    # one bf16 train step's loss and gradients
    leaves = tree_leaves(engine.params)
    live = [p.detach().requires_grad_(p.is_floating_point()) for p in leaves]
    tree = tree_unflatten(engine.params, live)
    out, _, aux = mgnns_apply(tree, engine.batch_stats, consts, dev_batch, cfg=cfgs["bfloat16"],
                              train=True, generator=torch.Generator(device="cuda").manual_seed(0))
    loss = cross_entropy(out, dev_batch["label"], dev_batch["weight"])
    want = [p for p in live if p.requires_grad]
    grads = torch.autograd.grad(loss, want, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(want, grads)]
    trunk_ids = {id(t) for t in tree_leaves({k: tree[k] for k in ("object_trunk", "place_trunk")})}
    trunk_sum = sum(float(g.abs().sum()) for p, g in zip(want, grads) if id(p) in trunk_ids)
    finite = all(bool(torch.isfinite(g).all()) for g in grads)
    dtypes = {str(t.dtype) for t in want} | {str(g.dtype) for g in grads}
    log(f"phase 4b: one bf16 train step: loss {float(loss)}, {len(grads)} gradients all finite "
        f"{finite}, parameter and gradient dtypes {sorted(dtypes)}, trunk gradient |sum| "
        f"{trunk_sum}")
    if not (math.isfinite(float(loss)) and finite and dtypes == {"torch.float32"}
            and trunk_sum > 0):
        raise SystemExit("phase 4b: the bf16 train step is not finite, not float32 or has no "
                         "trunk gradient")

    # train step ms of each dtype in turns, after two warm-up steps each
    applies = {}
    for dt, c in cfgs.items():
        def apply_dt(p, bs, b, *, train, generator, c=c):
            lg, nbs, ax = mgnns_apply(p, bs, consts, b, cfg=c, train=train, generator=generator)
            return lg, nbs, ax.get("head_diversity", 0.0)
        applies[dt] = apply_dt
    cm = confusion_init(len(LABELS), "cuda")
    step_ms: dict = {dt: [] for dt in cfgs}
    order = ("float32", "bfloat16") * 2 + ("float32", "bfloat16", "bfloat16", "float32") * 2
    for i, dt in enumerate(order):
        engine.apply_fn = applies[dt]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.train_step(batch, cm)
        torch.cuda.synchronize()
        if i >= 4:
            step_ms[dt].append((time.perf_counter() - t0) * 1e3)
    log(f"phase 4b: 16-record train step ms (host clock, in turns after two warm-up steps each): "
        f"float32 {step_ms['float32']} (median {statistics.median(step_ms['float32'])}), bf16 "
        f"{step_ms['bfloat16']} (median {statistics.median(step_ms['bfloat16'])}); {card_line()}")

    # peak memory of one forward/backward of each (phase 4's method)
    peaks = {}
    for dt in cfgs:
        def fb_apply(p, bs, b, *, train, generator, dt=dt):
            return (*mgnns_apply(p, bs, consts, b, cfg=cfgs[dt], train=train,
                                 generator=generator)[:2], 0.0)

        peng = Engine(fb_apply, engine.params, engine.batch_stats, num_classes=len(LABELS),
                      eval_only=True, device="cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _loss_and_text_grads(peng, batch, seed=5)
        torch.cuda.synchronize()
        peaks[dt] = torch.cuda.max_memory_allocated()
    log(f"phase 4b: one 16-record forward/backward, peak device memory float32 "
        f"{peaks['float32']} bytes, bf16 {peaks['bfloat16']} bytes; {card_line()}")

    # kernel ms of the trunk ranges (their forward kernels) and the step's
    # device busy time, from one profiled train step of each
    from torch.profiler import ProfilerActivity, profile

    for dt in cfgs:
        engine.apply_fn = applies[dt]
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            engine.train_step(batch, cm)
            torch.cuda.synchronize()
        ranges = {e.key: e.device_time_total / 1e3 for e in prof.key_averages()
                  if e.key in ("mgnns.object_channel", "mgnns.place_channel")
                  and e.device_type != torch.autograd.DeviceType.CUDA}
        kernels = device_kernels(prof)
        busy = sum(e.self_device_time_total for e in kernels) / 1e3
        top = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:3]
        log(f"phase 4b: {dt} train step, profiled: forward kernel ms of the trunk ranges {ranges}; "
            f"device busy {busy} ms over {sum(e.count for e in kernels)} launches; top kernels "
            f"{[(e.key[:60], e.self_device_time_total / 1e3) for e in top]}")
    engine.apply_fn = applies["float32"]


# ------------------------------------------------------------------ phase 5


def run_cli(root: str, name: str, extra: list[str], forwards: int, steps: int,
            phase: str = "phase 5") -> dict:
    """``mgnns_tpu_torch.cli.main.main`` in this process with the kernels'
    launch counts set to 0 just before; fails unless K1 launched once per
    forward and K2 once per train step."""
    from mgnns_tpu_torch.cli import main as cli_main

    out = os.path.join(root, name)
    argv = ["--data_root_path", root, "--num_labels", "3", "--text_min_count", "1", "-e",
            "--save_model_path", os.path.join(out, "ckpt"),
            "--save_experiment_result_path", os.path.join(out, "exp"),
            "--save_pred_result_path", os.path.join(out, "pred"),
            "--metrics_path", os.path.join(out, "metrics.jsonl")] + extra
    edge_max.launches = edge_max.bwd_launches = 0
    t0 = time.perf_counter()
    res = cli_main.main(argv)
    torch.cuda.synchronize()
    launches, bwd = edge_max.launches, edge_max.bwd_launches
    hist = res["history"]
    log(f"{phase}: CLI {name} ({' '.join(extra)}): {time.perf_counter() - t0} s; train loss "
        f"{[h['train']['loss'] for h in hist]}, val loss {[h['val']['loss'] for h in hist]}, "
        f"best val acc {res['best_val_accuracy']}, test acc {res['test']['accuracy']}; K1 "
        f"launches {launches} for {forwards} forwards, K2 {bwd} for {steps} train steps; "
        f"{card_line()}")
    if (launches, bwd) != (forwards, steps):
        raise SystemExit(f"{phase}: CLI {name}: kernel launch counts do not match the run")
    losses = [h["train"]["loss"] for h in hist] + [h["val"]["loss"] for h in hist]
    if not all(math.isfinite(v) for v in losses + [res["test"]["loss"]]):
        raise SystemExit(f"{phase}: CLI {name}: a non-finite loss")
    files = [os.path.join(out, "metrics.jsonl"),
             os.path.join(out, "ckpt", "mgnns_tpu", "preproc.json"),
             os.path.join(out, "ckpt", "mgnns_tpu", "preproc.npz")]
    files += [os.path.join(d, f) for kind in ("exp", "pred")
              for d, _, fs in os.walk(os.path.join(out, kind)) for f in fs]
    if len(files) != 5 or not all(os.path.getsize(f) for f in files):
        raise SystemExit(f"{phase}: CLI {name}: result, metrics or preproc files missing: {files}")
    return res


def phase5() -> str:
    root = tempfile.mkdtemp(prefix="mgnns_cli_")
    cli_tree(root)
    # 90 records in batches of 30: 3 train steps and 3 val forwards an epoch,
    # 3 test forwards after
    res = run_cli(root, "text", ["--text_only", "--epochs", "6", "-b", "30", "--lr", "5e-2"],
                  forwards=6 * 6 + 3, steps=6 * 3)
    if not (res["best_val_accuracy"] > 0.8 and res["test"]["accuracy"] > 0.8):
        raise SystemExit("phase 5: the text-only CLI run did not learn the separable corpus")
    # the fusion model at full width, bf16 trunks: 32 records in batches of 16
    run_cli(root, "fusion_bf16", ["--compute_dtype", "bfloat16", "--limit_samples", "32",
                                  "--epochs", "1", "-b", "16"], forwards=2 + 2 + 2, steps=2)
    return root


# ------------------------------------------------------------------ phase 6

REQUEST = 37


def _check_answers(label: str, got: list[dict], want: list[dict], atol: float,
                   phase: str = "phase 6") -> float:
    """Labels equal and probabilities within ``atol``; returns the max |diff|."""
    if [g["label"] for g in got] != [w["label"] for w in want]:
        raise SystemExit(f"{phase}: {label}: labels differ")
    diff = max(abs(g["probs"][k] - w["probs"][k]) for g, w in zip(got, want) for k in w["probs"])
    if diff > atol:
        raise SystemExit(f"{phase}: {label}: probabilities differ by {diff} (tolerance {atol})")
    return diff


def _probs(out: list[dict]) -> np.ndarray:
    return np.array([list(o["probs"].values()) for o in out])


def _serve_artifacts(root: str, name: str, text_only: bool, records: list[dict]):
    """``from_engine_artifacts`` of phase 5's ``name`` run; one request of
    ``records`` with K1's count reset just before."""
    ckpt = os.path.join(root, name, "ckpt", "mgnns_tpu")
    t0 = time.perf_counter()
    pred = Predictor.from_engine_artifacts(root, ckpt, text_only=text_only,
                                           image_backend="synthetic", strict_images=False)
    pred.warm()
    load_s = time.perf_counter() - t0
    edge_max.launches = 0
    t0 = time.perf_counter()
    out = pred.predict(records)
    ms = (time.perf_counter() - t0) * 1e3
    launches, forwards = edge_max.launches, math.ceil(len(records) / pred.max_batch)
    p = _probs(out)
    log(f"phase 6: from_engine_artifacts({name}): loaded and warmed in {load_s} s; a "
        f"{len(records)}-record request {ms} ms; K1 launches {launches} for {forwards} forwards; "
        f"{card_line()}")
    if launches != forwards:
        raise SystemExit(f"phase 6: {name}: K1 launched {launches} times for {forwards} forwards")
    if p.shape != (len(records), 3) or not np.isfinite(p).all() or np.abs(p.sum(1) - 1).max() > 1e-5:
        raise SystemExit(f"phase 6: {name}: bad answer")
    return pred, ckpt, out


def phase6(root: str) -> None:
    from mgnns_tpu_torch.cli import predict as cli_predict
    from mgnns_tpu_torch.cli import serve as cli_serve
    from mgnns_tpu_torch.models.import_reference import export_reference_state_dict
    from mgnns_tpu_torch.serving import BatchingFrontend, load_preproc

    t_phase = time.perf_counter()
    with open(os.path.join(root, "all_anno_json", "test_all_anno.json")) as f:
        texts = [json.loads(line)["text"] for line in f]
    records = [{"id": f"s{i}", "text": texts[i % len(texts)] + (" unknownword" if i % 4 == 0 else ""),
                "image": f"img/{i}.jpg"} for i in range(REQUEST)]

    # 1. both phase-5 checkpoints; the fusion one (float32) against K1's plain version
    text_pred, _, _ = _serve_artifacts(root, "text", True, records)
    text_pred.close()
    pred, ckpt, out = _serve_artifacts(root, "fusion_bf16", False, records)
    with mock.patch.object(edge_max, "_launch", edge_max.window_max_aggregate_plain):
        plain = pred.predict(records)
    diff = _check_answers("fusion with K1 vs plain K1", out, plain, 1e-5)
    log(f"phase 6: fusion {REQUEST}-record probabilities with K1 vs plain K1: max |diff| {diff} "
        f"(tolerance 1e-5, phase 3's)")

    # 2. the predict CLI in this process on the same records
    src, dst = os.path.join(root, "requests.jsonl"), os.path.join(root, "answers.jsonl")
    with open(src, "w") as f:
        f.writelines(json.dumps(r) + "\n" for r in records)
    edge_max.launches = 0
    t0 = time.perf_counter()
    cli_predict.main(["--data_root_path", root, "--checkpoint", ckpt, "--input", src,
                      "--output", dst, "--image_backend", "synthetic"])
    cli_s = time.perf_counter() - t0
    with open(dst) as f:
        lines = [json.loads(line) for line in f]
    if [x["id"] for x in lines] != [r["id"] for r in records] or \
            [x["label_id"] for x in lines] != [o["label_id"] for o in out]:
        raise SystemExit("phase 6: the predict CLI's ids or labels differ from predict")
    diff = _check_answers("predict CLI vs predict", lines, out, 1e-6)
    log(f"phase 6: cli.predict on {REQUEST} records: {cli_s} s, K1 launches {edge_max.launches}, "
        f"labels equal, probabilities max |diff| {diff} (tolerance 1e-6)")

    # 3. a full-width model with its dead modules, made on the CPU and moved,
    # exported as a reference wrapper, served and trained from
    vocab, graph, label_map, _ = load_preproc(ckpt)
    cfg = ModelConfig(num_labels=len(label_map), vocab_size=len(vocab), edges_num=graph.num_edges)
    consts_np = {k: v.cpu().numpy() for k, v in pred.consts.items()}
    weights = mgnns_init(cfg, num_edges=graph.num_edges,
                         label_embedding=consts_np["label_query"],
                         object_A=pred.params["object_A"].cpu().numpy(),
                         place_A=pred.params["place_A"].cpu().numpy(),
                         object_inp=consts_np["object_inp"], place_inp=consts_np["place_inp"],
                         include_dead_modules=True, seed=6, device="cpu")
    params, stats, consts = (tree_to(t, pred.device) for t in weights)
    wrapper = os.path.join(root, "reference_model_best.pth.tar")
    torch.save({"epoch": 1, "arch": "Multi_GCN_Multihead_Att", "best_score": np.float64(0.5),
                "state_dict": export_reference_state_dict(params, stats)}, wrapper)
    mem = Predictor(vocab=vocab, graph=graph, graph_cfg=pred.graph_cfg, label_map=label_map,
                    params=params, batch_stats=stats, consts=consts, cfg=cfg,
                    image_backend="synthetic", strict_images=False)
    ref = Predictor.from_engine_artifacts(root, ckpt, reference_ckpt=wrapper,
                                          image_backend="synthetic", strict_images=False)
    want, got = _probs(mem.predict(records)), _probs(ref.predict(records))
    diff = float(np.abs(want - got).max())
    log(f"phase 6: reference wrapper ({os.path.getsize(wrapper)} bytes, {len(params)} top-level "
        f"modules with the dead ones) served through reference_ckpt vs the model in memory: max "
        f"|diff| {diff} (must be 0)")
    if not np.array_equal(want, got):
        raise SystemExit("phase 6: the reference wrapper's probabilities are not bit-equal")
    mem.close()
    ref.close()
    del mem, ref, params, stats, consts, weights
    run_cli(root, "fusion_ref", ["--init_from_reference", wrapper, "--limit_samples", "32",
                                 "--epochs", "1", "-b", "16"], forwards=2 + 2 + 2, steps=2,
            phase="phase 6")

    # 4. the frontend under load: 8 clients x 4 requests of 1-5 records
    import threading

    chunks = []
    forward = pred._forward

    def counted_forward(batch_np):
        chunks.append(len(batch_np["ids"]))
        return forward(batch_np)

    pred._forward = counted_forward
    fe = BatchingFrontend(pred, max_queue=64)
    reqs = {(c, k): [dict(records[(c * 4 + k + j) % REQUEST], id=f"c{c}k{k}r{j}")
                     for j in range(1 + (c + k) % 5)] for c in range(8) for k in range(4)}
    answers: dict = {}
    errors: list = []

    def client(c):
        try:
            for k in range(4):
                answers[(c, k)] = fe.submit(reqs[(c, k)], timeout=120)
        except Exception as e:  # reported below; the phase fails on it
            errors.append(repr(e))

    edge_max.launches = 0
    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(c,)) for c in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    wall = time.perf_counter() - t0
    launches = edge_max.launches
    if errors or any(t.is_alive() for t in threads) or len(answers) != 32:
        raise SystemExit(f"phase 6: frontend clients failed: {errors}")
    pred._forward = forward
    diff = max(_check_answers(f"frontend request {key}", answers[key], pred.predict(recs), 1e-5)
               for key, recs in reqs.items())
    stats_fe = fe.stats()
    log(f"phase 6: BatchingFrontend, 8 clients x 4 requests ({sum(map(len, reqs.values()))} "
        f"records) in {wall} s: stats {stats_fe}; {len(chunks)} device chunks of sizes {chunks}, "
        f"K1 launches {launches}; answers equal direct predict (max |diff| {diff}, tolerance 1e-5); "
        f"{card_line()}")
    if launches != len(chunks) or stats_fe["requests"] != 32:
        raise SystemExit("phase 6: the frontend's K1 launches do not match its device chunks")

    # 5. the HTTP server on loopback
    import urllib.error
    import urllib.request

    args = cli_serve.build_parser().parse_args([
        "--data_root_path", root, "--checkpoint", ckpt, "--image_backend", "synthetic",
        "--port", "0"])
    server = cli_serve.make_server(args)
    serving = threading.Thread(target=server.serve_forever, daemon=True)
    serving.start()
    host, port = server.server_address[:2]

    def http(method, path, body=None):
        req = urllib.request.Request(f"http://{host}:{port}{path}", data=body, method=method,
                                     headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=120) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    try:
        key = (3, 2)
        code, body = http("POST", "/predict", json.dumps({"records": reqs[key]}).encode())
        if code != 200:
            raise SystemExit(f"phase 6: POST /predict answered {code}: {body}")
        diff = _check_answers("HTTP /predict vs the frontend", body["predictions"], answers[key], 1e-5)
        code_h, health = http("GET", "/healthz")
        code_404, _ = http("GET", "/nope")
        log(f"phase 6: cli.serve on {host}:{port}: POST /predict 200 ({len(reqs[key])} records, "
            f"max |diff| {diff} against step 4), GET /healthz {code_h} {health}, GET /nope "
            f"{code_404}")
        if code_h != 200 or health.get("model") != ckpt or health.get("requests") != 1 \
                or code_404 != 404:
            raise SystemExit("phase 6: /healthz or the 404 answered wrongly")
    finally:
        server.shutdown()
        server.server_close()
        server.frontend.predictor.close()
        serving.join(30)
    pred.close()
    log(f"phase 6: {time.perf_counter() - t_phase} s; {card_line()}")


# ------------------------------------------------------------------ phase 7


def _forward_turns(preds: dict, batch_np: dict, turns: int = 5) -> dict:
    """Host wall ms of one forward of each Predictor, synchronized, in turns."""
    walls = {name: [] for name in preds}
    for _ in range(turns):
        for name, pred in preds.items():
            t0 = time.perf_counter()
            pred._forward(batch_np)
            torch.cuda.synchronize()
            walls[name].append((time.perf_counter() - t0) * 1e3)
    return walls


def _profile_forwards(preds: dict, batch_np: dict) -> None:
    """One profiled forward of each Predictor: device busy ms and kernel
    launches, and the host ops with the most self time."""
    from torch.profiler import ProfilerActivity, profile

    for name, pred in preds.items():
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            pred._forward(batch_np)
            torch.cuda.synchronize()
        kernels = device_kernels(prof)
        host = sorted((e for e in prof.key_averages()
                       if e.device_type == torch.autograd.DeviceType.CPU),
                      key=lambda e: e.self_cpu_time_total, reverse=True)[:6]
        log(f"phase 7: {name} 16-record forward, profiled: device busy "
            f"{sum(e.self_device_time_total for e in kernels) / 1e3} ms over "
            f"{sum(e.count for e in kernels)} kernel launches; host ops by self time "
            f"{[(e.key, e.count, e.self_cpu_time_total / 1e3) for e in host]}")


def _export_and_load(live: Predictor, out_dir: str, label: str, records: list[dict]):
    """Export ``live``, load it on the card, answer ``records`` with K1's
    count reset just before; the answers must be the live ones within
    1e-5 with K1 once per forward."""
    from mgnns_tpu_torch.export import export_predictor, load_exported

    t0 = time.perf_counter()
    export_predictor(live, out_dir)
    export_s = time.perf_counter() - t0
    sizes = {f: os.path.getsize(os.path.join(out_dir, f)) for f in ("model.pt2", "params.npz")}
    t0 = time.perf_counter()
    pred = load_exported(out_dir, image_backend="synthetic", strict_images=False, device="cuda")
    pred.warm()
    load_s = time.perf_counter() - t0
    edge_max.launches = 0
    out = pred.predict(records)
    launches, forwards = edge_max.launches, math.ceil(len(records) / pred.max_batch)
    want = live.predict(records)
    diff = _check_answers(f"{label} exported vs live", out, want, 1e-5, "phase 7")
    log(f"phase 7: {label} exported on {live.device} in {export_s} s (model.pt2 "
        f"{sizes['model.pt2']} bytes, params.npz {sizes['params.npz']} bytes), loaded on the "
        f"card and warmed in {load_s} s; a {len(records)}-record request: K1 launches "
        f"{launches} for {forwards} forwards, probabilities max |diff| {diff} against the live "
        f"Predictor (tolerance 1e-5), labels equal; {card_line()}")
    if launches != forwards:
        raise SystemExit(f"phase 7: {label}: K1 launched {launches} times for {forwards} forwards")
    return pred, want


def phase7(root: str, k1: dict) -> None:
    """Phase 5's checkpoints exported and served again on the card:
    ``load_exported`` in this process, ``cli.predict --from_exported`` of the
    text-only artifact in a fresh one, a text-only model exported on the CPU
    and served on the card, and ``cli.serve --from_exported`` of the fusion
    artifact over loopback."""
    import threading
    import urllib.request

    from mgnns_tpu_torch.cli import serve as cli_serve

    t_phase = time.perf_counter()
    out_root = tempfile.mkdtemp(prefix="mgnns_export_")
    with open(os.path.join(root, "all_anno_json", "test_all_anno.json")) as f:
        texts = [json.loads(line)["text"] for line in f]
    records = [{"id": f"x{i}", "text": texts[(3 * i) % len(texts)] + (" unknownword" * (i % 3)),
                "image": f"img/{i}.jpg"} for i in range(REQUEST)]
    common = dict(image_backend="synthetic", strict_images=False)
    fusion_ckpt = os.path.join(root, "fusion_bf16", "ckpt", "mgnns_tpu")
    text_ckpt = os.path.join(root, "text", "ckpt", "mgnns_tpu")

    # 1-2. the float32 fusion and the text-only Predictor, exported on the card
    live = Predictor.from_engine_artifacts(root, fusion_ckpt, **common)
    if live.cfg.image_size != 448 or live.cfg.compute_dtype != "float32" or live.max_batch != 16:
        raise SystemExit(f"phase 7: not the full-width float32 model: {live.cfg}")
    fusion_dir = os.path.join(out_root, "fusion")
    pred, want = _export_and_load(live, fusion_dir, "fusion", records)
    batch_np, _ = live._encode_host(records[:16])
    walls = _forward_turns({"live": live, "exported": pred}, batch_np)
    log(f"phase 7: 16-record fusion forward, host wall ms in turns (synchronized): live "
        f"{walls['live']} (median {statistics.median(walls['live'])}), exported "
        f"{walls['exported']} (median {statistics.median(walls['exported'])}); {card_line()}")
    _profile_forwards({"live": live, "exported": pred}, batch_np)
    pred.close()
    text_live = Predictor.from_engine_artifacts(root, text_ckpt, text_only=True, **common)
    text_dir = os.path.join(out_root, "text")
    text_pred, text_want = _export_and_load(text_live, text_dir, "text-only", records)
    text_pred.close()

    # 3. the predict CLI in a fresh process on the text-only artifact (the
    # fusion artifact is loaded in this process above and by cli.serve below;
    # a fresh process loading it again took 43-61 s of the card budget)
    src, dst = os.path.join(out_root, "requests.jsonl"), os.path.join(out_root, "answers.jsonl")
    with open(src, "w") as f:
        f.writelines(json.dumps(r) + "\n" for r in records)
    edge_max.launches = 0
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "mgnns_tpu_torch.cli.predict", "--from_exported", text_dir,
         "--image_backend", "synthetic", "--input", src, "--output", dst],
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True, text=True,
        timeout=600)
    cli_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise SystemExit(f"phase 7: cli.predict --from_exported failed:\n{proc.stderr[-3000:]}")
    with open(dst) as f:
        lines = [json.loads(line) for line in f]
    if [x["id"] for x in lines] != [r["id"] for r in records]:
        raise SystemExit("phase 7: cli.predict --from_exported answered other ids")
    diff = _check_answers("cli.predict --from_exported vs live", lines, text_want, 1e-5,
                          "phase 7")
    log(f"phase 7: cli.predict --from_exported (text-only) in a fresh process: {cli_s} s of "
        f"command, labels equal, probabilities max |diff| {diff} against the live Predictor "
        f"(tolerance 1e-5); K1 launches in this process {edge_max.launches}")

    # 4. the text-only model exported on the CPU, served on the card
    cpu_live = Predictor.from_engine_artifacts(root, text_ckpt, text_only=True,
                                               device="cpu", **common)
    cpu_pred, _ = _export_and_load(cpu_live, os.path.join(out_root, "text_cpu"),
                                   "text-only (exported on the CPU)", records[:16])
    diff = _check_answers("CPU-exported text-only vs the card's live", cpu_pred.predict(records),
                          text_want, 1e-5, "phase 7")
    log(f"phase 7: the CPU-exported text-only artifact on the card vs the live card Predictor: "
        f"max |diff| {diff} (tolerance 1e-5)")
    cpu_live.close()
    cpu_pred.close()
    text_live.close()

    # 5. cli.serve --from_exported, one HTTP round trip
    args = cli_serve.build_parser().parse_args([
        "--from_exported", fusion_dir, "--image_backend", "synthetic", "--port", "0"])
    t0 = time.perf_counter()
    server = cli_serve.make_server(args)
    start_s = time.perf_counter() - t0
    serving = threading.Thread(target=server.serve_forever, daemon=True)
    serving.start()
    host, port = server.server_address[:2]
    try:
        edge_max.launches = 0
        req = urllib.request.Request(
            f"http://{host}:{port}/predict", data=json.dumps({"records": records[:5]}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            body = json.loads(r.read())
        launches = edge_max.launches
        with urllib.request.urlopen(f"http://{host}:{port}/healthz", timeout=120) as r:
            health = json.loads(r.read())
        diff = _check_answers("HTTP /predict vs live", body["predictions"], want[:5], 1e-5,
                              "phase 7")
        log(f"phase 7: cli.serve --from_exported on {host}:{port} (loaded and warmed in "
            f"{start_s} s): POST /predict 200, 5 records, max |diff| {diff} against the live "
            f"Predictor, K1 launches {launches}; GET /healthz {health}")
        if launches != 1 or health.get("model") != fusion_dir or health.get("requests") != 1:
            raise SystemExit("phase 7: cli.serve --from_exported answered wrongly")
    finally:
        server.shutdown()
        server.server_close()
        server.frontend.predictor.close()
        serving.join(30)
    live.close()
    log(f"phase 7: K1 through the custom operator, per call back to back (phase 2): "
        f"{k1['ms'] * 1e3} us; "
        f"phase {time.perf_counter() - t_phase} s; {card_line()}")


# ------------------------------------------------------------------ phase 8

P8_TRAIN, P8_VAL = 64, 32
P8_CLI_FLAGS = ["--limit_samples", "32", "--epochs", "2", "-b", "16", "--compute_dtype",
                "bfloat16", "--device_text", "--device_images", "--cache_eval_batches"]


def _tree_error(got, want) -> float:
    """Max over leaves of max |got - want| / the leaf's scale."""
    return max(float((a.float() - b.float()).abs().max()) / max(float(b.float().abs().max()), 1e-12)
               for a, b in zip(tree_leaves(got), tree_leaves(want)))


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN's deterministic algorithms: its default float32 weight-gradient
    algorithm adds with atomics, so that two runs of the same steps differ."""
    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = before


def _profiled_epoch(run) -> dict:
    """Device busy time, kernel launches and K1 / K2 / NCCL launches of
    ``run()`` (an epoch), from the profiler's device events of its second
    call (:func:`mgnns_tpu_torch.tools._bench_util.device_events`)."""
    return device_events(run, {"k1": "edge_max_fwd_kernel", "k2": "edge_max_bwd_kernel",
                               "nccl": "nccl"})


def _phase8_dtype(setup: dict, workdir: str, dtype: str, mesh) -> dict:
    """Graph path, loop path and (phase 9b) the graph path of a 1-rank NCCL
    mesh engine from the same weights, in turns: losses and parameters
    compared, then timed and profiled."""
    cfg = dataclasses.replace(setup["cfg"], compute_dtype=dtype)
    vocab, graph, texts = setup["vocab"], setup["graph"], setup["texts"]
    r = np.random.default_rng(8)
    params, stats, consts = mgnns_init(
        cfg, num_edges=graph.num_edges,
        label_embedding=r.standard_normal((7, 300)).astype(np.float32),
        object_A=setup["object_A"], place_A=setup["place_A"],
        object_inp=r.standard_normal((80, 300)).astype(np.float32),
        place_inp=r.standard_normal((365, 300)).astype(np.float32), seed=8, device="cuda")
    data_cfg = DataConfig(data_root_path=workdir, image_backend="synthetic")
    train_ds = TumblrDataset(data_cfg, TextGraphConfig(), "train", vocab, graph,
                             image_size=cfg.image_size, train_transforms=True,
                             records=_records(texts, P8_TRAIN, 500, r))
    val_ds = TumblrDataset(data_cfg, TextGraphConfig(), "val", vocab, graph,
                           image_size=cfg.image_size, records=_records(texts, P8_VAL, 600, r))

    apply_fn = fusion_apply_fn(cfg, consts)
    steps = P8_TRAIN // TRAIN_BATCH
    kw = dict(num_classes=len(LABELS), steps_per_epoch=steps, aux_loss_weight=0.1, device="cuda")
    engines = {"graph": Engine(apply_fn, params, stats, **kw),
               "loop": Engine(apply_fn, tree_map(torch.clone, params), stats, **kw),
               "mesh": Engine(apply_fn, tree_map(torch.clone, params), stats, mesh=mesh, **kw)}

    def table_loaders():
        return (DeviceLoader(train_ds, TRAIN_BATCH, shuffle=True, seed=0, device_text=True,
                             device_images=True, device="cuda"),
                DeviceLoader(val_ds, TRAIN_BATCH, device_text=True, device_images=True,
                             device="cuda"))

    loaders = {
        "graph": table_loaders(), "mesh": table_loaders(),
        "loop": (DeviceLoader(train_ds, TRAIN_BATCH, shuffle=True, seed=0, device="cuda"),
                 DeviceLoader(val_ds, TRAIN_BATCH, device="cuda"))}
    res: dict = {"dtype": dtype}

    def compare(g: dict, lp: dict, key: str, a: str = "graph", b: str = "loop") -> None:
        res[key] = {
            "losses": {a: g["step_losses"], b: lp["step_losses"]},
            "loss_err": max(abs(x - y) / abs(y)
                            for x, y in zip(g["step_losses"], lp["step_losses"])),
            "param_err": _tree_error(engines[a].params, engines[b].params),
            "stats_err": _tree_error(engines[a].batch_stats, engines[b].batch_stats),
            "equal": g["step_losses"] == lp["step_losses"] and all(
                torch.equal(x, y) for x, y in zip(engines[a]._state_tensors(),
                                                  engines[b]._state_tensors()))}
        if not all(math.isfinite(v) for v in g["step_losses"] + lp["step_losses"]) \
                or g["skipped_steps"] or lp["skipped_steps"]:
            raise SystemExit(f"phase 8 {dtype}: a non-finite loss or a skipped step")

    # (a) one epoch of each path from the same weights, train and eval, with
    # cuDNN's deterministic algorithms set around the whole step as well (the
    # trunk convs' pin sets them since fault 3.4: a second witness)
    first: dict = {}
    with deterministic_cudnn():
        for path in ("graph", "loop", "mesh"):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            edge_max.launches = edge_max.bwd_launches = 0
            first[path] = engines[path].train_epoch(loaders[path][0])
            torch.cuda.synchronize()
            res[f"peak_bytes_{path}"] = torch.cuda.max_memory_allocated()
            if path != "loop":
                res[f"wrapper_calls_capture_{path}"] = (edge_max.launches, edge_max.bwd_launches)
        if not (first["graph"].get("fused") and first["mesh"].get("fused")
                and "fused" not in first["loop"]):
            raise SystemExit(f"phase 8 {dtype}: the table loader did not take the plan path")
        compare(first["graph"], first["loop"], "deterministic")
        compare(first["mesh"], first["graph"], "mesh_vs_graph", "mesh", "graph")
        ev = {k: engines[k].eval_epoch(loaders[k][1], collect_preds=True) for k in engines}
    res["capture_s"] = first["graph"]["capture_seconds"]
    res["mesh_capture_s"] = first["mesh"]["capture_seconds"]
    res["eval_capture_s"] = ev["graph"]["capture_seconds"]
    res["eval_preds_equal"] = bool(np.array_equal(ev["graph"]["preds"], ev["loop"]["preds"]))
    res["mesh_eval_preds_equal"] = bool(np.array_equal(ev["mesh"]["preds"], ev["graph"]["preds"]))
    res["eval_loss"] = {k: ev[k]["loss"] for k in ev}

    # (b) per-step wall time in turns under the library defaults (the trunk
    # convs' pin keeps cuDNN deterministic); the graphs are captured again
    # outside the context above, and the first turns start from the same
    # state, so they compare the paths once more
    engines["graph"]._graphs.clear()
    engines["mesh"]._graphs.clear()
    walls: dict = {"graph": [], "loop": [], "mesh": []}
    turns = {}
    for path in ("loop", "graph", "mesh", "mesh", "graph", "loop"):
        out = engines[path].train_epoch(loaders[path][0])
        walls[path].append(out["epoch_seconds"] / steps * 1e3)
        if path not in turns:
            turns[path] = out
            if path == "graph":
                compare(turns["graph"], turns["loop"], "default")
                res["recapture_s"] = turns["graph"]["capture_seconds"]
    eval_walls: dict = {"graph": [], "loop": [], "mesh": []}
    for path in ("loop", "graph", "mesh", "mesh", "graph", "loop"):
        out = engines[path].eval_epoch(loaders[path][1])
        eval_walls[path].append(out["epoch_seconds"] / len(loaders[path][1]) * 1e3)
    res["train_loop"] = {"wall_ms_per_step": statistics.median(walls["loop"]),
                         "walls": walls["loop"]}
    res["eval_loop"] = {"wall_ms_per_forward": statistics.median(eval_walls["loop"]),
                        "walls": eval_walls["loop"]}
    for path in ("graph", "mesh"):
        ld_train, ld_val = loaders[path]
        prof = _profiled_epoch(lambda e=engines[path], ld=ld_train: e.train_epoch(ld))
        wall = statistics.median(walls[path])
        res[f"train_{path}"] = {
            "wall_ms_per_step": wall, "walls": walls[path],
            "busy_ms_per_step": prof["busy_ms"] / steps,
            "idle_share": 1 - prof["busy_ms"] / steps / wall,
            "launches_per_step": prof["launches"] / steps,
            "nccl_per_step": prof["nccl"] / steps,
            "k1_per_step": prof["k1"] / steps, "k2_per_step": prof["k2"] / steps}
        nb = len(ld_val)
        prof = _profiled_epoch(lambda e=engines[path], ld=ld_val: e.eval_epoch(ld))
        wall = statistics.median(eval_walls[path])
        res[f"eval_{path}"] = {
            "wall_ms_per_forward": wall, "walls": eval_walls[path],
            "busy_ms_per_forward": prof["busy_ms"] / nb,
            "idle_share": 1 - prof["busy_ms"] / nb / wall,
            "launches_per_forward": prof["launches"] / nb,
            "nccl_per_forward": prof["nccl"] / nb, "k1_per_forward": prof["k1"] / nb}

    return res


def _one_rank_group():
    """A process group of this process alone over NCCL (phase 9b), joined as
    ``torchrun --nproc_per_node 1`` would describe it."""
    from mgnns_tpu_torch.parallel import multihost
    from mgnns_tpu_torch.parallel.mesh import create_mesh

    env = {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(_free_port()), "RANK": "0",
           "WORLD_SIZE": "1", "LOCAL_RANK": "0", "LOCAL_WORLD_SIZE": "1"}
    with mock.patch.dict(os.environ, env):
        if not multihost.initialize(device="cuda"):
            raise SystemExit("phase 9b: the 1-rank NCCL process group did not form")
    return create_mesh(1, device="cuda")


def phase8(setup: dict, root: str) -> None:
    """Device-resident training through captured steps, and phase 9b (see
    the module's docstring)."""
    import torch.distributed as dist

    t_phase = time.perf_counter()
    workdir = tempfile.mkdtemp(prefix="mgnns_graphs_")
    with open(os.path.join(workdir, "label.json"), "w") as f:
        json.dump(LABELS, f)
    mesh = _one_rank_group()
    log(f"phase 9b: a process group of 1 rank over {dist.get_backend()}; mesh "
        f"{mesh.mesh_dim_names} of shape {tuple(mesh.shape)}")
    failed = []  # checked after the CLI run, so that one call reports everything
    for dtype in ("float32", "bfloat16"):
        res = _phase8_dtype(setup, workdir, dtype, mesh)
        for mode in ("deterministic", "default"):
            c = res[mode]
            log(f"phase 8 {dtype}: graph path vs loop path, one epoch of 4 steps from the same "
                f"state at dropout 0.5, cuDNN {mode} algorithms around the step (the trunk "
                f"convs pin deterministic ones either way): bit-equal {c['equal']}; step losses "
                f"graph {c['losses']['graph']} loop {c['losses']['loop']}; max relative loss "
                f"difference {c['loss_err']}, parameters {c['param_err']} and BN statistics "
                f"{c['stats_err']} of each leaf's scale")
        log(f"phase 8 {dtype}: capture {res['capture_s']} s (train, deterministic cuDNN), "
            f"{res['recapture_s']} s (train, default), {res['eval_capture_s']} s (eval); "
            f"wrapper calls during capture (K1, K2) {res['wrapper_calls_capture_graph']}; peak "
            f"device memory graph epoch {res['peak_bytes_graph']} bytes, loop epoch "
            f"{res['peak_bytes_loop']} bytes; {card_line()}")
        log(f"phase 8 {dtype}: eval graph vs loop: predictions equal {res['eval_preds_equal']}, "
            f"loss {res['eval_loss']}")
        for key in ("train_graph", "train_loop", "eval_graph", "eval_loop"):
            log(f"phase 8 {dtype}: {key}: {res[key]}; {card_line()}")
        c = res["mesh_vs_graph"]
        log(f"phase 9b {dtype}: the 1-rank NCCL mesh engine's captured step vs phase 8's "
            f"captured step from the same state, one epoch of 4 steps: bit-equal {c['equal']}; "
            f"losses {c['losses']['mesh']} vs {c['losses']['graph']}; max relative loss "
            f"difference {c['loss_err']}, parameters {c['param_err']} and BN statistics "
            f"{c['stats_err']} of each leaf's scale; eval predictions equal "
            f"{res['mesh_eval_preds_equal']}, loss {res['eval_loss']['mesh']}")
        log(f"phase 9b {dtype}: capture {res['mesh_capture_s']} s (train); wrapper calls "
            f"during capture (K1, K2) {res['wrapper_calls_capture_mesh']}; peak device memory "
            f"of the mesh epoch {res['peak_bytes_mesh']} bytes (phase 8's graph epoch "
            f"{res['peak_bytes_graph']}); {card_line()}")
        for key in ("train_mesh", "eval_mesh"):
            log(f"phase 9b {dtype}: {key}: {res[key]} (beside phase 8's "
                f"{res[key.replace('mesh', 'graph')]}); {card_line()}")
        g = res["train_graph"]
        if not (g["k1_per_step"] == 1 and g["k2_per_step"] == 1
                and res["eval_graph"]["k1_per_forward"] == 1):
            failed.append(f"{dtype}: a replay did not launch K1 and K2 once each")
        c = res["deterministic"]
        if not (res["eval_preds_equal"] and c["loss_err"] <= 1e-6 and c["param_err"] <= 1e-6):
            failed.append(f"{dtype}: the graph path disagrees with the loop path")
        if not res["default"]["equal"]:
            failed.append(f"{dtype}: under the library defaults the graph and loop paths are "
                          "not bit-equal (fault 3.4)")
        m, c = res["train_mesh"], res["mesh_vs_graph"]
        if not (m["k1_per_step"] == 1 and m["k2_per_step"] == 1
                and res["eval_mesh"]["k1_per_forward"] == 1):
            failed.append(f"9b {dtype}: a mesh replay did not launch K1 and K2 once each")
        if not (res["mesh_eval_preds_equal"] and c["loss_err"] <= 1e-6 and c["param_err"] <= 1e-6
                and c["stats_err"] <= 1e-6):
            failed.append(f"9b {dtype}: the 1-rank mesh step disagrees with phase 8's step")

    # (c) the CLI with every table flag and a trace of the first epoch
    trace_dir = os.path.join(root, "trace")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = run_cli(root, "fusion_tables", P8_CLI_FLAGS + ["--profile_dir", trace_dir],
                      forwards=3 * 3, steps=3, phase="phase 8")
    text = buf.getvalue()
    log(text.rstrip())
    budget = [line for line in text.splitlines() if line.startswith("device_images:")]
    traces = [os.path.join(trace_dir, f) for f in os.listdir(trace_dir)
              if f.endswith(".pt.trace.json")]
    names = []
    for path in traces:
        with open(path) as f:
            names += [e.get("name", "") for e in json.load(f).get("traceEvents", [])
                      if e.get("cat") == "kernel"]
    k1 = sum("edge_max_fwd_kernel" in n for n in names)
    k2 = sum("edge_max_bwd_kernel" in n for n in names)
    fused = [h["train"].get("fused") and h["val"].get("fused") for h in res["history"]]
    log(f"phase 8: CLI with the table flags: budget line {budget}; trace files {traces}; kernel "
        f"events in the trace {len(names)}, K1 {k1}, K2 {k2} (2 warm-up steps and 2 replays); "
        f"epochs through captured steps {fused}")
    if budget != ["device_images: 3/3 split tables within 7.0 GB budget"] or not all(fused):
        raise SystemExit("phase 8: the CLI did not put every split in tables and replay them")
    if not (k1 >= 2 and k2 >= 2):
        raise SystemExit("phase 8: the first epoch's trace holds no K1 or K2 events")
    dist.destroy_process_group()
    log(f"phase 8 (with 9b): {time.perf_counter() - t_phase} s; {card_line()}")
    if failed:
        raise SystemExit("phase 8: " + "; ".join(failed))


# ------------------------------------------------------------------ phase 9

P9_STEPS, P9_RANKS = 4, 2


class _Split:
    """A split held in arrays, with what ``DeviceLoader`` reads of a
    ``TumblrDataset``; phase 9a's ranks load it from one file."""

    def __init__(self, arrays: dict):
        self.text = types.SimpleNamespace(**{k: arrays[k] for k in ("ids", "lens", "mask",
                                                                     "eids")})
        self.labels = arrays["label"]
        self.images = arrays["image"]
        self.image_size = self.images.shape[1]
        self.global_len = len(self.labels)
        self.record_offset = 0

    def __len__(self) -> int:
        return len(self.labels)

    def cacheable_images(self) -> bool:
        return True

    def load_image(self, i, rng=None) -> np.ndarray:
        return self.images[int(i)]


def _phase9_model(spec: dict):
    """(apply_fn, params, stats, consts, cfg) of phase 9a's full-width fusion
    model on the card, from the seed in ``spec``; every rank draws the same
    weights."""
    cfg = ModelConfig(vocab_size=spec["vocab_size"], edges_num=spec["num_edges"])
    params, stats, consts = mgnns_init(cfg, num_edges=spec["num_edges"], seed=9, device="cuda",
                                       **spec["inputs"])
    return fusion_apply_fn(cfg, consts), params, stats, consts, cfg


# Adam at lr 1e-7: its first update is the gradient's sign, so where a
# rounding difference flips the sign of a near-zero gradient element the
# parameter moves by 2 lr one way or the other; at 1e-7 that stays inside
# the 1e-4 of a leaf's scale that 2 ranks are held to, at the default 5e-5
# it would not (2 lr x 10 on the LSTM's ~0.08 weights)
P9_ENGINE = dict(num_classes=len(LABELS), lr=1e-7, steps_per_epoch=P9_STEPS,
                 aux_loss_weight=0.1, device="cuda")


def phase9_rank(workdir: str) -> None:
    """One rank of phase 9a, started by :func:`phase9a` with torchrun's
    environment: 4 train steps and an eval epoch of the full-width model on
    its rows of the global batch of 16, from device tables; the results go
    to ``<workdir>/rank<r>.pt``."""
    import torch.distributed as dist

    from mgnns_tpu_torch.parallel import multihost
    from mgnns_tpu_torch.parallel.input import make_input_plan
    from mgnns_tpu_torch.parallel.mesh import create_mesh

    spec = torch.load(os.path.join(workdir, "phase9.pt"), weights_only=False)
    rank = int(os.environ["RANK"])
    backend = spec["backend"]
    device = "cuda:0" if backend == "gloo" else f"cuda:{rank}"
    multihost.initialize(backend=backend, device=device)
    mesh = create_mesh(P9_RANKS, device="cuda")
    # bytes and calls of every all-reduce the step makes
    sent = {"bytes": 0, "calls": 0}
    all_reduce = dist.all_reduce

    def counted(t, *a, **kw):
        sent["bytes"] += t.numel() * t.element_size()
        sent["calls"] += 1
        return all_reduce(t, *a, **kw)

    dist.all_reduce = counted
    apply_fn, params, stats, _, _ = _phase9_model(spec)
    splits = {k: _Split(spec[k]) for k in ("train", "val")}
    plans = {k: make_input_plan(P9_RANKS, len(v), TRAIN_BATCH) for k, v in splits.items()}
    train_ld = DeviceLoader(splits["train"], plans["train"].Bd, shuffle=True, seed=0,
                            device_text=True, device_images=True, device="cuda",
                            plan=plans["train"])
    val_ld = DeviceLoader(splits["val"], plans["val"].Bd, device_text=True, device_images=True,
                          device="cuda", plan=plans["val"])
    eng = Engine(apply_fn, params, stats, mesh=mesh, **P9_ENGINE)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sent.update(bytes=0, calls=0)
    edge_max.launches = edge_max.bwd_launches = 0
    tr = eng.train_epoch(train_ld)
    torch.cuda.synchronize()
    out = {"rank": rank, "backend": backend, "losses": tr["step_losses"],
           "fused": bool(tr.get("fused")), "train_s": tr["epoch_seconds"],
           "sent": dict(sent), "k1_k2_train": (edge_max.launches, edge_max.bwd_launches),
           "peak_bytes": torch.cuda.max_memory_allocated(), "device": str(torch.cuda.current_device())}
    edge_max.launches = edge_max.bwd_launches = 0
    ev = eng.eval_epoch(val_ld, collect_preds=True)
    out.update(k1_eval=edge_max.launches, eval_loss=ev["loss"],
               preds=dict(zip(ev["sample_index"].tolist(), ev["preds"].tolist())),
               state=[t.detach().cpu() for t in tree_leaves(eng.params) + tree_leaves(eng.batch_stats)]
               if rank == 0 else None,
               checksum=float(sum(t.double().sum() for t in eng._state_tensors())))
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    dist.destroy_process_group()


def _phase9_spec(setup: dict, workdir: str, backend: str) -> dict:
    """64 train and 32 val records of phase 3's vocabulary at 448 px
    (synthetic pixels), encoded once here, and the model's seeded inputs."""
    vocab, graph, texts = setup["vocab"], setup["graph"], setup["texts"]
    r = np.random.default_rng(9)
    with open(os.path.join(workdir, "label.json"), "w") as f:
        json.dump(LABELS, f)
    data_cfg = DataConfig(data_root_path=workdir, image_backend="synthetic")
    spec = {"backend": backend, "vocab_size": len(vocab), "num_edges": graph.num_edges,
            "inputs": {"label_embedding": r.standard_normal((7, 300)).astype(np.float32),
                       "object_A": setup["object_A"], "place_A": setup["place_A"],
                       "object_inp": r.standard_normal((80, 300)).astype(np.float32),
                       "place_inp": r.standard_normal((365, 300)).astype(np.float32)}}
    for name, n, offset in (("train", N_TRAIN, 700), ("val", N_VAL, 800)):
        ds = TumblrDataset(data_cfg, TextGraphConfig(), name, vocab, graph, image_size=448,
                           records=_records(texts, n, offset, r))
        spec[name] = {"ids": ds.text.ids, "lens": ds.text.lens, "mask": ds.text.mask,
                      "eids": ds.text.eids, "label": ds.labels,
                      "image": np.stack([ds.load_image(i) for i in range(n)])}
    return spec


def _global_batches(arrays: dict, shuffle: bool):
    """Phase 9a's global batches of a split: its 2 ranks' loader rows,
    concatenated in rank order."""
    from mgnns_tpu_torch.parallel.input import make_input_plan

    split = _Split(arrays)
    lds = [DeviceLoader(split, TRAIN_BATCH // P9_RANKS, shuffle=shuffle, seed=0, device="cuda",
                        plan=make_input_plan(P9_RANKS, len(split), TRAIN_BATCH, position=p,
                                             process_index=0, process_count=1))
           for p in range(P9_RANKS)]
    for parts in zip(*lds):
        batch = {}
        for k in parts[0]:
            if k == "weight_total":
                continue
            vs = [b[k] for b in parts]
            batch[k] = (torch.cat(vs) if isinstance(vs[0], torch.Tensor)
                        else np.concatenate([np.atleast_1d(v) for v in vs]))
        yield batch


def _one_rank_reference(spec: dict) -> dict:
    """The 1-rank run of phase 9a's global batches on this card
    (:func:`_global_batches`), through ``Engine.train_step`` and
    ``eval_step`` (no mesh, float32 under the package's pin)."""
    apply_fn, params, stats, _, _ = _phase9_model(spec)
    eng = Engine(apply_fn, params, stats, **P9_ENGINE)
    out: dict = {"losses": [], "preds": {}}
    for name, shuffle in (("train", True), ("val", False)):
        cm = confusion_init(len(LABELS), "cuda")
        for batch in _global_batches(spec[name], shuffle):
            if name == "train":
                out["losses"].append(float(eng.train_step(batch, cm)))
            else:
                _, p = eng.eval_step(batch, cm)
                w = batch["weight"].astype(bool)
                out["preds"].update(zip(batch["sample_index"][w].tolist(),
                                        p.cpu().numpy()[w].tolist()))
    out["state"] = tree_leaves(eng.params) + tree_leaves(eng.batch_stats)
    out["paths"] = [f"params{p}" for p in tree_paths(eng.params)] + \
        [f"stats{p}" for p in tree_paths(eng.batch_stats)]
    out["trees"] = (eng.params, eng.batch_stats)
    return out


def _state_errors(got: list, want: list, paths: list) -> tuple[float, list]:
    """Max over leaves of max |got - want| / the leaf's scale, the scale
    floored at 1e-3 of the largest leaf's (tests/torch_train_common.
    compare_trees: a zero-initialized bias after a few steps at lr 1e-7 has a
    scale of ~1e-8, and one flipped Adam sign there is all of it), and the
    three worst leaves by their own scale."""
    scales = [max(float(b.float().abs().max()), 1e-30) for b in want]
    floor = 1e-3 * max(scales)
    errs = [float((a.float() - b.cpu().float()).abs().max()) for a, b in zip(got, want)]
    worst = sorted(zip((e / s for e, s in zip(errs, scales)), errs, scales, paths),
                   reverse=True)[:3]
    return max(e / max(s, floor) for e, s in zip(errs, scales)), worst


def _spawn_ranks(workdir: str, n: int, flag: str = "--phase9-rank") -> None:
    """Start ``n`` ranks of this script (``flag``) as torchrun would, wait for
    all, and fail if any fails or they outlast 600 s."""
    port = _free_port()
    procs = []
    for rank in range(n):
        env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(rank),
                   WORLD_SIZE=str(n), LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(n))
        procs.append(subprocess.Popen([sys.executable, os.path.abspath(__file__),
                                       flag, workdir], env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=600)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, text) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            log(text[-6000:])
            raise SystemExit(f"{flag}: rank {rank} exited with {p.returncode}")


def phase9a(setup: dict) -> dict:
    """Two ranks sharing the card over gloo (NCCL refuses two ranks on one
    device) against the 1-rank run of their global batches; with two cards
    or more, two ranks over NCCL too.  Returns what phase 10 reuses: the
    gloo run's spec, the 1-rank run and its all-reduce counts."""
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()  # the ranks share this card with this process
    runs = [("gloo", "2 ranks on cuda:0 over gloo")]
    reuse: dict = {}
    if torch.cuda.device_count() >= 2:
        runs.append(("nccl", "2 ranks on cuda:0 and cuda:1 over NCCL"))
    else:
        log(f"phase 9a: only one card seen (torch.cuda.device_count() = "
            f"{torch.cuda.device_count()}): the 2-rank NCCL run needs two and is not made")
    ref = None
    for backend, label in runs:
        workdir = tempfile.mkdtemp(prefix=f"mgnns_p9_{backend}_")
        spec = _phase9_spec(setup, workdir, backend)
        torch.save(spec, os.path.join(workdir, "phase9.pt"))
        t0 = time.perf_counter()
        _spawn_ranks(workdir, P9_RANKS)
        wall = time.perf_counter() - t0
        ranks = [torch.load(os.path.join(workdir, f"rank{r}.pt"), weights_only=False)
                 for r in range(P9_RANKS)]
        if ref is None:
            ref = _one_rank_reference(spec)
        if backend == "gloo":
            reuse.update(spec=spec, ref=ref, sent=ranks[0]["sent"], steps=len(ranks[0]["losses"]))
        got = ranks[0]
        preds = {k: v for rk in ranks for k, v in rk["preds"].items()}
        loss_err = max(abs(a - b) / abs(b) for a, b in zip(got["losses"], ref["losses"]))
        state_err, worst = _state_errors(got["state"], ref["state"], ref["paths"])
        steps = len(got["losses"])
        for rk in ranks:
            log(f"phase 9a ({label}): rank {rk['rank']} on cuda:{rk['device']}: step losses "
                f"{rk['losses']} (plan path {rk['fused']}); per step {rk['train_s'] / steps * 1e3} "
                f"ms of wall, {rk['sent']['bytes'] / steps} bytes all-reduced in "
                f"{rk['sent']['calls'] / steps} all-reduces; peak device memory "
                f"{rk['peak_bytes']} bytes; K1, K2 launches in {steps} train steps "
                f"{rk['k1_k2_train']}, K1 in 2 eval forwards "
                f"{rk['k1_eval']}; {card_line()}")
        log(f"phase 9a ({label}): against the 1-rank run of the global batches: losses "
            f"{ref['losses']}, max relative loss difference {loss_err}; parameters and BN "
            f"statistics within {state_err} of each leaf's scale (floored at 1e-3 of the "
            f"largest leaf's; by their own scale, the worst leaves (error/scale, error, scale, "
            f"leaf): {worst}); the ranks' states equal "
            f"{ranks[0]['checksum'] == ranks[1]['checksum']}; eval predictions equal "
            f"{preds == ref['preds']} ({len(preds)} records); {wall} s for the ranks")
        if not (all(rk["fused"] for rk in ranks) and ranks[0]["losses"] == ranks[1]["losses"]
                and ranks[0]["checksum"] == ranks[1]["checksum"]):
            raise SystemExit(f"phase 9a ({label}): the ranks did not run the plan path alike")
        if backend == "gloo" and not all(rk["k1_k2_train"] == (steps, steps)
                                         and rk["k1_eval"] == 2 for rk in ranks):
            raise SystemExit("phase 9a: a rank did not launch K1 and K2 once per forward "
                             "and backward")
        if not (loss_err <= 1e-5 and state_err <= 1e-4 and preds == ref["preds"]
                and len(preds) == N_VAL):
            raise SystemExit(f"phase 9a ({label}): 2 ranks disagree with 1 rank of the global "
                             "batch")
    log(f"phase 9a: {time.perf_counter() - t_phase} s; {card_line()}")
    return reuse


# ----------------------------------------------------------------- phase 10

P10_MODEL = 2
P10_SERVE = 16  # records of the served request


def _digest(t: torch.Tensor) -> str:
    import hashlib

    return hashlib.sha1(t.detach().contiguous().cpu().numpy().tobytes()).hexdigest()


def phase10_rank(workdir: str) -> None:
    """One rank of phase 10, started by :func:`phase10` with torchrun's
    environment: phase 9a's 4 train steps and eval batches (its global
    batches, :func:`_global_batches`) on a ``(data 1, model 2)`` mesh over
    gloo, each rank on the whole global batch of 16 with its shards of the
    parameters; a checkpoint; then a 16-record ``Predictor(mesh=...)``
    forward of the trained weights, and the HTTP front end on the mesh (rank
    0 serves, rank 1 follows).  The results go to ``<workdir>/rank<r>.pt``."""
    import torch.distributed as dist

    from mgnns_tpu_torch.graphs.pmi import PmiGraph
    from mgnns_tpu_torch.parallel import multihost
    from mgnns_tpu_torch.parallel.mesh import create_mesh
    from mgnns_tpu_torch.parallel.sharding import mgnns_param_rules

    spec = torch.load(os.path.join(workdir, "phase10.pt"), weights_only=False)
    rank = int(os.environ["RANK"])
    multihost.initialize(backend="gloo", device="cuda:0")
    mesh = create_mesh(1, P10_MODEL, device="cuda")
    model_group = mesh.get_group("model")
    # calls and bytes of every all-reduce, by axis
    sent = {"model": [0, 0], "other": [0, 0]}
    all_reduce = dist.all_reduce

    def counted(t, *a, **kw):
        key = "model" if kw.get("group") is model_group else "other"
        sent[key][0] += 1
        sent[key][1] += t.numel() * t.element_size()
        return all_reduce(t, *a, **kw)

    dist.all_reduce = counted
    apply_fn, params, stats, consts, cfg = _phase9_model(spec)
    eng = Engine(apply_fn, params, stats, mesh=mesh, param_sharding_rules=mgnns_param_rules(),
                 heads=cfg.n_head, checkpoint_dir=os.path.join(workdir, "ckpt"), **P9_ENGINE)
    del params
    # phase 9a's global batches, each step timed and its all-reduces and
    # launches counted (the device synchronized on each side)
    steps, losses = [], []
    cm = confusion_init(len(LABELS), "cuda")
    for batch in _global_batches(spec["train"], shuffle=True):
        torch.cuda.synchronize()
        before = [list(v) for v in sent.values()]
        edge_max.launches = edge_max.bwd_launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        losses.append(float(eng.train_step(batch, cm)))
        torch.cuda.synchronize()
        steps.append({"ms": (time.perf_counter() - t0) * 1e3,
                      "model_calls": sent["model"][0] - before[0][0],
                      "model_bytes": sent["model"][1] - before[0][1],
                      "other_calls": sent["other"][0] - before[1][0],
                      "other_bytes": sent["other"][1] - before[1][1],
                      "k1": edge_max.launches, "k2": edge_max.bwd_launches,
                      "peak_bytes": torch.cuda.max_memory_allocated()})
    out = {"rank": rank, "losses": losses, "steps": steps,
           "sharded": sorted(p for p, pl in eng.placements.items() if pl.dim is not None)}
    edge_max.launches = 0
    calls0 = sent["model"][0]
    preds: dict = {}
    ecm = confusion_init(len(LABELS), "cuda")
    for batch in _global_batches(spec["val"], shuffle=False):
        _, p = eng.eval_step(batch, ecm)
        w = batch["weight"].astype(bool)
        preds.update(zip(batch["sample_index"][w].tolist(), p.cpu().numpy()[w].tolist()))
    out.update(k1_eval=edge_max.launches, eval_model_calls=sent["model"][0] - calls0,
               preds=preds)
    # leaves the model axis replicates: their bits; the padding rows of the
    # gather tables (the last model rank's) zero in the parameters and moments
    paths = eng._paths()
    leaves = tree_leaves(eng.params)
    mu = dict(zip(eng.opt.trained, eng.opt_state["mu"]))
    nu = dict(zip(eng.opt.trained, eng.opt_state["nu"]))
    out["replicated"] = {p: _digest(t) for p, t in zip(paths, leaves)
                         if eng.placements[p].dim is None}
    out["replicated"].update({f"mu/{paths[i]}": _digest(t) for i, t in mu.items()
                              if eng.placements[paths[i]].dim is None})
    pads = {}
    for i, p in enumerate(paths):
        pl = eng.placements[p]
        if pl.dim == 0 and leaves[i].shape[0] * P10_MODEL > pl.shape[0]:
            n = leaves[i].shape[0]
            rows = torch.arange(rank * n, (rank + 1) * n, device=leaves[i].device) >= pl.shape[0]
            pads[p] = (int(rows.sum()), all(bool((t[rows] == 0).all())
                                            for t in (leaves[i], mu.get(i), nu.get(i))
                                            if t is not None))
    out["pads"] = pads
    t0 = time.perf_counter()
    eng.save()
    out["save_s"] = time.perf_counter() - t0
    out["step"] = eng.step
    whole = eng.full_params()
    if rank == 0:
        out["state"] = [t.detach().cpu() for t in tree_leaves(whole) + tree_leaves(eng.batch_stats)]
    # serving: the trained weights on the mesh, every rank the same records
    g = spec["graph"]
    pred = Predictor(vocab=spec["vocab"], graph=PmiGraph(g["vocab_size"], g["keys"], g["pmi"]),
                     graph_cfg=TextGraphConfig(), label_map=LABELS, params=whole,
                     batch_stats=eng.batch_stats, consts=consts, cfg=cfg,
                     image_backend="synthetic", max_batch=TRAIN_BATCH, device="cuda", mesh=mesh)
    del whole
    edge_max.launches = 0
    calls0 = sent["model"][0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    served = pred.predict(spec["serve"])
    out.update(serve_ms=(time.perf_counter() - t0) * 1e3, served=served,
               k1_serve=edge_max.launches, serve_model_calls=sent["model"][0] - calls0,
               buckets=pred.batch_buckets)
    # HTTP on the mesh: rank 0's front end hands each chunk to rank 1, which
    # follows until rank 0's server shuts down; first the same records
    # through predict on both ranks (SPMD), the mesh's own answers
    from mgnns_tpu_torch.serving import MeshLink

    out["http_in_process"] = pred.predict([r for recs in spec["http"].values() for r in recs])
    link = MeshLink(pred)
    edge_max.launches = 0
    if link.leader:
        out["http"] = _phase10_http(pred, link, spec["http"])
    else:
        t0 = time.perf_counter()
        out["follow_chunks"] = link.follow()
        out["follow_s"] = time.perf_counter() - t0
    out.update(k1_http=edge_max.launches, http_chunks=link.chunks, http_headers=link.headers)
    pred.close()
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    dist.destroy_process_group()


def _phase10_http(pred: Predictor, link, requests: dict) -> dict:
    """Rank 0 of phase 10: ``cli.serve``'s server and frontend around the
    mesh Predictor and its link on loopback, 8 clients sending their 2
    requests each at once, then ``shutdown()``, which sends rank 1 the stop
    (bounded by a 120 s join)."""
    import threading
    import urllib.request

    from mgnns_tpu_torch.cli import serve as cli_serve

    args = cli_serve.build_parser().parse_args([
        "--port", "0", "--image_backend", "synthetic", "--max_batch", str(pred.max_batch),
        "--request_timeout", "300"])
    server = cli_serve.make_server(args, pred, link)
    serving = threading.Thread(target=server.serve_forever, daemon=True)
    serving.start()
    host, port = server.server_address[:2]
    answers: dict = {}
    errors: list = []

    def client(c):
        try:
            for k in range(2):
                req = urllib.request.Request(
                    f"http://{host}:{port}/predict", method="POST",
                    data=json.dumps({"records": requests[(c, k)]}).encode(),
                    headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=300) as r:
                    answers[(c, k)] = json.loads(r.read())["predictions"]
        except Exception as e:  # reported by the parent; the phase fails on it
            errors.append(repr(e))

    t0 = time.perf_counter()
    clients = [threading.Thread(target=client, args=(c,)) for c in range(8)]
    for t in clients:
        t.start()
    for t in clients:
        t.join(600)
    wall = time.perf_counter() - t0
    stats = server.frontend.stats()
    t0 = time.perf_counter()
    server.shutdown()  # the frontend closes: rank 1 gets the stop header
    serving.join(120)
    stop_s = time.perf_counter() - t0
    server.server_close()
    if serving.is_alive() or any(t.is_alive() for t in clients):
        errors.append("the server or a client did not finish")
    return {"answers": answers, "errors": errors, "wall": wall, "stats": stats,
            "stop_s": stop_s, "payload_bytes": list(link.payload_bytes)}


def phase10(setup: dict, p9: dict) -> None:
    """The model axis: 2 gloo ranks sharing the card on a ``(data 1, model
    2)`` mesh run phase 9a's spec, held to phase 9a's own 1-rank run of the
    same global batches, and serve its trained weights."""
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    spec, ref = p9["spec"], p9["ref"]
    vocab, graph, texts = setup["vocab"], setup["graph"], setup["texts"]
    records = _records(texts, P10_SERVE, 900, np.random.default_rng(10))
    # 8 clients x 2 requests of 1-5 records for the mesh's HTTP front end
    http = {(c, k): _records(texts, 1 + (c + 3 * k) % 5, 1000 + 10 * (2 * c + k),
                             np.random.default_rng(11))
            for c in range(8) for k in range(2)}
    workdir = tempfile.mkdtemp(prefix="mgnns_p10_")
    torch.save(dict(spec, vocab=vocab, serve=records, http=http,
                    graph={"vocab_size": graph.vocab_size, "keys": graph.keys,
                           "pmi": graph.pmi}), os.path.join(workdir, "phase10.pt"))
    t0 = time.perf_counter()
    _spawn_ranks(workdir, P10_MODEL, "--phase10-rank")
    wall = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(workdir, f"rank{r}.pt"), weights_only=False)
             for r in range(P10_MODEL)]
    got = ranks[0]
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(got["losses"], ref["losses"]))
    state_err, worst = _state_errors(got["state"], ref["state"], ref["paths"])
    eval_equal = all(rk["preds"] == ref["preds"] for rk in ranks)
    replicated_equal = ranks[0]["replicated"] == ranks[1]["replicated"]
    # the checkpoint: whole leaves of the 1-rank run's shapes
    raw = torch.load(os.path.join(workdir, "ckpt", f"step_{got['step']}.pt"), map_location="cpu",
                     weights_only=False)
    ckpt_shapes = [tuple(t.shape) for t in tree_leaves(raw["params"])]
    ref_params, ref_stats = ref["trees"]
    ckpt_ok = ckpt_shapes == [tuple(t.shape) for t in tree_leaves(ref_params)]
    pads = {p: v for rk in ranks for p, v in rk["pads"].items()}
    del raw
    # the same request served by one device from the 1-rank run's weights
    _, _, _, consts, cfg = _phase9_model(spec)
    one = Predictor(vocab=vocab, graph=graph, graph_cfg=TextGraphConfig(), label_map=LABELS,
                    params=ref_params, batch_stats=ref_stats, consts=consts, cfg=cfg,
                    image_backend="synthetic", max_batch=TRAIN_BATCH, device="cuda")
    want = one.predict(records)
    http_records = [r for recs in http.values() for r in recs]
    http_want = one.predict(http_records)
    one.close()
    labels_equal = all([g["label"] for g in rk["served"]] == [w["label"] for w in want]
                       for rk in ranks)
    prob_err = max(abs(g["probs"][k] - w["probs"][k]) for rk in ranks
                   for g, w in zip(rk["served"], want) for k in w["probs"])
    n9 = p9["steps"]
    for rk in ranks:
        for i, st in enumerate(rk["steps"]):
            log(f"phase 10 (2 ranks on cuda:0 over gloo, mesh data 1 x model 2): rank "
                f"{rk['rank']} step {i}: {st['ms']} ms of wall; model axis {st['model_calls']} "
                f"all-reduces, {st['model_bytes']} bytes; other all-reduces (the data axis, "
                f"a group of one rank) {st['other_calls']}, {st['other_bytes']} bytes (phase "
                f"9a, data 2: {p9['sent']['calls'] / n9} all-reduces, {p9['sent']['bytes'] / n9} "
                f"bytes a step); peak device memory {st['peak_bytes']} bytes; K1, K2 launches "
                f"{st['k1']}, {st['k2']}; {card_line()}")
        log(f"phase 10: rank {rk['rank']}: step losses {rk['losses']}; eval: K1 {rk['k1_eval']} launches in 2 forwards, {rk['eval_model_calls']} model-axis "
            f"all-reduces; checkpoint save {rk['save_s']} s; served {P10_SERVE} records in "
            f"{rk['serve_ms']} ms (buckets {rk['buckets']}), K1 {rk['k1_serve']} launches, "
            f"{rk['serve_model_calls']} model-axis all-reduces; {len(rk['sharded'])} sharded "
            f"leaves; padding rows (rows, zero) {rk['pads']}")
    log(f"phase 10: against phase 9a's 1-rank run of the global batches: losses {ref['losses']}, "
        f"max relative loss difference {loss_err}; parameters and BN statistics within "
        f"{state_err} of each leaf's scale (floored at 1e-3 of the largest leaf's; worst leaves "
        f"by their own scale (error/scale, error, scale, leaf): {worst}); eval predictions equal "
        f"{eval_equal}; served labels equal {labels_equal}, max probability difference "
        f"{prob_err}; replicated leaves bit-equal across the ranks {replicated_equal}; "
        f"checkpoint leaves of the 1-rank shapes {ckpt_ok}; {wall} s for the ranks")
    steps = len(got["losses"])
    if ranks[0]["losses"] != ranks[1]["losses"]:
        raise SystemExit("phase 10: the ranks' losses differ")
    if not all([(st["k1"], st["k2"]) for st in rk["steps"]] == [(1, 1)] * steps
               and rk["k1_eval"] == 2 and rk["k1_serve"] == 1 for rk in ranks):
        raise SystemExit("phase 10: a rank did not launch K1 once per forward and K2 once per "
                         "train step")
    if not (loss_err <= 1e-5 and state_err <= 1e-4 and eval_equal and labels_equal
            and prob_err <= 1e-5 and replicated_equal and ckpt_ok and pads
            and all(zero for _, zero in pads.values())):
        raise SystemExit("phase 10: the model axis disagrees with 1 rank")
    phase10_http_checks(ranks, http, http_want)
    log(f"phase 10: {time.perf_counter() - t_phase} s; {card_line()}")


def phase10_http_checks(ranks: list, http: dict, want: list) -> None:
    """Phase 10's HTTP front end on the mesh: rank 0's answers against its
    in-process ``Predictor(mesh=...).predict`` of the same records and one
    device's (labels equal, probabilities within 1e-5), K1 once a chunk on
    each rank, rank 1 following every chunk and stopped."""
    lead, follower = ranks
    h = lead["http"]
    if h["errors"] or len(h["answers"]) != len(http):
        raise SystemExit(f"phase 10: the mesh's HTTP clients failed: {h['errors']}")
    got = [a for key in http for a in h["answers"][key]]
    errs = {}
    for name, ref in (("in-process mesh predict", lead["http_in_process"]),
                      ("one device", want)):
        if [g["label"] for g in got] != [w["label"] for w in ref]:
            raise SystemExit(f"phase 10: HTTP labels on the mesh differ from the {name}'s")
        errs[name] = max(abs(g["probs"][k] - w["probs"][k]) for g, w in zip(got, ref)
                         for k in w["probs"])
    chunks = lead["http_chunks"]
    per_chunk = [rk["k1_http"] / max(1, rk["http_chunks"]) for rk in ranks]
    log(f"phase 10: cli.serve's front end on the (1, 2) mesh over loopback: 8 clients x 2 "
        f"requests ({len(got)} records) in {h['wall']} s; latency ms {h['stats'].get('latency_ms')} "
        f"(p50/p99/max); {chunks} chunks, {lead['http_headers']} headers sent (the stop "
        f"included), payload bytes a chunk {h['payload_bytes']}; rank 1 followed "
        f"{follower['follow_chunks']} chunks and stopped {h['stop_s']} s after shutdown() "
        f"(in follow() {follower['follow_s']} s); K1 launches a chunk {per_chunk} (ranks 0, 1); "
        f"answers against the in-process mesh predict and one device: labels equal, max "
        f"probability difference {errs} (tolerance 1e-5); {card_line()}")
    if not (follower["follow_chunks"] == chunks >= 1 and lead["http_headers"] == chunks + 1
            and per_chunk == [1.0, 1.0] and max(errs.values()) <= 1e-5):
        raise SystemExit("phase 10: the mesh's HTTP front end disagrees or its ranks fell "
                         "out of step")


def phase9c(root: str) -> None:
    """The training CLI under ``torchrun --nproc_per_node 1`` with
    ``--multihost --mesh_data 1`` and phase 8's table flags, whose prediction
    file must equal phase 8's non-distributed run's."""
    t_phase = time.perf_counter()
    runs = [(1, "fusion_tables_torchrun")]
    if torch.cuda.device_count() >= 2:
        runs.append((2, "fusion_tables_torchrun2"))
    else:
        log("phase 9c: only one card seen: the 2-rank NCCL CLI run needs two and is not made")
    want = _pred_rows(os.path.join(root, "fusion_tables"))
    for nproc, name in runs:
        out = os.path.join(root, name)
        cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", str(nproc),
               "--master_port", str(_free_port()), "-m", "mgnns_tpu_torch.cli.main",
               "--multihost", "--mesh_data", str(nproc), "--data_root_path", root,
               "--num_labels", "3", "--text_min_count", "1", "-e",
               "--save_model_path", os.path.join(out, "ckpt"),
               "--save_experiment_result_path", os.path.join(out, "exp"),
               "--save_pred_result_path", os.path.join(out, "pred")] + P8_CLI_FLAGS
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            log(proc.stdout[-4000:] + proc.stderr[-6000:])
            raise SystemExit(f"phase 9c: torchrun --nproc_per_node {nproc} exited with "
                             f"{proc.returncode}")
        got = _pred_rows(out)
        epochs = [line for line in proc.stdout.splitlines() if line.startswith("epoch ")]
        log(f"phase 9c: {' '.join(cmd[1:])}: {wall} s; {epochs}; prediction file of "
            f"{len(got) - 1} records, equal to the non-distributed run's (phase 8) "
            f"{got == want}; {card_line()}")
        if nproc == 1 and got != want:
            raise SystemExit("phase 9c: the 1-rank torchrun CLI's predictions differ from the "
                             "non-distributed run's")
        if nproc > 1 and sorted(row.split("\t")[0] for row in got) != \
                sorted(row.split("\t")[0] for row in want):
            # 2 ranks shuffle by the input plan, so their training differs from
            # 1 rank's: every record must be there, once
            raise SystemExit("phase 9c: the 2-rank CLI's prediction file misses records")
    log(f"phase 9c: {time.perf_counter() - t_phase} s; {card_line()}")


# ----------------------------------------------------------------- phase 12

P12_SAMPLES = 64
P12_ENV = {"WB_BATCH": "32", "FSE_BATCH": "32", "EVAL_LADDER": "32,64", "WB_PIPELINED": "0",
           "MGNNS_COLD": "0"}


def phase12() -> dict:
    """The entry surface (``mgnns_tpu_torch.entry``) and the last measuring
    tools at a small size (see the module's docstring).  Returns the K1 and
    K2 wrapper counts of each path."""
    from mgnns_tpu_torch import entry
    from mgnns_tpu_torch.tools import (
        _bench_util, eval_batch_ladder, full_split_fused_eval, warmup_breakdown,
    )

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()  # the dry run's ranks share this card with this process
    fn, args = entry.entry()
    edge_max.launches = 0
    logits = fn(*args)
    torch.cuda.synchronize()
    k1_entry = edge_max.launches
    with mock.patch.object(edge_max, "_launch", edge_max.window_max_aggregate_plain):
        plain = fn(*args)
    err = float((logits - plain).abs().max() / plain.abs().max().clamp_min(1e-30))
    log(f"phase 12: entry() on cuda:0: logits {tuple(logits.shape)} {logits.dtype} "
        f"{logits.float().cpu().numpy().tolist()}; against K1's plain version {err} of scale; "
        f"K1 launches in the forward {k1_entry}")
    if not (tuple(logits.shape) == (2, 7) and bool(torch.isfinite(logits).all())
            and err <= 1e-5 and k1_entry == 1):
        raise SystemExit("phase 12: entry()'s forward failed its checks")
    del fn, args, logits, plain
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    dry = entry.dryrun_multichip(2)
    shown = {k: dry[k] for k in ("losses", "parity", "eval", "checkpoint", "bf16", "launches")}
    log(f"phase 12: dryrun_multichip(2), 2 gloo ranks on cuda:0, {time.perf_counter() - t0} s: "
        f"{json.dumps(shown)}")
    if not all(r["k1"] > 0 and r["k2"] > 0 for r in dry["launches"]):
        raise SystemExit("phase 12: a dry-run rank launched no K1 or no K2")

    data = _bench_util.flagship_data("synthetic", n_records=P12_SAMPLES)
    tools = {}
    with tempfile.TemporaryDirectory(prefix="mgnns_p12_") as results, \
            mock.patch.dict(os.environ, P12_ENV), \
            mock.patch.object(_bench_util, "RESULTS_DIR", results):
        for name, tool in (("warmup_breakdown", warmup_breakdown),
                           ("full_split_fused_eval", full_split_fused_eval),
                           ("eval_batch_ladder", eval_batch_ladder)):
            t0 = time.perf_counter()
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                out = tool.main([], data=data)
            printed = buf.getvalue().splitlines()
            log(f"phase 12: {name} ({time.perf_counter() - t0} s): {printed[-1]}")
            if json.loads(printed[-1]) != out:
                raise SystemExit(f"phase 12: {name} printed another line than it returned")
            tools[name] = out
    wb, fse, lad = (tools[k] for k in ("warmup_breakdown", "full_split_fused_eval",
                                       "eval_batch_ladder"))
    problems = [
        not (wb["fused"] and wb["samples_per_sec"] > 0 and wb["upload_mb_per_s"] > 0
             and wb["h2d_probe_mb_per_s"] > 0 and wb["n_samples"] == P12_SAMPLES
             and wb["launches"]["k1"] > 0),
        not (fse["fused"] and fse["first_epoch_fused"] and fse["samples_per_sec"] > 0
             and fse["n_samples"] == P12_SAMPLES and fse["launches"]["k1"] > 0),
        not ([r["batch"] for r in lad["rungs"]] == [32, 64]
             and all(r.get("samples_per_sec", 0) > 0 and 0 < r["pct_of_peak"] <= 105
                     for r in lad["rungs"]) and lad["launches"]["k1"] > 0),
    ]
    log(f"phase 12: {time.perf_counter() - t_phase} s; {card_line()}")
    if any(problems):
        raise SystemExit(f"phase 12: tool checks {[i for i, p in enumerate(problems) if p]} "
                         "failed")
    return {"entry": {"k1": k1_entry},
            "dryrun_multichip(2) ranks": [{"k1": r["k1"], "k2": r["k2"]}
                                          for r in dry["launches"]],
            "tools": {k: v["launches"]["k1"] for k, v in tools.items()}}


def _pred_rows(out: str) -> list[str]:
    files = [os.path.join(d, f) for d, _, fs in os.walk(os.path.join(out, "pred")) for f in fs]
    if len(files) != 1:
        raise SystemExit(f"phase 9c: expected one prediction file under {out}, got {files}")
    with open(files[0]) as f:
        return f.read().splitlines()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this test needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    name = torch.cuda.get_device_name(0)
    log(f"phase 0: {card_line()}; torch {torch.__version__} CUDA {torch.version.cuda}")
    log(f"phase 0: torch's global flags, left as found: torch.backends.cudnn.allow_tf32="
        f"{torch.backends.cudnn.allow_tf32} torch.backends.cudnn.conv.fp32_precision="
        f"{torch.backends.cudnn.conv.fp32_precision!r} torch.backends.cuda.matmul.allow_tf32="
        f"{torch.backends.cuda.matmul.allow_tf32} float32 matmul precision "
        f"{torch.get_float32_matmul_precision()!r}; the package pins "
        f"torch.backends.cudnn.conv.fp32_precision='ieee' inside each float32 trunk conv, "
        f"forward and backward (mgnns_tpu_torch/nn/resnet.py: ieee_float32_convs)")

    t0 = time.perf_counter()
    libs = build.build_all()
    log(f"phase 1: built {sorted(libs)} in {time.perf_counter() - t0} s")
    for lib in libs.values():
        log(lib.log.strip())
    # K1's chain and K2's register rings must stay in registers at the model's
    # window (g=4), the BiLSTM kernels' tiles, and the optimizer kernels'
    # tables in their parameters; the log is the one kept
    # beside the library, built in this run or before
    for kernel, lib, mangled in (("K1", "edge_max", K1_PTXAS_NAME),
                                 ("K2", "edge_max", K2_PTXAS_NAME),
                                 ("LSTM forward", "lstm", "mgnns_lstm_fwd_kernel"),
                                 ("LSTM backward", "lstm", "mgnns_lstm_bwd_kernel"),
                                 ("Adam update", "adam", "mgnns_adam_update_kernelILb1E"),
                                 ("SGD update", "adam", "mgnns_adam_update_kernelILb0E"),
                                 ("norm", "adam", "mgnns_adam_sumsq_kernel"),
                                 ("norm's finish", "adam", "mgnns_adam_sumsq_finish_kernel"),
                                 ("guarded copy", "adam", "mgnns_adam_select_kernel")):
        report = ptxas_report(libs[lib].log, mangled)
        local = local_memory_bytes(report)
        log(f"phase 1: ptxas, {kernel}: {' | '.join(report.splitlines())}")
        if any(local):
            raise SystemExit(f"phase 1: {kernel} uses local memory (stack, spill "
                             f"stores, spill loads: {local} bytes)")

    k1 = phase2_k1()
    k2 = phase2b_k2()
    phase2c_lstm()
    phase2d_adam()
    setup = phase3(k1)
    p4 = phase4(setup, k1, k2)
    phase4b(p4)
    root = phase5()
    phase6(root)
    phase7(root, k1)
    phase8(setup, root)
    p9 = phase9a(setup)
    phase9c(root)
    phase10(setup, p9)
    p12 = phase12()

    log(f"total {time.perf_counter() - t_start} s")
    log(card_line())
    k1["paths"] = ["serving.Predictor", "engine.train.Engine", "cli.main (text-only, fusion)",
                   "serving.Predictor.from_engine_artifacts", "cli.predict",
                   "serving.BatchingFrontend", "cli.serve", "cli.main --init_from_reference",
                   "export.load_exported", "cli.predict --from_exported",
                   "cli.serve --from_exported",
                   "engine.graphs (captured train and eval steps over device tables)",
                   "cli.main --device_text --device_images",
                   "Engine(mesh=...) on 2 ranks over gloo, each rank's forward",
                   "Engine(mesh=...) on 1 rank over NCCL, captured train and eval steps",
                   "torchrun cli.main --multihost --mesh_data 1",
                   "Engine(mesh=...) on a (1, 2) model axis over gloo, each rank's forward",
                   "Predictor(mesh=...) on a (1, 2) model axis",
                   "cli.serve.make_server on a (1, 2) model axis (rank 0's front end and "
                   "MeshLink, 2 gloo ranks)",
                   "entry.entry (the flagship forward at production shapes)",
                   "entry.dryrun_multichip (2 gloo ranks on cuda:0, each rank's forwards)",
                   "tools.full_split_fused_eval, tools.eval_batch_ladder, "
                   "tools.warmup_breakdown (captured eval over tables)"]
    k2["paths"] = ["engine.train.Engine.train_step", "cli.main (text-only, fusion)",
                   "cli.main --init_from_reference",
                   "engine.graphs (captured train steps over device tables)",
                   "cli.main --device_text --device_images",
                   "Engine(mesh=...) on 2 ranks over gloo, each rank's backward",
                   "Engine(mesh=...) on 1 rank over NCCL, captured train steps",
                   "torchrun cli.main --multihost --mesh_data 1",
                   "Engine(mesh=...) on a (1, 2) model axis over gloo, each rank's backward",
                   "entry.dryrun_multichip (2 gloo ranks on cuda:0, each rank's train steps)"]
    # phase 12's paths, each counted from 0 (replays of a captured step are
    # not counted by the wrappers)
    k1["launches_phase12"] = p12
    k2["launches_phase12"] = {"dryrun_multichip(2) ranks": [r["k2"] for r in
                                                            p12["dryrun_multichip(2) ranks"]]}
    print(json.dumps({"kernels": [k1, k2]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--phase9-rank"]:
        phase9_rank(sys.argv[2])
        sys.exit(0)
    if sys.argv[1:2] == ["--phase10-rank"]:
        phase10_rank(sys.argv[2])
        sys.exit(0)
    sys.exit(main())
