"""Eval epochs: ``Engine.eval_epoch(collect_preds=True)`` over a split held
in device tables, one captured eval step replayed per batch, epoch after
epoch: the eval pass of training, and offline scoring of an archive.

Set-up draws the weights, calibrates the trunks' running statistics on a
batch of the split's own images (see ``benchmark.weights.calibrate``),
builds the split and captures the step with one epoch.  The window runs
whole epochs until ``seconds`` have passed.  Once it has closed and the
program is freed, the reference scores a seeded sample of the split's
records, the longest texts among them, and ``logit_gap`` reads by how much
its best logit exceeds its logit of the class the program predicted, at
the worst record of the sample.
"""

from __future__ import annotations

import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from benchmark import compare as C
from benchmark import data as D
from benchmark import harness as H
from benchmark import program as P
from benchmark import trace as TR
from benchmark import weights as W
from benchmark.reference import model as R
from benchmark.reference import text as T


def reference_logits(cfg, wl, params, stats, consts, recs, vocab, keys, device,
                     quantize=False) -> np.ndarray:
    dtype = getattr(torch, wl["compute_dtype"])
    out = []
    with torch.no_grad(), R.precision(False), ThreadPoolExecutor(8) as pool:
        for s in range(0, len(recs), wl["batch"]):
            part = recs[s:s + wl["batch"]]
            enc = T.encode([r["text"] for r in part], vocab, keys, cfg["max_len"], cfg["ngram"])
            enc["image"] = np.stack(list(pool.map(
                lambda r: T.synthetic_pixels(r["id"], cfg["image_size"]), part)))
            batch = {k: torch.as_tensor(v, device=device) for k, v in enc.items()}
            logits, _ = R.fusion_forward(params, stats, consts, batch, cfg, dtype=dtype,
                                         quantize=quantize)
            out.append(logits.float().cpu().numpy())
    return np.concatenate(out)


def sample(recs: list[dict], n: int, seed: int) -> np.ndarray:
    """``n`` record indices drawn from the seed, the longest text first."""
    longest = int(np.argmax([r["text"].count(" ") for r in recs]))
    rest = D.rng(seed, 6).permutation([i for i in range(len(recs)) if i != longest])
    return np.concatenate([[longest], rest[:n - 1]]).astype(int)


def run(cell: H.Cell, t_start: float) -> H.Outcome:
    from mgnns_tpu_torch.engine.train import Engine

    cfg, wl, dev = cell.config, cell.params, cell.device
    phases = H.Phases(t_start)
    B, N = wl["batch"], wl["records"]
    vocab, _, keys, pmi = D.text_side(cfg)
    phases.mark("imports, corpus and PMI graph")
    E = len(keys) + 1
    recs = D.records(cfg, N, cell.seed)
    params, stats, consts = W.fusion_weights(cfg, E, D.constants(cfg, cell.seed),
                                             cell.seed % 2 ** 63, dev)
    calib = np.stack([T.synthetic_pixels(r["id"], cfg["image_size"])
                      for r in recs[:wl["calibration_images"]]])
    W.calibrate(params, stats, torch.as_tensor(calib, device=dev),
                getattr(torch, wl["compute_dtype"]))
    phases.mark("weights and calibration")
    # the reference's copy waits on the host, out of the program's memory
    host = [R.unflatten(t, [x.cpu() for x in R.leaves(t)]) for t in (params, stats)]
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    eng = Engine(P.fusion_apply(P.model_config(cfg, wl, E), consts), params, stats,
                 num_classes=cfg["num_labels"], eval_only=True, device=dev)
    parts = [recs]
    if cell.trace:  # a short split of its own keeps the traced events few
        parts.append(recs[:wl["trace_batches"] * B])
    with tempfile.TemporaryDirectory() as root:
        D.write_label_map(root, cfg)
        splits = [P.dataset(cfg, r, vocab, P.pmi_graph(vocab, keys, pmi), root) for r in parts]
    loaders = [P.loader(ds, B, dev) for ds in splits]
    phases.mark("engine and splits")
    for loader in loaders:
        eng.eval_epoch(loader, collect_preds=True)  # builds the tables, captures the step
    phases.mark("tables and capture")
    phases.done()

    H.settle()
    setup_s = time.perf_counter() - t_start
    samples = 0
    wall = 0.0
    traced = None
    if cell.trace:  # the traced stretch first; the counters read the epochs after it
        with TR.Traced(TR.MARGIN_S) as traced:
            eng.eval_epoch(loaders[1], collect_preds=True)
    while wall < cell.seconds:
        t0 = time.perf_counter()
        last = eng.eval_epoch(loaders[0], collect_preds=True)
        wall += time.perf_counter() - t0
        samples += N
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    lens = splits[-1].text.lens.copy()
    preds = np.zeros(N, np.int64)
    preds[np.asarray(last["sample_index"])] = np.asarray(last["preds"])
    del eng, loaders, splits, params, stats
    H.free_device()
    params, stats = (R.unflatten(t, [x.to(dev) for x in R.leaves(t)]) for t in host)

    idx = sample(recs, min(wl["reference_sample"], N), cell.seed)
    picked = [recs[i] for i in idx]
    ref = reference_logits(cfg, wl, params, stats, consts, picked, vocab, keys, dev)
    checks = [H.Check("logit_gap", C.logit_gap(ref, preds[idx]), wl["limits"]["logit_gap"])]
    counters = {"samples": samples, "window_s": wall, "batch": B, "lens": lens}
    if "control" in wl.get("variants", []):
        low = reference_logits(cfg, wl, params, stats, consts, picked, vocab, keys, dev, True)
        counters["control"] = [H.Check("control.logit_gap", C.logit_gap(ref, low.argmax(1)),
                                       wl["limits"]["logit_gap"])]
    return H.Outcome(end_to_end={"eval_samples_per_s": samples / wall, "setup_s": setup_s},
                     attempted=samples, failed=0, checks=checks, counters=counters,
                     trace=traced.trace if traced else None, memory_peak_bytes=peak)
