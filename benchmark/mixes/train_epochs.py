"""Training epochs: ``Engine.train_epoch`` over a split held in device
tables, one captured step replayed per batch, epoch after epoch.

Set-up builds one engine from the seed's weights and drives it through its
first three steps with the window's own call and feed: one epoch over a
split of the first batch's records, one over the next two batches'.  It
keeps the loss of each, the first gradient as the optimizer got it (its
first moment after one step, over ``1 - beta1``), and each leaf's change
after the three.  Then one epoch over the cell's split captures the step,
and the window runs whole epochs over it until ``seconds`` have passed.

Once the window has closed and the program is freed, the reference
(``benchmark.reference.model``) runs the same three steps from the same
weights on the same records, masks and all, and the four numbers are
compared: the worst step's loss, the worst leaf's first gradient, the
worst leaf's change (leaves whose reference gradient is under a thousandth
of the median leaf's left out: they move by round-off alone), the worst
running statistic's change.
"""

from __future__ import annotations

import sys
import tempfile
import time

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

BETA1 = 0.9
STEPS = 3


def clone(tree):
    return R.unflatten(tree, [t.clone() for t in R.leaves(tree)])


def named(tree) -> dict:
    return dict(zip(R.paths(tree), R.leaves(tree)))


def change_norms(now: dict, before: dict) -> dict:
    return C.leaf_norms({p: now[p] - before[p] for p in before})


def reference_batch(cfg: dict, recs: list[dict], vocab, keys, device) -> dict:
    """The model's inputs of ``recs``, made by the benchmark."""
    enc = T.encode([r["text"] for r in recs], vocab, keys, cfg["max_len"], cfg["ngram"])
    names = D.labels(cfg)
    enc["image"] = np.stack([T.synthetic_pixels(r["id"], cfg["image_size"]) for r in recs])
    enc["label"] = np.array([names.index(r["label"]) for r in recs], np.int64)
    enc["weight"] = np.ones(len(recs), np.float32)
    return {k: torch.as_tensor(v, device=device) for k, v in enc.items()}


def reference_run(cfg, wl, params, stats, consts, batches, seed, variant=None):
    """(losses, first gradients' norms, changes' norms, statistics' changes'
    norms) of the reference's three steps; ``variant`` plants the control
    (``"control"``: float8 trunks) or a fault (``"half_batch"``: half of
    each batch left out, the mean over the rest)."""
    p, s = clone(params), clone(stats)
    adam = R.Adam(p, wl["optimizer"])
    dtype = getattr(torch, wl["compute_dtype"])
    losses, first = [], None
    rcfg = dict(cfg, bn_mode=wl.get("bn_mode", "batch"))
    for k, batch in enumerate(batches):
        if variant == "half_batch":
            batch = dict(batch, weight=batch["weight"] * (torch.arange(
                len(batch["weight"]), device=batch["weight"].device) < len(batch["weight"]) // 2))
        with R.precision(False):
            loss, got = R.fusion_train_step(p, s, consts, batch, rcfg, adam,
                                            R.derive_seed(seed, k), dtype,
                                            quantize=variant == "control")
        losses.append(loss)
        if k == 0:
            first = C.leaf_norms({n: g for n, g in zip(adam.names, got) if g is not None})
    return (losses, first, change_norms(named(p), named(params)),
            change_norms(named(s), named(stats)))


def checks(wl: dict, prog: tuple, ref: tuple, prefix: str = "") -> list:
    """``loss_gap`` compares the first step's loss: the later steps' losses
    part by a few percent between sound runs, since Adam's first update is
    the sign of each gradient element and bf16 trunks round the small
    elements' signs differently (see PERF.md)."""
    losses_p, grads_p, change_p, stats_p = prog
    losses_r, grads_r, change_r, stats_r = ref
    lim = wl["limits"]
    median = float(np.median(list(grads_r.values())))
    moved = {p for p, g in grads_r.items() if g >= 1e-3 * median}
    return [H.Check(prefix + "loss_gap", abs(losses_p[0] - losses_r[0]) / abs(losses_r[0]),
                    lim["loss_gap"]),
            H.Check(prefix + "grad_gap", C.norm_gap(grads_p, grads_r), lim["grad_gap"]),
            H.Check(prefix + "change_gap", C.norm_gap(change_p, change_r, moved),
                    lim["change_gap"]),
            H.Check(prefix + "stats_gap", C.norm_gap(stats_p, stats_r), lim["stats_gap"])]


def run(cell: H.Cell, t_start: float) -> H.Outcome:
    from mgnns_tpu_torch.engine.train import Engine

    cfg, wl, dev = cell.config, cell.params, cell.device
    phases = H.Phases(t_start)
    B, N = wl["batch"], wl["records"]
    vocab, _, keys, pmi = D.text_side(cfg)
    phases.mark("imports, corpus and PMI graph")
    E = len(keys) + 1
    wseed = cell.seed % 2 ** 63
    consts_np = D.constants(cfg, cell.seed)
    recs = D.records(cfg, N, cell.seed)
    params, stats, consts = W.fusion_weights(cfg, E, consts_np, wseed, dev)
    graph = P.pmi_graph(vocab, keys, pmi)
    opt = wl["optimizer"]
    nb = N // B
    eng = Engine(P.fusion_apply(P.model_config(cfg, wl, E), consts), clone(params), clone(stats),
                 num_classes=cfg["num_labels"], lr=opt["lr"], lrp=opt["lrp"],
                 weight_decay=opt["weight_decay"], grad_clip=opt["grad_clip"],
                 steps_per_epoch=nb, seed=wseed, device=dev)
    parts = [recs[:B], recs[B:STEPS * B], recs]
    if cell.trace:  # a short split of its own: a whole epoch of traced steps is millions of events
        parts.append(recs[:wl["trace_batches"] * B])
    with tempfile.TemporaryDirectory() as root:
        D.write_label_map(root, cfg)
        splits = [P.dataset(cfg, r, vocab, graph, root) for r in parts]
    loaders = [P.loader(ds, B, dev) for ds in splits]
    phases.mark("weights, engine, splits")

    # the first three steps, through the window's call and feed
    losses = list(eng.train_epoch(loaders[0])["step_losses"])
    paths = R.paths(eng.params)
    grads = C.leaf_norms({paths[i]: m / (1 - BETA1)
                          for m, i in zip(eng.opt_state["mu"], eng.opt.trained)})
    losses += list(eng.train_epoch(loaders[1])["step_losses"])
    prog = (losses, grads, change_norms(named(eng.params), named(params)),
            change_norms(named(eng.batch_stats), named(stats)))
    # the reference's copy waits on the host, out of the program's memory
    params, stats = R.unflatten(params, [t.cpu() for t in R.leaves(params)]), \
        R.unflatten(stats, [t.cpu() for t in R.leaves(stats)])
    phases.mark("the first three steps")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    for loader in loaders[2:]:
        eng.train_epoch(loader)  # captures the step over each split's tables
    phases.mark("tables and capture")
    phases.done()

    H.settle()
    setup_s = time.perf_counter() - t_start
    steps = samples = 0
    wall = 0.0
    traced = None
    if cell.trace:  # the traced stretch first; the counters read the epochs after it
        with TR.Traced(TR.MARGIN_S) as traced:
            eng.train_epoch(loaders[3])
    while wall < cell.seconds:
        t0 = time.perf_counter()
        eng.train_epoch(loaders[2])
        wall += time.perf_counter() - t0
        steps += nb
        samples += N
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    lens = splits[-1].text.lens.copy()
    del eng, loaders, splits
    H.free_device()

    params, stats = (R.unflatten(t, [x.to(dev) for x in R.leaves(t)]) for t in (params, stats))
    batches = [reference_batch(cfg, recs[k * B:(k + 1) * B], vocab, keys, dev)
               for k in range(STEPS)]
    ref = reference_run(cfg, wl, params, stats, consts, batches, wseed)
    print(f"step losses: program {prog[0]}, reference {ref[0]}; worst of the three "
          f"{max(abs(a - b) / abs(b) for a, b in zip(prog[0], ref[0]))}", file=sys.stderr)
    out = checks(wl, prog, ref)
    counters = {"steps": steps, "samples": samples, "window_s": wall, "batch": B,
                "lens": lens}
    for variant in wl.get("variants", []):
        counters[variant] = checks(wl, reference_run(cfg, wl, params, stats, consts, batches,
                                                     wseed, variant), ref, variant + ".")
    return H.Outcome(end_to_end={"train_samples_per_s": samples / wall, "setup_s": setup_s},
                     attempted=steps, failed=0, checks=out, counters=counters,
                     trace=traced.trace if traced else None, memory_peak_bytes=peak)
