"""Training epochs of the fusion model with a ``deepseek_v3`` text encoder
(``configs/mgnns-moonlight.json``): ``Engine.train_epoch`` over a split
held in device tables, one captured step replayed per batch, epoch after
epoch, as :mod:`benchmark.mixes.train_epochs` runs the fusion model.

Set-up, window and checks are that mix's (its functions, imported): the
first three steps through the window's own call and feed, each split's
capture, whole epochs until ``seconds`` have passed, then the reference
(:mod:`benchmark.reference.moe_encoder`) over the same three steps from the
same weights and records, and ``loss_gap``, ``grad_gap``, ``change_gap``,
``stats_gap``.  One check is new: ``load_gap``, the sum over the first
step's MoE layers and held experts of the gap between the program's and
the reference's routed tokens, over their total.  The tokens the held
experts got in the window (the program's ``moe.tokens``, counts this mix
makes and hands the forward, zeroed before the window and read once after
it) are counters for the per-layer metrics.

The configuration's top-level keys are the published model's
(``config.json`` of Moonlight-16B-A3B) and the chip's share
(``experts_held``, ``vocab_rows``); the fusion model's own keys are under
``fusion``.  The records' word ids, all under ``vocab_rows``, are the
encoder's token ids.  Weights are drawn from the seed: normal(0, 0.02)
linears, routers and correction biases, RMSNorm weights 1, the projection
to the memory bank as a ``torch`` linear.
"""

from __future__ import annotations

try:  # a program without the encoder cannot run this cell: fail at once
    from mgnns_tpu_torch.nn import moe
except ImportError as missing:
    import sys

    print(f"the program has no MoE text encoder ({missing}): this cell cannot run",
          file=sys.stderr, flush=True)
    raise SystemExit(3)

import dataclasses  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import time  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark import compare as C  # noqa: E402
from benchmark import data as D  # noqa: E402
from benchmark import harness as H  # noqa: E402
from benchmark import program as P  # noqa: E402
from benchmark import trace as TR  # noqa: E402
from benchmark import weights as W  # noqa: E402
from benchmark.mixes import train_epochs as TE  # noqa: E402
from benchmark.reference import model as R  # noqa: E402
from benchmark.reference import moe_encoder as MR  # noqa: E402

STD = 0.02


def held(cfg: dict) -> tuple[int, ...]:
    """The experts this chip holds: the first ``experts_held``."""
    return tuple(range(cfg["experts_held"]))


def program_encoder(cfg: dict):
    from mgnns_tpu_torch.config import MoeEncoderConfig

    return MoeEncoderConfig(
        hidden_size=cfg["hidden_size"], num_layers=cfg["num_hidden_layers"],
        first_dense=cfg["first_k_dense_replace"], num_heads=cfg["num_attention_heads"],
        kv_lora_rank=cfg["kv_lora_rank"], qk_nope_head_dim=cfg["qk_nope_head_dim"],
        qk_rope_head_dim=cfg["qk_rope_head_dim"], v_head_dim=cfg["v_head_dim"],
        intermediate_size=cfg["intermediate_size"],
        moe_intermediate_size=cfg["moe_intermediate_size"],
        n_routed_experts=cfg["n_routed_experts"], num_experts_per_tok=cfg["num_experts_per_tok"],
        n_shared_experts=cfg["n_shared_experts"], experts_held=held(cfg),
        routed_scaling_factor=cfg["routed_scaling_factor"], norm_topk_prob=cfg["norm_topk_prob"],
        rms_norm_eps=cfg["rms_norm_eps"], rope_theta=float(cfg["rope_theta"]),
        vocab_rows=cfg["vocab_rows"])


def encoder_weights(cfg: dict, seed: int, device) -> dict:
    """The encoder's leaves in the program's layout, drawn from ``seed``."""
    s = W._Spec()
    d, H = cfg["hidden_size"], cfg["num_attention_heads"]
    dn, dr, dv, r = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"],
                     cfg["kv_lora_rank"])
    G, E = cfg["experts_held"], cfg["n_routed_experts"]

    def mlp(width, lead=()):
        return {"w13": s.n((*lead, d, 2 * width), STD), "w2": s.n((*lead, width, d), STD)}

    layers = []
    for i in range(cfg["num_hidden_layers"]):
        layer = {"attn_norm": s.f((d,), 1.0),
                 "attn": {"q": s.n((d, H * (dn + dr)), STD), "kv_a": s.n((d, r + dr), STD),
                          "kv_norm": s.f((r,), 1.0), "kv_b": s.n((r, H * (dn + dv)), STD),
                          "o": s.n((H * dv, d), STD)},
                 "mlp_norm": s.f((d,), 1.0)}
        if i < cfg["first_k_dense_replace"]:
            layer["mlp"] = mlp(cfg["intermediate_size"])
        else:
            layer["router"] = {"w": s.n((d, E), STD), "bias": s.n((E,), STD)}
            layer["shared"] = mlp(cfg["n_shared_experts"] * cfg["moe_intermediate_size"])
            layer["experts"] = mlp(cfg["moe_intermediate_size"], (G,))
        layers.append(layer)
    out = 2 * cfg["fusion"]["hidden_size"]
    p = {"embed": s.n((cfg["vocab_rows"], d), STD), "layers": layers, "norm": s.f((d,), 1.0),
         "proj": W._linear(s, d, out)}
    s.draw(torch.Generator(device=device).manual_seed(seed), device)
    return W._resolve(p)


def fusion_apply(mcfg, consts, counts):
    """``Engine``'s ``apply_fn`` of the fusion model with the encoder, whose
    forward adds its routed tokens to ``counts`` (``moe.token_counts``)."""
    from mgnns_tpu_torch.models.mgnns import mgnns_apply

    def apply_fn(p, bs, batch, *, train, generator, axis=None, model=None):
        logits, new_bs, _ = mgnns_apply(p, bs, consts, batch, cfg=mcfg, train=train,
                                        generator=generator, axis=axis, model=model,
                                        moe_counts=counts)
        return logits, new_bs

    return apply_fn


def weights(cfg: dict, num_edges: int, consts_np: dict, seed: int, device):
    """The fusion model's weights with the encoder in place of the
    embedding and the BiLSTM."""
    params, stats, consts = W.fusion_weights(cfg["fusion"], num_edges, consts_np, seed, device)
    del params["embedding"], params["lstm"]
    params["encoder"] = encoder_weights(cfg, R.derive_seed(seed, "encoder"), device)
    return params, stats, consts


def reference_run(cfg, wl, params, stats, consts, batches, seed, variant=None):
    """As :func:`benchmark.mixes.train_epochs.reference_run` from weights
    on any device, plus the first step's tokens per MoE layer and held
    expert.  ``variant``: the control
    (``"control"``: float8 encoder and trunk products) or a fault
    (``"half_batch"``; ``"softmax_router"``; ``"no_bias"``, the correction
    bias left out of the choice)."""
    dev = consts["label_query"].device
    p, s = (R.unflatten(t, [x.to(dev, copy=True) for x in R.leaves(t)]) for t in (params, stats))
    adam = MR.Adam(p, wl["optimizer"])
    dtype = getattr(torch, wl["compute_dtype"])
    fcfg = dict(cfg["fusion"], bn_mode=wl.get("bn_mode", "batch"))
    fault = variant if variant in ("softmax_router", "no_bias") else None
    losses, first, counts = [], None, []
    for k, batch in enumerate(batches):
        if variant == "half_batch":
            batch = dict(batch, weight=batch["weight"] * (torch.arange(
                len(batch["weight"]), device=batch["weight"].device) < len(batch["weight"]) // 2))
        with R.precision(False):
            loss, got = MR.train_step(p, s, consts, batch, fcfg, cfg, held(cfg), adam,
                                      R.derive_seed(seed, k), dtype,
                                      quantize=variant == "control", fault=fault,
                                      counts=counts if k == 0 else None)
        losses.append(loss)
        if k == 0:
            first = {n: g for n, g in zip(adam.names, got) if g is not None}
    out = (losses, first, change_norms(TE.named(p), TE.named(params)),
           change_norms(TE.named(s), TE.named(stats)), np.asarray(counts, np.int64))
    del p, s, adam
    return out


def change_norms(now: dict, before: dict) -> dict:
    """:func:`benchmark.mixes.train_epochs.change_norms` a leaf at a time,
    ``before`` on any device: a difference of every leaf at once is a
    copy of every parameter."""
    return {p: C.leaf_norms({p: now[p] - before[p].to(now[p].device)})[p] for p in before}


def load_gap(prog: np.ndarray, ref: np.ndarray) -> float:
    return float(np.abs(prog - ref).sum() / max(ref.sum(), 1))


def checks(wl: dict, prog: tuple, ref: tuple, prefix: str = "") -> list:
    return TE.checks(wl, prog[:4], ref[:4], prefix) + [
        H.Check(prefix + "load_gap", load_gap(prog[4], ref[4]), wl["limits"]["load_gap"])]


def run(cell: H.Cell, t_start: float) -> H.Outcome:
    from mgnns_tpu_torch.engine.train import Engine

    cfg, wl, dev = cell.config, cell.params, cell.device
    fcfg = cfg["fusion"]
    phases = H.Phases(t_start)
    B, N = wl["batch"], wl["records"]
    vocab, _, keys, pmi = D.text_side(fcfg)
    if len(vocab) > cfg["vocab_rows"]:
        raise ValueError(f"{len(vocab)} word ids do not fit {cfg['vocab_rows']} embedding rows")
    phases.mark("imports, corpus and PMI graph")
    E = len(keys) + 1
    wseed = cell.seed % 2 ** 63
    consts_np = D.constants(fcfg, cell.seed)
    recs = D.records(fcfg, N, cell.seed)
    params, stats, consts = weights(cfg, E, consts_np, wseed, dev)
    graph = P.pmi_graph(vocab, keys, pmi)
    opt = wl["optimizer"]
    nb = N // B
    mcfg = dataclasses.replace(P.model_config(fcfg, wl, E), text_encoder=program_encoder(cfg))
    counts = moe.token_counts(mcfg.text_encoder, dev)
    eng = Engine(fusion_apply(mcfg, consts, counts), TE.clone(params), TE.clone(stats),
                 num_classes=fcfg["num_labels"], lr=opt["lr"], lrp=opt["lrp"],
                 weight_decay=opt["weight_decay"], grad_clip=opt["grad_clip"],
                 steps_per_epoch=nb, seed=wseed, device=dev)
    # the reference's copy waits on the host from here: beside the engine's
    # parameters and Adam state it would not leave room for a capture
    params, stats = R.unflatten(params, [t.cpu() for t in R.leaves(params)]), \
        R.unflatten(stats, [t.cpu() for t in R.leaves(stats)])
    parts = [recs[:B], recs[B:TE.STEPS * B], recs]
    if cell.trace:
        parts.append(recs[:wl["trace_batches"] * B])
    with tempfile.TemporaryDirectory() as root:
        D.write_label_map(root, fcfg)
        splits = [P.dataset(fcfg, r, vocab, graph, root) for r in parts]
    loaders = [P.loader(ds, B, dev) for ds in splits]
    phases.mark("weights, engine, splits")

    losses = list(eng.train_epoch(loaders[0])["step_losses"])
    first_tokens = counts[1].cpu().numpy().copy()  # the counts' own memory on the CPU
    paths = R.paths(eng.params)
    grads = {paths[i]: C.leaf_norms({"m": m})["m"] / (1 - TE.BETA1)
             for m, i in zip(eng.opt_state["mu"], eng.opt.trained)}
    losses += list(eng.train_epoch(loaders[1])["step_losses"])
    prog = (losses, grads, change_norms(TE.named(eng.params), TE.named(params)),
            change_norms(TE.named(eng.batch_stats), TE.named(stats)), first_tokens)
    phases.mark("the first three steps")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    for loader in loaders[2:]:
        eng.train_epoch(loader)
    phases.mark("tables and capture")
    phases.done()

    H.settle()
    setup_s = time.perf_counter() - t_start
    steps = samples = 0
    wall = 0.0
    traced = None
    if cell.trace:
        with TR.Traced(TR.MARGIN_S) as traced:
            eng.train_epoch(loaders[3])
    counts[0].zero_()
    while wall < cell.seconds:
        t0 = time.perf_counter()
        eng.train_epoch(loaders[2])
        wall += time.perf_counter() - t0
        steps += nb
        samples += N
    tokens = counts[0].cpu().numpy() / max(steps, 1)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    lens = splits[-1].text.lens.copy()
    del eng, loaders, splits, counts
    H.free_device()

    # the weights stay on the host: each reference run copies them to the card
    batches = [TE.reference_batch(fcfg, recs[k * B:(k + 1) * B], vocab, keys, dev)
               for k in range(TE.STEPS)]
    ref = reference_run(cfg, wl, params, stats, consts, batches, wseed)
    print(f"step losses: program {prog[0]}, reference {ref[0]}; first step's routed tokens: "
          f"program {int(prog[4].sum())}, reference {int(ref[4].sum())}", file=sys.stderr)
    out = checks(wl, prog, ref)
    counters = {"steps": steps, "samples": samples, "window_s": wall, "batch": B, "lens": lens,
                "moe_tokens": tokens.tolist()}
    for variant in wl.get("variants", []):
        got = checks(wl, reference_run(cfg, wl, params, stats, consts, batches, wseed, variant),
                     ref, variant + ".")
        counters[variant] = got
        print(f"{variant}: " + ", ".join(f"{c.name} {c.value!r} (limit {c.limit!r}"
                                         f"{'' if c.ok else ', OVER'})" for c in got),
              file=sys.stderr, flush=True)
    return H.Outcome(end_to_end={"train_samples_per_s": samples / wall, "setup_s": setup_s},
                     attempted=steps, failed=0, checks=out, counters=counters,
                     trace=traced.trace if traced else None, memory_peak_bytes=peak)

