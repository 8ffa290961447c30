"""The MoE text encoder (``mgnns_tpu_torch/nn/moe.py``) against the
benchmark's plain reference (``benchmark/reference/moe_encoder.py``) on the
CPU at a tiny size: hidden 64, 4 heads of 16 + 8 (rope) / 16, latent 32,
one dense and two MoE layers of 8 experts, top 2, 4 held.  Also the share
test (two chips' shares and the shared expert once give the uncut layer),
the fusion model with the encoder, the engine's epochs, the optimizer's
buckets, the refusals where the encoder has no rules, and the benchmark's
toy cell with its planted faults.  Imports no JAX."""

from __future__ import annotations

import dataclasses
import json
import types

import numpy as np
import pytest
import torch

from benchmark import data as D
from benchmark import harness as H
from benchmark import program as P
from benchmark.mixes import train_epochs as TE
from benchmark.mixes import train_epochs_moe as TM
from benchmark.reference import model as R
from benchmark.reference import moe_encoder as MR
from benchmark.tests.tiny import TINY_CONFIG
from mgnns_tpu_torch.nn import moe
from mgnns_tpu_torch.utils import tree_leaves, tree_paths, tree_unflatten

CELL = "mgnns-moonlight.train-b16"
TINY_ENCODER = {"hidden_size": 64, "num_attention_heads": 4, "num_key_value_heads": 4,
                "qk_rope_head_dim": 8, "qk_nope_head_dim": 16, "v_head_dim": 16,
                "kv_lora_rank": 32, "num_hidden_layers": 3, "intermediate_size": 96,
                "moe_intermediate_size": 24, "n_routed_experts": 8, "num_experts_per_tok": 2,
                "experts_held": 4, "vocab_rows": 320}


def tiny_config(**enc) -> dict:
    cfg = H.config_of(CELL)
    cfg.update(TINY_ENCODER, **enc)
    cfg["fusion"].update({k: v for k, v in TINY_CONFIG.items() if k in cfg["fusion"]})
    return cfg


def tiny_workload(**params) -> dict:
    wl = H.load_json("workloads", CELL)
    wl.update(batch=4, records=12, compute_dtype="float32", bn_mode="frozen", **params)
    return wl


def encoder_case(seed=3, B=3, L=7, **enc):
    cfg = tiny_config(**enc)
    p = TM.encoder_weights(cfg, seed, "cpu")
    g = torch.Generator().manual_seed(seed)
    ids = torch.randint(0, cfg["vocab_rows"], (B, L), generator=g, dtype=torch.int32)
    return cfg, p, ids


def scale_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got - want).detach().abs().max() / want.detach().abs().max().clamp(min=1e-30))


def test_encoder_forward_and_gradients_match_the_reference():
    cfg, p, ids = encoder_case()
    enc = TM.program_encoder(cfg)
    held = TM.held(cfg)
    with R.precision(False):
        ref_leaves = [t.clone().requires_grad_() for t in tree_leaves(p)]
        want = MR.encoder(tree_unflatten(p, ref_leaves), ids, cfg, held, torch.float32)
        got_leaves = [t.clone().requires_grad_() for t in tree_leaves(p)]
        got = moe.encoder_apply(tree_unflatten(p, got_leaves), ids, enc, torch.float32)
    assert got.shape == (3, 7, 2 * cfg["fusion"]["hidden_size"])
    assert scale_gap(got, want) < 1e-5
    probe = torch.randn(got.shape, generator=torch.Generator().manual_seed(1))
    g_want = torch.autograd.grad((want * probe).sum(), ref_leaves, allow_unused=True)
    g_got = torch.autograd.grad((got * probe).sum(), got_leaves, allow_unused=True)
    for path, a, b in zip(tree_paths(p), g_got, g_want):
        if path.endswith("router/bias"):
            assert a is None and b is None, path
            continue
        assert scale_gap(a, b) < 1e-4, path


def test_router_selection_and_weights():
    cfg, p, _ = encoder_case()
    enc = TM.program_encoder(cfg)
    lp = p["layers"][1]["router"]
    n = torch.randn(50, cfg["hidden_size"], generator=torch.Generator().manual_seed(4))
    chosen, w = moe.route(lp, n, enc)
    r_chosen, r_w = MR.route(lp, n, cfg)
    # the program lists a token's choices by expert id, the reference by score
    r_chosen, order = r_chosen.sort(dim=-1)
    assert torch.equal(chosen, r_chosen)
    assert torch.equal(w, r_w.gather(1, order))
    # the choice is by score plus bias, the weights the scores without it,
    # normalised and scaled
    scores = torch.sigmoid(n @ lp["w"])
    assert torch.equal(chosen, torch.topk(scores + lp["bias"], 2, dim=-1).indices.sort(-1).values)
    torch.testing.assert_close(w.sum(-1), torch.full((50,), cfg["routed_scaling_factor"]))


def test_the_shares_add_up_to_the_uncut_layer():
    """Two chips each holding 4 of the 8 experts: their routed parts, with
    the shared experts counted once, give the reference's uncut layer."""
    cfg, p, _ = encoder_case()
    lp = p["layers"][1]
    n = torch.randn(40, cfg["hidden_size"], generator=torch.Generator().manual_seed(5))
    everything = tuple(range(8))
    uncut = {k: torch.cat([v, v + 0.01 * torch.randn_like(v)]) for k, v in lp["experts"].items()}
    with R.precision(False):
        chosen, w = MR.route(lp["router"], n, cfg)
        want = MR.routed(uncut, n, chosen, w, everything, torch.float32)[0] \
            + MR.mlp(lp["shared"], n, torch.float32)
        got = moe.mlp(lp["shared"], n, torch.float32)
        total = 0
        for share in ((0, 1, 2, 3), (4, 5, 6, 7)):
            enc = dataclasses.replace(TM.program_encoder(cfg), experts_held=share)
            c, wt = moe.route(lp["router"], n, enc)
            disp = moe.Dispatch(c, moe.local_map(share, 8, 'cpu'), 4, 4)
            mine = {k: v[list(share)] for k, v in uncut.items()}
            got = got + moe.experts(mine, n, wt, disp, torch.float32)
            total += int(disp.counts.sum())
    assert total == 40 * 2  # every choice computed on exactly one share
    assert scale_gap(got, want) < 1e-5


def test_dispatch_places_every_held_choice_once():
    chosen = torch.tensor([[0, 5], [2, 0], [7, 6], [0, 2], [3, 1]])
    disp = moe.Dispatch(chosen, moe.local_map((0, 2, 3), 8, 'cpu'), 3, 4)
    assert disp.counts.tolist() == [3, 2, 1]
    assert disp.offs.tolist() == [4, 8, 12]
    held_pos = disp.pos[disp.held]
    assert sorted(held_pos.tolist()) == [0, 1, 2, 4, 5, 8]
    assert (disp.pos[~disp.held] == disp.rows).all()
    token = torch.arange(10) // 2
    assert (disp.src[disp.pos.view(-1)[disp.held.view(-1)]] == token[disp.held.view(-1)]).all()


def fusion_case(seed=5):
    cfg = tiny_config()
    wl = tiny_workload()
    fcfg = cfg["fusion"]
    vocab, _, keys, pmi = D.text_side(fcfg)
    params, stats, consts = TM.weights(cfg, len(keys) + 1, D.constants(fcfg, seed), seed, "cpu")
    recs = D.records(fcfg, 4, seed)
    batch = TE.reference_batch(fcfg, recs, vocab, keys, "cpu")
    mcfg = dataclasses.replace(P.model_config(fcfg, wl, len(keys) + 1),
                               text_encoder=TM.program_encoder(cfg))
    return cfg, wl, mcfg, params, stats, consts, batch


def test_mgnns_apply_with_the_encoder_matches_the_reference():
    from mgnns_tpu_torch.models.mgnns import mgnns_apply

    cfg, wl, mcfg, params, stats, consts, batch = fusion_case()
    with R.precision(False):
        want, _ = MR.fusion_forward(params, stats, consts, batch, dict(cfg["fusion"], bn_mode="frozen"),
                                    cfg, TM.held(cfg))
        got, _, _ = mgnns_apply(params, stats, consts, batch, cfg=mcfg)
    assert "lstm" not in params and "embedding" not in params
    assert scale_gap(got, want) < 1e-5


def test_token_counts_belong_to_their_caller():
    """Each forward adds its routed tokens to the counts it is given alone:
    two callers' counts part, none are kept when none are given, and counts
    of another encoder's shape are refused."""
    cfg, p, ids = encoder_case()
    enc = TM.program_encoder(cfg)
    mine, theirs = moe.token_counts(enc, "cpu"), moe.token_counts(enc, "cpu")
    assert tuple(mine.shape) == (2, 2, 4) and mine.dtype == torch.int64
    with torch.no_grad():
        moe.encoder_apply(p, ids, enc, torch.float32, mine)
        moe.encoder_apply(p, ids, enc, torch.float32, mine)
        moe.encoder_apply(p, ids, enc, torch.float32)
        counts: list = []
        MR.encoder(p, ids, cfg, TM.held(cfg), torch.float32, counts=counts)
    want = torch.tensor(counts, dtype=torch.int64)
    assert torch.equal(mine[1], want) and torch.equal(mine[0], 2 * want)
    assert int(want.sum()) > 0 and int(theirs.abs().sum()) == 0
    other = moe.token_counts(dataclasses.replace(enc, experts_held=(0, 1)), "cpu")
    with pytest.raises(ValueError, match="token counts"):
        moe.encoder_apply(p, ids, enc, torch.float32, other)


def test_engine_epochs_with_the_encoder_on_the_cpu():
    from mgnns_tpu_torch.engine.train import Engine

    cfg, wl, mcfg, params, stats, consts, _ = fusion_case()
    fcfg = cfg["fusion"]
    vocab, _, keys, pmi = D.text_side(fcfg)
    recs = D.records(fcfg, 8, 5)
    with __import__("tempfile").TemporaryDirectory() as root:
        D.write_label_map(root, fcfg)
        ds = P.dataset(fcfg, recs, vocab, P.pmi_graph(vocab, keys, pmi), root)
    before = {p: t.clone() for p, t in zip(tree_paths(params), tree_leaves(params))}
    counts = moe.token_counts(mcfg.text_encoder, "cpu")
    eng = Engine(TM.fusion_apply(mcfg, consts, counts), params, stats,
                 num_classes=fcfg["num_labels"], steps_per_epoch=2, device="cpu")
    out = eng.train_epoch(P.loader(ds, 4, "cpu"))
    assert out["fused"] and np.isfinite(out["step_losses"]).all() and len(out["step_losses"]) == 2
    assert int(counts[1].sum()) > 0 and bool((counts[0] >= counts[1]).all())
    after = dict(zip(tree_paths(eng.params), tree_leaves(eng.params)))
    assert not torch.equal(after["/encoder/layers/1/experts/w13"],
                           before["/encoder/layers/1/experts/w13"])
    assert torch.equal(after["/encoder/layers/1/router/bias"],
                       before["/encoder/layers/1/router/bias"])
    ev = eng.eval_epoch(P.loader(ds, 4, "cpu"), collect_preds=True)
    assert ev["fused"] and len(ev["preds"]) == 8


def test_predictor_serves_the_encoder_on_the_cpu():
    """``Predictor``'s eager forward with the encoder: a label and class
    probabilities for each post."""
    from mgnns_tpu_torch.config import TextGraphConfig
    from mgnns_tpu_torch.serving import Predictor

    cfg, wl, mcfg, params, stats, consts, _ = fusion_case()
    fcfg = cfg["fusion"]
    vocab, _, keys, pmi = D.text_side(fcfg)
    pred = Predictor(vocab=vocab, graph=P.pmi_graph(vocab, keys, pmi),
                     graph_cfg=TextGraphConfig(window_size=fcfg["window_size"],
                                               ngram=fcfg["ngram"],
                                               min_cooccurrence=fcfg["min_cooccurrence"],
                                               max_len=fcfg["max_len"]),
                     label_map={f"label{i}": i for i in range(fcfg["num_labels"])},
                     params=params, batch_stats=stats, consts=consts, cfg=mcfg,
                     image_backend="synthetic", max_batch=4, device="cpu")
    try:
        out = pred.predict([{"id": f"p{i}", "text": t} for i, t in
                            enumerate(D.posts(fcfg, 3, 3, 12, 5))])
    finally:
        pred.close()
    assert len(out) == 3
    for row in out:
        probs = np.array(list(row["probs"].values()), np.float64)
        assert probs.shape == (fcfg["num_labels"],) and abs(probs.sum() - 1) < 1e-5
        assert row["label"] == f"label{row['label_id']}"


def test_bucketed_chain_is_bit_equal_to_one_bucket(monkeypatch):
    """Today's model (no encoder): the chain over many small buckets gives
    the bits of the one bucket its whole trained set fits."""
    from mgnns_tpu_torch.engine import optim

    cfg = H.config_of("mgnns-tumemo.train-b16")
    cfg.update({k: v for k, v in TINY_CONFIG.items() if k in cfg})
    _, _, keys, _ = D.text_side(cfg)
    from benchmark import weights as W

    params, _, _ = W.fusion_weights(cfg, len(keys) + 1, D.constants(cfg, 2), 2, "cpu")
    leaves = tree_leaves(params)
    g = torch.Generator().manual_seed(3)
    grads = [torch.randn(t.shape, generator=g) if t.is_floating_point() else None
             for t in leaves]
    grads[3] = None  # a missing gradient: zeros
    runs = []
    for limit in (optim.BUCKET_BYTES, 4096):
        monkeypatch.setattr(optim, "BUCKET_BYTES", limit)
        opt = optim.Optimizer(params, grad_clip=1.0)
        state = opt.init(params)
        p = [t.clone() for t in leaves]
        for _ in range(2):
            opt.apply(p, grads, state, torch.tensor(True))
        runs.append((opt, p, state))
    (one, p1, s1), (many, p2, s2) = runs
    assert len(one.buckets) == 1 and len(many.buckets) > 10
    for a, b in zip(p1 + s1["mu"] + s1["nu"], p2 + s2["mu"] + s2["nu"]):
        assert torch.equal(a, b)


def test_the_encoder_is_refused_where_it_has_no_rules():
    from mgnns_tpu_torch.engine.train import Engine
    from mgnns_tpu_torch.export import export_predictor
    from mgnns_tpu_torch.parallel.sharding import shard_tree
    from mgnns_tpu_torch.serving import Predictor

    cfg, wl, mcfg, params, stats, consts, _ = fusion_case()
    mesh = object()
    with pytest.raises(NotImplementedError, match="MoE text encoder"):
        Engine(lambda *a, **k: None, params, stats, num_classes=7, device="cpu", mesh=mesh)
    with pytest.raises(NotImplementedError, match="MoE text encoder"):
        Predictor(vocab=[], graph=None, graph_cfg=None, label_map={}, params=params,
                  batch_stats=stats, consts=consts, cfg=mcfg, device="cpu", mesh=mesh)
    with pytest.raises(NotImplementedError, match="MoE text encoder"):
        shard_tree(params, types.SimpleNamespace(rank=0, size=2), [])
    with pytest.raises(NotImplementedError, match="MoE text encoder"):
        export_predictor(types.SimpleNamespace(forward_fn=None, cfg=mcfg), "unused")


def test_flops_match_flop_counter_of_the_reference():
    from torch.utils.flop_counter import FlopCounterMode

    from benchmark import flops_moe as FM

    cfg, p, ids = encoder_case(B=2, L=6)
    leaves = [t.clone().requires_grad_() for t in tree_leaves(p)]
    counts: list = []
    with FlopCounterMode(display=False) as fc:
        out = MR.encoder(tree_unflatten(p, leaves), ids, cfg, TM.held(cfg), torch.float32,
                         counts=counts)
        out.sum().backward()
    assert fc.get_total_flops() == 3 * FM.encoder_forward_flops(cfg, 2, 6, counts)


def test_toy_cell_through_run_and_its_faults(monkeypatch, tmp_path, capsys):
    """The cell's mix at a tiny size, through ``benchmark.run.main`` on the
    CPU: ``correct`` true, and the control and each planted fault, in the
    reference's place, over at least one of the cell's limits."""
    from benchmark import run

    cfg = tiny_config()
    cfg_path = tmp_path / "tiny.json"
    cfg_path.write_text(json.dumps(cfg))
    bench = H.benchmark_json()
    for c in bench["configs"]:
        if c["name"] == "mgnns-moonlight":
            c["file"] = str(cfg_path)
    variants = ["control", "half_batch", "softmax_router", "no_bias"]
    wl = tiny_workload(variants=variants)
    real_load = H.load_json
    monkeypatch.setattr(H, "benchmark_json", lambda: bench)
    monkeypatch.setattr(H, "load_json", lambda kind, name: dict(wl) if name == CELL
                        else real_load(kind, name))
    # the test process holds the JAX package (other tests' imports); a
    # benchmark run is a process of its own and keeps the check
    monkeypatch.setattr(H, "forbidden_modules", lambda: [])
    assert run.main(["--workload", CELL, "--seed", "3000000019", "--seconds", "0.2",
                     "--trace", "0"], device="cpu") == 0
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert line["correct"], line["compared"]
    assert set(line["compared"]) == {"loss_gap", "grad_gap", "change_gap", "stats_gap",
                                     "load_gap"}
    for v in variants:
        said = [ln for ln in err.splitlines() if ln.startswith(f"{v}: ")]
        assert len(said) == 1 and "OVER" in said[0], (v, said)
