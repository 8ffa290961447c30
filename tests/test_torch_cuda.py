"""The port on the card: each CUDA kernel against its plain version, a
forward and a train step on the card against the same on the CPU, the
kernels' launch counts across a train epoch, a ResNet trunk on the card
against the CPU under the package's pinned float32 conv precision, the
fusion model at bf16 against float32, and the benchmark's modes on the card
(K1 and K2 in every forward and step, the measured bf16 peak).

This file imports neither JAX nor the JAX package, so it also runs where
those are absent: ``python -m pytest --noconftest tests/test_torch_cuda.py``
on a machine with an NVIDIA GPU.  Without a card every test here skips.
"""

import json

import numpy as np
import pytest
import torch

from mgnns_tpu_torch.kernels import edge_max
from mgnns_tpu_torch.models.text_only import text_model_apply, text_model_init
from mgnns_tpu_torch.utils import tree_to


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _k2_inputs(shape, device, seed=0):
    """K1's card inputs (lens 0, 1 and L, zero weights, an engineered tie,
    a NaN) and a random upstream gradient."""
    B, L, D, ngram = shape
    g = torch.Generator(device=device).manual_seed(seed)
    W = 2 * ngram + 1
    emb = torch.randn(B, L, D, generator=g, device=device)
    w = torch.randn(B, L, W, generator=g, device=device)
    lens = torch.randint(0, L + 1, (B,), generator=g, device=device, dtype=torch.int32)
    lens[-1] = L
    if B > 1:
        lens[0] = 0
    if B > 2:
        lens[1] = 1
    w[:, ::3, 0] = 0.0
    if L > 2 and ngram > 0:
        emb[:, 2, :] = emb[:, 0, :]          # row 1 sees rows 0 and 2 with equal weights
        w[:, 1, ngram - 1] = w[:, 1, ngram + 1]
    emb[-1, L // 2, D // 2] = float("nan")
    up = torch.randn(B, L, D, generator=g, device=device)
    return emb, w, lens, up


# (B, L, D, ngram): the model's shape and a small odd one; the smallest and
# largest windows and g=1; D not a multiple of 32 and wider than a block's
# lanes; one row, and rows in several chunks with L not a multiple of them;
# one document
K2_SHAPES = [(16, 100, 300, 4), (3, 7, 5, 2), (4, 20, 64, 0), (4, 20, 64, 1), (4, 50, 64, 16),
             (4, 20, 33, 4), (4, 20, 1000, 4), (3, 1, 16, 2), (3, 257, 40, 4), (1, 30, 24, 3)]


# K1's cases: K2's shapes (D = 5 and 33 take the scalar path), more
# documents than a warp has lanes (the grid's document axis past 32, with
# short documents whose chunks are mostly past their length), and one whose
# emb lies 4 bytes past a 16-byte boundary, so that D % 4 == 0 takes the
# scalar path too
K1_CASES = [pytest.param(shape, False, id=f"shape{i}") for i, shape in enumerate(K2_SHAPES)] + [
    pytest.param((40, 9, 8, 1), False, id="many-documents"),
    pytest.param((4, 20, 64, 4), True, id="unaligned")]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,unaligned", K1_CASES)
def test_edge_max_kernel_equals_plain(cuda_device, shape, unaligned):
    """K1 against its plain version on the card, exactly (one float32
    multiply and a max each, in the same order), with lens 0, 1 and L, zero
    weights, an engineered tie and a NaN message; a zero result keeps its
    sign."""
    emb, w, lens, _ = _k2_inputs(shape, cuda_device)
    if unaligned:
        buf = torch.empty(emb.numel() + 1, device=cuda_device)
        emb = buf[1:].view(emb.shape).copy_(emb)
        assert emb.is_contiguous() and emb.data_ptr() % 16 == 4
    before = edge_max.launches
    got = edge_max.window_max_aggregate(emb, w, lens, shape[3])
    torch.cuda.synchronize()
    assert edge_max.launches == before + 1
    want = edge_max.window_max_aggregate_plain(emb, w, lens, shape[3])
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)
    nan = torch.isnan(want)
    assert torch.equal(torch.signbit(got[~nan]), torch.signbit(want[~nan]))


@pytest.mark.cuda
def test_text_model_on_card_matches_cpu(cuda_device):
    """The text-only model through K1 on the card against the same weights on
    the CPU (plain version): float32 sums in another order, so 1e-5."""
    V, E, B, L, ngram = 50, 40, 4, 12, 2
    params = text_model_init(V, 7, E, seed=0, device=cuda_device)
    r = np.random.default_rng(0)
    lens = np.array([1, 5, 12, 9], np.int32)
    ids = r.integers(1, V, (B, L)).astype(np.int32)
    ids[np.arange(L)[None, :] >= lens[:, None]] = 0
    eids = r.integers(0, E, (B, L, 2 * ngram + 1)).astype(np.int32)
    batch = {"ids": ids, "lens": lens, "eids": eids}
    with torch.inference_mode():
        got = text_model_apply(params, {k: torch.from_numpy(v).to(cuda_device)
                                        for k, v in batch.items()}, ngram=ngram)
        cpu_params = {k: {kk: vv.cpu() for kk, vv in v.items()} for k, v in params.items()}
        want = text_model_apply(cpu_params, {k: torch.from_numpy(v) for k, v in batch.items()},
                                ngram=ngram)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", K2_SHAPES)
def test_edge_max_backward_kernel_equals_plain(cuda_device, shape):
    """K2 against its plain backward: d_emb exactly (the same float32 terms
    added in the same order), d_w within 1e-5 of scale (its sum over D runs
    in another order), NaN patterns equal."""
    emb, w, lens, up = _k2_inputs(shape, cuda_device)
    before = edge_max.bwd_launches
    d_emb, d_w = edge_max._backward(emb, w, lens, up, shape[3])
    torch.cuda.synchronize()
    assert edge_max.bwd_launches == before + 1
    want_e, want_w = edge_max.window_max_aggregate_backward_plain(emb, w, lens, up, shape[3])
    torch.testing.assert_close(d_emb, want_e, rtol=0, atol=0, equal_nan=True)
    scale = max(1.0, float(want_w.nan_to_num().abs().max()))
    torch.testing.assert_close(d_w, want_w, rtol=1e-5, atol=1e-5 * scale, equal_nan=True)


@pytest.mark.cuda
def test_edge_max_backward_kernel_ties(cuda_device):
    """The constant-input case of tests/test_kernels.py:78: every in-window
    message ties, so the gradient splits 0.5/0.5 down the max chain; the
    terms are exact in float32, so both gradients equal the plain backward
    exactly, whatever the order of their sums."""
    B, L, D, ngram = 2, 8, 4, 2
    emb = torch.full((B, L, D), 0.5)
    w = torch.ones(B, L, 2 * ngram + 1)
    lens = torch.tensor([8, 5], dtype=torch.int32)
    up = torch.arange(1, D + 1, dtype=torch.float32).expand(B, L, D).contiguous()
    got = edge_max._backward(*(a.to(cuda_device) for a in (emb, w, lens, up)), ngram)
    want = edge_max.window_max_aggregate_backward_plain(emb, w, lens, up, ngram)
    assert len(torch.unique(want[1])) > 2  # fractional gradient mass
    for gg, ww in zip(got, want):
        torch.testing.assert_close(gg.cpu(), ww, rtol=0, atol=0)


def _text_train_setup(device):
    from mgnns_tpu_torch.engine.train import Engine

    V, E, B, L, ngram = 50, 40, 8, 12, 2
    # the same weights on every device: a CUDA and a CPU generator differ
    params = tree_to(text_model_init(V, 7, E, seed=0, device="cpu"), torch.device(device))
    r = np.random.default_rng(0)
    batches = []
    for _ in range(2):
        lens = r.integers(1, L + 1, B).astype(np.int32)
        ids = r.integers(1, V, (B, L)).astype(np.int32)
        ids[np.arange(L)[None, :] >= lens[:, None]] = 0
        batches.append({"ids": ids, "lens": lens,
                        "eids": r.integers(0, E, (B, L, 2 * ngram + 1)).astype(np.int32),
                        "label": r.integers(0, 7, B).astype(np.int32),
                        "weight": np.ones(B, np.float32)})

    def apply_fn(p, bs, batch, *, train, generator):
        return text_model_apply(p, batch, ngram=ngram, dropout_rate=0.0, train=train,
                                generator=generator), bs

    engine = Engine(apply_fn, params, {}, num_classes=7, optimizer_algo="sgd", lr=0.1,
                    device=device)
    return engine, batches


@pytest.mark.cuda
def test_text_train_step_on_card_matches_cpu(cuda_device):
    """One text-only Engine step with K1/K2 on the card against the same step
    on the CPU (plain versions): loss and updated parameters within 1e-4 of
    scale (float32 sums, and the embedding backward's atomics, in another
    order)."""
    from mgnns_tpu_torch.engine.metrics import confusion_init
    from mgnns_tpu_torch.utils import tree_leaves

    results = []
    for dev in (cuda_device, torch.device("cpu")):
        engine, batches = _text_train_setup(dev)
        loss = engine.train_step(batches[0], confusion_init(7, dev))
        results.append((float(loss), [t.cpu() for t in tree_leaves(engine.params)]))
    (l_card, p_card), (l_cpu, p_cpu) = results
    assert abs(l_card - l_cpu) <= 1e-4 * max(1.0, abs(l_cpu))
    for a, b in zip(p_card, p_cpu):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4 * max(1.0, float(b.abs().max())))


@pytest.mark.cuda
def test_launch_counts_across_train_epoch(cuda_device):
    """K1 launches once per forward and K2 once per backward in an epoch."""
    engine, batches = _text_train_setup(cuda_device)
    edge_max.launches = edge_max.bwd_launches = 0
    out = engine.train_epoch(batches)
    assert out["skipped_steps"] == 0
    assert (edge_max.launches, edge_max.bwd_launches) == (len(batches), len(batches))


def _small_fusion(device):
    """A fusion model at 64 px with small vocabulary and label graphs, its
    weights made on the CPU, and a 2-record batch of uint8 pixels."""
    from mgnns_tpu_torch.config import ModelConfig
    from mgnns_tpu_torch.models.mgnns import mgnns_init

    r = np.random.default_rng(0)
    cfg = ModelConfig(vocab_size=50, edges_num=30, image_size=64, object_num_classes=4,
                      place_num_classes=5)
    params, stats, consts = mgnns_init(
        cfg, num_edges=30, label_embedding=r.standard_normal((7, 300)), object_A=np.eye(4),
        place_A=np.eye(5), object_inp=r.standard_normal((4, 300)),
        place_inp=r.standard_normal((5, 300)), device="cpu")
    B, L = 2, 6
    batch = {"ids": r.integers(1, 50, (B, L)).astype(np.int32),
             "lens": np.full((B,), L, np.int32), "mask": np.ones((B, L), np.float32),
             "eids": r.integers(0, 30, (B, L, 9)).astype(np.int32),
             "image": r.integers(0, 256, (B, 64, 64, 3)).astype(np.uint8)}
    return (cfg, *(tree_to(t, device) for t in (params, stats, consts)),
            {k: torch.from_numpy(v).to(device) for k, v in batch.items()})


@pytest.mark.cuda
def test_fusion_bf16_forward_near_float32(cuda_device):
    """The fusion forward with bf16 trunks on the card: finite, within the
    JAX package's bf16 bound of 4e-2 of scale of the float32 forward."""
    import dataclasses

    from mgnns_tpu_torch.models.mgnns import mgnns_apply

    cfg, params, stats, consts, batch = _small_fusion(cuda_device)
    with torch.inference_mode():
        f32 = mgnns_apply(params, stats, consts, batch, cfg=cfg)[0]
        bf16 = mgnns_apply(params, stats, consts, batch,
                           cfg=dataclasses.replace(cfg, compute_dtype="bfloat16"))[0]
    assert bf16.dtype == torch.float32 and torch.isfinite(bf16).all()
    drift = float((bf16 - f32).abs().max() / f32.abs().max())
    assert 0 < drift <= 4e-2, drift


@pytest.mark.cuda
def test_trunk_forward_on_card_matches_cpu_under_the_pin(cuda_device, monkeypatch):
    """A ResNet-50 trunk at 64 px on the card against the CPU, with torch's
    global flags as they are (TF32 allowed for cuDNN convolutions by
    default): within 1e-4 of scale under the package's pin, and closer than
    the same forward with the pin removed."""
    import contextlib

    from mgnns_tpu_torch.nn import resnet

    g = torch.Generator().manual_seed(0)
    params, stats = resnet.resnet_init(g, depth=50)
    x = torch.randn(2, 64, 64, 3, generator=g)
    want = resnet.resnet_apply(params, stats, x)[0]
    on_card = [tree_to(t, cuda_device) for t in (params, stats, x)]
    errs = []
    for pinned in (True, False):
        if not pinned:
            monkeypatch.setattr(resnet, "ieee_float32_convs", contextlib.nullcontext)
            monkeypatch.setattr(torch.backends.cudnn.conv, "fp32_precision", "tf32")
        with torch.inference_mode():
            got = resnet.resnet_apply(*on_card[:2], on_card[2])[0].cpu()
        errs.append(float((got - want).abs().max() / want.abs().max()))
    assert errs[0] <= 1e-4 and errs[0] < errs[1], errs


@pytest.mark.cuda
def test_text_checkpoint_served_on_card_with_k1_per_forward(cuda_device, tmp_path):
    """A text-only checkpoint served by ``Predictor.from_engine_artifacts`` on
    the card: K1 once per forward, answers within 1e-5 of the same
    checkpoint served on the CPU, and ``BatchingFrontend`` launching K1 once
    per device chunk."""
    import threading

    from mgnns_tpu_torch.config import TextGraphConfig
    from mgnns_tpu_torch.engine.checkpoint import Checkpointer
    from mgnns_tpu_torch.graphs.pmi import cal_pmi
    from mgnns_tpu_torch.graphs.vocab import build_vocab
    from mgnns_tpu_torch.serving import BatchingFrontend, Predictor, save_preproc

    corpus = ["happy joy smile great day", "sad cry tears bad day", "joy smile happy fun",
              "cry bad sad terrible", "great fun smile joy", "terrible tears bad cry"]
    vocab = build_vocab(corpus, 1)
    graph = cal_pmi(corpus, vocab, window_size=3, min_cooccurrence=1)
    labels = {"neg": 0, "pos": 1}
    ckpt = str(tmp_path / "ckpt")
    Checkpointer(ckpt).save(1, {"params": text_model_init(len(vocab), 2, graph.num_edges,
                                                          seed=4, device="cpu"),
                                "batch_stats": {}})
    save_preproc(ckpt, vocab, graph, labels, TextGraphConfig())
    records = [{"id": i, "text": corpus[i % 6] + " unknown" * (i % 3)} for i in range(20)]
    preds = {dev: Predictor.from_engine_artifacts(str(tmp_path), ckpt, text_only=True,
                                                  max_batch=8, device=dev)
             for dev in ("cuda", "cpu")}
    edge_max.launches = 0
    card = preds["cuda"].predict(records)
    assert edge_max.launches == 3
    host = preds["cpu"].predict(records)
    assert [c["label"] for c in card] == [h["label"] for h in host]
    np.testing.assert_allclose([list(c["probs"].values()) for c in card],
                               [list(h["probs"].values()) for h in host], atol=1e-5)

    pred = preds["cuda"]
    chunks = []
    forward = pred._forward
    pred._forward = lambda b: (chunks.append(1), forward(b))[1]
    fe = BatchingFrontend(pred, max_queue=16)
    edge_max.launches = 0
    threads = [threading.Thread(target=fe.submit, args=(records[i:i + 5],)) for i in range(0, 20, 5)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
        assert not t.is_alive()
    assert edge_max.launches == len(chunks) > 0 and fe.stats()["requests"] == 4


@pytest.mark.cuda
@pytest.mark.parametrize("ngram", [0, 1, 4])
def test_opcheck_on_card(cuda_device, ngram):
    """``torch.library.opcheck`` on both operators with CUDA tensors: K1 and
    K2 behind the schema, the fake registrations and the autograd formula."""
    emb, w, lens, up = _k2_inputs((3, 9, 8, ngram), cuda_device, seed=ngram)
    emb[-1].nan_to_num_(0.0)  # the gradient check compares finite values
    torch.library.opcheck(torch.ops.mgnns.edge_max_forward.default, (emb, w, lens, ngram))
    torch.library.opcheck(torch.ops.mgnns.edge_max_forward.default,
                          (emb.clone().requires_grad_(), w.clone().requires_grad_(), lens, ngram))
    torch.library.opcheck(torch.ops.mgnns.edge_max_backward.default, (emb, w, lens, up, ngram))


@pytest.mark.cuda
def test_exported_text_program_launches_k1_per_forward(cuda_device, tmp_path):
    """A text-only Predictor exported on the card and loaded again: K1 once
    per forward of the program, and the live answers within 1e-5."""
    from mgnns_tpu_torch.config import TextGraphConfig
    from mgnns_tpu_torch.export import export_predictor, load_exported
    from mgnns_tpu_torch.graphs.pmi import cal_pmi
    from mgnns_tpu_torch.graphs.vocab import build_vocab
    from mgnns_tpu_torch.serving import Predictor

    corpus = ["happy joy smile great day", "sad cry tears bad day", "joy smile happy fun"]
    vocab = build_vocab(corpus, 1)
    graph = cal_pmi(corpus, vocab, window_size=3, min_cooccurrence=1)
    live = Predictor(vocab=vocab, graph=graph, graph_cfg=TextGraphConfig(),
                     label_map={"a": 0, "b": 1},
                     params=text_model_init(len(vocab), 2, graph.num_edges, seed=2, device="cpu"),
                     text_only=True, max_batch=8, device=cuda_device)
    export_predictor(live, str(tmp_path / "art"))
    pred = load_exported(str(tmp_path / "art"))
    records = [{"id": i, "text": corpus[i % 3] + " unknown" * (i % 2)} for i in range(20)]
    edge_max.launches = 0
    got = pred.predict(records)
    assert edge_max.launches == 3
    want = live.predict(records)
    for g_, w_ in zip(got, want):
        assert g_["label"] == w_["label"]
        assert max(abs(g_["probs"][k] - w_["probs"][k]) for k in w_["probs"]) <= 1e-5
    pred.close()
    live.close()


@pytest.mark.cuda
def test_one_train_step_launches_k1_and_k2_once(cuda_device):
    """K2 behind the backward operator: one Engine step launches K1 once and
    K2 once, as before the operators."""
    from mgnns_tpu_torch.engine.metrics import confusion_init

    engine, batches = _text_train_setup(cuda_device)
    edge_max.launches = edge_max.bwd_launches = 0
    engine.train_step(batches[0], confusion_init(7, cuda_device))
    torch.cuda.synchronize()
    assert (edge_max.launches, edge_max.bwd_launches) == (1, 1)


# ------------------------------------------------- captured steps over a plan


class _PlanLoader:
    """A loader whose every epoch is the same plan over device tables."""

    def __init__(self, plan):
        self.plan = plan

    def epoch_plan(self):
        return dict(self.plan)


def _fusion_plan_engine(device, dropout, remat_policy="none", nb=3, B=2, checkpoint_dir=None):
    """The 64 px fusion model of ``_small_fusion`` (Adam, head diversity in
    the loss) and a plan of ``nb`` batches of ``B`` over 5 records' device
    tables; the host batches of the same plan for the loop path."""
    import dataclasses

    from mgnns_tpu_torch.engine.train import Engine
    from mgnns_tpu_torch.models.mgnns import mgnns_apply

    cfg, params, stats, consts, _ = _small_fusion(device)
    cfg = dataclasses.replace(cfg, dropout=dropout, text_dropout=dropout, is_regu=True,
                              remat_policy=remat_policy)
    r = np.random.default_rng(1)
    N, L = 5, 6
    lens = r.integers(1, L + 1, N).astype(np.int32)
    host = {"ids": r.integers(1, 50, (N, L)).astype(np.int32), "lens": lens,
            "mask": (np.arange(L)[None] < lens[:, None]).astype(np.float32),
            "eids": r.integers(0, 30, (N, L, 9)).astype(np.int32),
            "label": r.integers(0, 7, N).astype(np.int32),
            "image": r.integers(0, 256, (N, 64 * 64 * 3)).astype(np.uint8)}
    idx = r.integers(0, N, (nb, B)).astype(np.int32)
    weight = np.ones((nb, B), np.float32)
    weight[-1, -1] = 0.0
    plan = {"tables": {k: torch.from_numpy(v).to(device) for k, v in host.items()},
            "idx": idx, "weight": weight, "labels": host["label"][idx],
            "row_shapes": {"image": (64, 64, 3)}}
    batches = [{**{k: v[idx[i]] for k, v in host.items()}, "weight": weight[i]}
               for i in range(nb)]
    for b in batches:
        b["image"] = b["image"].reshape(B, 64, 64, 3)

    def apply_fn(p, bs, batch, *, train, generator):
        logits, new_bs, aux = mgnns_apply(p, bs, consts, batch, cfg=cfg, train=train,
                                          generator=generator)
        return logits, new_bs, aux.get("head_diversity", 0.0)

    engine = Engine(apply_fn, params, stats, num_classes=7, lr=1e-3, aux_loss_weight=0.3,
                    steps_per_epoch=nb, checkpoint_dir=checkpoint_dir, device=device)
    return engine, _PlanLoader(plan), batches


@pytest.fixture
def deterministic_cudnn():
    """cuDNN's deterministic algorithms: its default float32 weight-gradient
    algorithm adds with atomics, so two eager runs of the same steps differ
    too.  A graph keeps the algorithms chosen at its capture."""
    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    yield
    torch.backends.cudnn.deterministic = before


def _worst_leaf(got, want) -> tuple[float, str]:
    """(the largest max |got - want| / the leaf's scale, the leaf's path)."""
    from mgnns_tpu_torch.utils import tree_leaves, tree_paths

    return max((float((a - b).abs().max()) / max(float(b.abs().max()), 1e-12), path)
               for a, b, path in zip(tree_leaves(got), tree_leaves(want), tree_paths(want)))


def _scale_errors(got, want) -> float:
    return _worst_leaf(got, want)[0]


@pytest.mark.cuda
@pytest.mark.parametrize("dropout,remat_policy", [(0.0, "none"), (0.5, "none"), (0.5, "block")])
def test_captured_steps_equal_eager_steps(cuda_device, deterministic_cudnn, dropout,
                                          remat_policy):
    """Three steps of the fusion model as CUDA-graph replays over a plan
    against the same three steps eagerly (the loop path) from the same
    weights, with cuDNN's deterministic algorithms: per-step losses,
    parameters and BN statistics within 1e-6 of each leaf's scale (the
    figure is printed; 0.0 when the replay runs the eager step's kernels in
    the eager step's order).  At dropout 0.5 the replays draw the loop
    path's masks from the re-seeded site generators; with per-block remat
    the recompute is captured too."""
    from mgnns_tpu_torch.engine.metrics import confusion_init

    graph_eng, loader, batches = _fusion_plan_engine(cuda_device, dropout, remat_policy)
    loop_eng, _, _ = _fusion_plan_engine(cuda_device, dropout, remat_policy)
    got = graph_eng._graphs.train(loader.epoch_plan())
    cm = confusion_init(7, cuda_device)
    want = np.array([float(loop_eng.train_step(b, cm)) for b in batches], np.float32)
    assert got["capture_seconds"] > 0 and np.isfinite(got["losses"]).all()
    loss_err = float(np.abs(got["losses"] - want).max() / np.abs(want).max())
    param_err, param_leaf = _worst_leaf(graph_eng.params, loop_eng.params)
    stat_err, stat_leaf = _worst_leaf(graph_eng.batch_stats, loop_eng.batch_stats)
    report = (f"captured vs eager, dropout {dropout}, remat {remat_policy}: losses "
              f"{got['losses']} vs {want}; max error of scale: losses {loss_err}, parameters "
              f"{param_err} (worst leaf {param_leaf}), BN statistics {stat_err} (worst leaf "
              f"{stat_leaf})")
    print(report)
    assert loss_err <= 1e-6 and param_err <= 1e-6 and stat_err <= 1e-6, report
    np.testing.assert_array_equal(got["cm"], cm.cpu().numpy())
    assert int(graph_eng.opt_state["count"]) == graph_eng.step == 3


@pytest.mark.cuda
def test_replays_launch_k1_and_k2_once_each(cuda_device):
    """Counted from the profiler's device events (a replay runs none of the
    wrappers' Python, so their counters stay put): every train replay runs
    K1 once and K2 once, every eval replay K1 once."""
    from torch.profiler import ProfilerActivity, profile

    engine, loader, _ = _fusion_plan_engine(cuda_device, 0.5)
    engine.train_epoch(loader)  # captures
    engine.eval_epoch(loader)
    edge_max.launches = edge_max.bwd_launches = 0
    # a warm-up cycle first, as events at the very start of a trace can be
    # lost; the active cycle's events are read when it ends
    counts = {}

    def ready(prof):
        counts.update({name: sum(e.count for e in prof.key_averages() if name in e.key)
                       for name in ("edge_max_fwd_kernel", "edge_max_bwd_kernel")})

    with profile(activities=[ProfilerActivity.CUDA], on_trace_ready=ready,
                 schedule=torch.profiler.schedule(wait=0, warmup=1, active=1)) as prof:
        for _ in range(2):
            tr = engine.train_epoch(loader)
            ev = engine.eval_epoch(loader)
            torch.cuda.synchronize()
            prof.step()
    assert tr["fused"] and ev["fused"] and tr["capture_seconds"] == ev["capture_seconds"] == 0.0
    assert counts == {"edge_max_fwd_kernel": 3 + 3, "edge_max_bwd_kernel": 3}, counts
    assert (edge_max.launches, edge_max.bwd_launches) == (0, 0)


@pytest.mark.cuda
def test_restore_after_capture_replays_the_restored_trajectory(cuda_device, deterministic_cudnn,
                                                               tmp_path):
    """Train two epochs through captured steps, restore the checkpoint of
    the first and train the second again: the graphs are dropped with the
    tensors they read, the new ones are captured against the restored
    state, and the second epoch's losses and parameters come out again
    (deterministic cuDNN, as above)."""
    engine, loader, _ = _fusion_plan_engine(cuda_device, 0.5, checkpoint_dir=str(tmp_path))
    engine.train_epoch(loader)
    engine.save()
    second = engine._graphs.train(loader.epoch_plan())["losses"]
    params = [t.clone() for t in engine._state_tensors()]
    engine.restore()
    assert engine.step == 3
    again = engine._graphs.train(loader.epoch_plan())
    assert again["capture_seconds"] > 0
    np.testing.assert_array_equal(again["losses"], second)
    assert _scale_errors(engine._state_tensors(), params) <= 1e-6


@pytest.fixture(scope="module")
def bench_peak():
    """The card's measured bf16 peak, once for the benchmark's tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    from mgnns_tpu_torch.tools import _bench_util

    return _bench_util.measured_bf16_peak()


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["text", "full", "train"])
def test_bench_modes_launch_the_kernels_on_card(cuda_device, bench_peak, mode, capsys):
    """``bench.run`` at tiny widths on the card: one JSON line with a share
    of the measured peak in (0, 1.05], K1 once per forward (and K2 once per
    train step) in the profiler's device events of the headline path and in
    the wrapper counts of the timed eager forwards and steps, and the
    captured eval epoch's predictions equal to the eager epoch's."""
    from mgnns_tpu_torch import bench
    from mgnns_tpu_torch.config import TextGraphConfig
    from mgnns_tpu_torch.tools import _bench_util

    assert 0 < bench_peak <= 1.05 * _bench_util.BF16_DATASHEET_TFLOPS
    data = _bench_util.flagship_data("synthetic", n_records=8, image_size=64,
                                     graph_cfg=TextGraphConfig(max_len=16), label_classes=(5, 6))
    out = bench.run(mode, batch_size=4, data=data, peak_tflops=bench_peak, trace=True)
    assert capsys.readouterr().out.splitlines() == [json.dumps(out)]
    assert out["value"] > 0 and 0 < out["mfu"] <= 1.05
    assert out["device"]["name"] == torch.cuda.get_device_name(0)
    assert out["trace"]["k1_per"] == 1.0, out["trace"]
    n = out["launches"]
    if mode == "train":
        assert out["trace"]["k2_per"] == 1.0 and out["epoch_fused"], out
        assert n["k1_timed"] == n["k2_timed"] == n["timed_steps"], n
    else:
        assert n["k1_timed"] == n["timed_forwards"], n
    if mode == "full":
        assert out["live_preds_differ_from_cached"] == 0 and out["live_pipeline_fused"], out


@pytest.mark.cuda
def test_bench_torch_runs_in_a_fresh_process(cuda_device):
    """``python bench_torch.py`` as a user starts it: a new process, text
    mode, 64 samples; its last line is the JSON line, on the card."""
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, MGNNS_BENCH_MODE="text", MGNNS_BENCH_SAMPLES="64")
    r = subprocess.run([sys.executable, "bench_torch.py"], cwd=root, env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout.splitlines()[-1])
    assert out["metric"] == "text_channel_eval_samples_per_sec_per_chip" and out["value"] > 0
    assert out["device"]["name"] == torch.cuda.get_device_name(0) and 0 < out["mfu"] <= 1.05
