"""The port on the card: each CUDA kernel against its plain version (K1,
K2 and the BiLSTM's recurrence), a forward and a train step on the card
against the same on the CPU, the kernels' launch counts across a train
epoch, a ResNet trunk on the card against the CPU under the package's
pinned float32 conv precision, the fusion model at bf16 against float32,
and the optimizer's kernels against the chain's float32 arithmetic and the
plain chain.

This file imports neither JAX nor the JAX package, so it also runs where
those are absent: ``python -m pytest --noconftest tests/test_torch_cuda.py``
on a machine with an NVIDIA GPU.  Without a card every test here skips.
"""

import math

import numpy as np
import pytest
import torch

from mgnns_tpu_torch.kernels import edge_max
from mgnns_tpu_torch.kernels import lstm as lstm_kernel
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


# (B, L, H, D): the model's widths (a cluster of 6 CTAs of 25 units) and a
# small H that its cluster does not divide (2 CTAs of 19 and 18 units), at
# one row, the train batch (tiles of 4 rows) and the eval batch (tiles of 16)
LSTM_SHAPES = [(b, l, h, d) for b in (1, 16, 128) for l in (1, 17, 100)
               for h, d in ((150, 300), (37, 23))]


def lstm_case(shape, seed=0):
    """CPU float32 weights of a 2-layer BiLSTM, inputs, lens with 0, 1 and L
    where the batch has rows for them, and upstream gradients on the memory
    bank and on the final h and c."""
    from mgnns_tpu_torch.nn.lstm import lstm_init

    B, L, H, D = shape
    g = torch.Generator().manual_seed(seed)
    params = lstm_init(g, D, H, 2, True)
    x = torch.randn(B, L, D, generator=g)
    lens = torch.randint(0, L + 1, (B,), generator=g, dtype=torch.int32)
    lens[-1] = L
    if B > 1:
        lens[0] = 0
    if B > 2:
        lens[1] = 1
    ups = (torch.randn(B, L, 2 * H, generator=g), torch.randn(4, B, H, generator=g),
           torch.randn(4, B, H, generator=g))
    return params, x, lens, ups


def lstm_step(params, x, lens, ups):
    """The BiLSTM's forward and the gradients of a loss on its memory bank
    and final states: (out, h_n, c_n, dx, then dW_ih, dW_hh, db_ih, db_hh of
    every layer and direction)."""
    from mgnns_tpu_torch.nn.lstm import lstm_apply

    out, (h, c) = lstm_apply(params, x, lens)
    loss = sum((t * u).sum() for t, u in zip((out, h, c), ups))
    leaves = [x] + [p[k] for layer in params["layers"] for p in layer
                    for k in ("w_ih", "w_hh", "b_ih", "b_hh")]
    grads = torch.autograd.grad(loss, leaves)
    return (out.detach(), h.detach(), c.detach(), *grads)


def _lstm_on(device, dtype, params, x, lens, ups):
    def leaf(t):
        return t.to(device, dtype).requires_grad_()

    return ({"layers": [[{k: leaf(v) for k, v in p.items()} for p in layer]
                        for layer in params["layers"]]},
            leaf(x), lens.to(device), tuple(u.to(device, dtype) for u in ups))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", LSTM_SHAPES, ids=lambda s: "B{}-L{}-H{}-D{}".format(*s))
def test_lstm_kernels_equal_plain(cuda_device, shape, monkeypatch):
    """The two-layer BiLSTM through its kernels on the card (float32, one
    forward and one backward launch a layer) against the plain versions on
    the CPU in float64 (the step loop and the reverse recurrence, which
    ``tests/test_torch_lstm.py`` holds to autograd through the loop): the
    memory bank, h_n and c_n within 1e-5; dx, dW_ih, dW_hh, db_ih and db_hh
    of every layer and direction within 1e-4 of each one's largest entry.
    The plain loops never run on the card tensors."""
    from mgnns_tpu_torch.nn import lstm

    case = lstm_case(shape)
    with monkeypatch.context() as m:
        for name in ("_run_direction", "_run_direction_backward"):
            m.setattr(lstm, name, lambda *a, **k: pytest.fail("the plain loop ran on the card"))
        before = (lstm_kernel.launches, lstm_kernel.bwd_launches)
        got = lstm_step(*_lstm_on(cuda_device, torch.float32, *case))
        torch.cuda.synchronize()
    assert (lstm_kernel.launches, lstm_kernel.bwd_launches) == (before[0] + 2, before[1] + 2)
    want = lstm_step(*_lstm_on("cpu", torch.float64, *case))
    names = ["out", "h_n", "c_n", "dx"] + [f"l{l}.{d}.{k}" for l in range(2) for d in range(2)
                                           for k in ("w_ih", "w_hh", "b_ih", "b_hh")]
    worst = {}
    for name, a, b in zip(names, got, want):
        err = float((a.double().cpu() - b).abs().max())
        scale = 1.0 if name in ("out", "h_n", "c_n") else max(float(b.abs().max()), 1e-30)
        worst[name] = err / scale
    print(f"LSTM {shape}: worst error of scale {max(worst.values())} ({max(worst, key=worst.get)})")
    bad = {k: v for k, v in worst.items() if v > (1e-5 if k in ("out", "h_n", "c_n") else 1e-4)}
    assert not bad, bad


@pytest.mark.cuda
def test_lstm_opcheck_on_card(cuda_device):
    """``torch.library.opcheck`` on both BiLSTM operators with CUDA tensors:
    the kernels behind the schema, the fake registrations and the autograd
    formula."""
    B, L, H = 3, 9, 37
    g = torch.Generator().manual_seed(0)
    xw = torch.randn(2, B, L, 4 * H, generator=g).to(cuda_device)
    w_hh = (torch.randn(2, H, 4 * H, generator=g) * 0.2).to(cuda_device)
    b_hh = torch.randn(2, 4 * H, generator=g).to(cuda_device)
    lens = torch.tensor([0, 1, L], dtype=torch.int32, device=cuda_device)
    torch.library.opcheck(torch.ops.mgnns.lstm_forward.default, (xw, w_hh, b_hh, lens, False))
    torch.library.opcheck(torch.ops.mgnns.lstm_forward.default,
                          (xw.clone().requires_grad_(), w_hh.clone().requires_grad_(),
                           b_hh.clone().requires_grad_(), lens, True))
    _, _, _, gates, cells = torch.ops.mgnns.lstm_forward(xw, w_hh, b_hh, lens, True)
    up = torch.randn(B, L, 2 * H, device=cuda_device)
    torch.library.opcheck(torch.ops.mgnns.lstm_backward.default,
                          (gates, cells, w_hh, lens, up, None, None))


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


# ------------------------------------------------------- the optimizer kernels


# the leaves of _adam_case in leaf order: (group, name, shape)
ADAM_LEAVES = [("text_gcn", "w", (33, 17)), ("text_gcn", "b", (7,)),
               ("object_trunk", "conv", (8, 6, 3, 3)), ("object_trunk", "pw", (16, 8, 1, 1)),
               ("object_trunk", "bn", (5,)), ("gc1", "odd", (1001,)), ("gc1", "empty", (0, 4)),
               ("gc1", "col", (9, 5)), ("gc1", "none", (3, 3)), ("gc1", "view", (4099,)),
               ("lstm", "w", (70_001,)), ("object_A", None, (4, 4))]


def _adam_case(device, seed, aligned=False):
    """A parameter tree (groups text x10, trunk x0.1, base, lstm x10, and a
    frozen leaf with a gradient: the norm only) and three steps' gradients
    on ``device``, made on the CPU: odd sizes, a zero-size leaf, a None
    gradient, a column-sliced gradient (copied), a channels_last conv
    gradient (read through its index map) and a 1x1 one, and a parameter
    and gradient 4 bytes past an aligned address.  Values are normal; with
    ``aligned`` each element of a leaf and of its gradients has one sign,
    drawn per element, and a magnitude in [0.5, 1.5), so that the decay
    adds to the gradient and each moment sums terms of one sign: nothing
    cancels."""
    g = torch.Generator().manual_seed(seed)
    signs = [torch.randint(0, 2, shape, generator=g) * 2.0 - 1 for _, _, shape in ADAM_LEAVES]

    def draw(k):
        shape = ADAM_LEAVES[k][2]
        if aligned:
            return signs[k] * (0.5 + torch.rand(shape, generator=g))
        return torch.randn(shape, generator=g)

    def placed(k, t):
        """``t`` on ``device`` in leaf k's layout."""
        name = ADAM_LEAVES[k][1]
        if name == "col":   # a column slice: not dense
            full = torch.zeros(9, 8)
            full[:, :5] = t
            return full.to(device)[:, :5]
        if name == "view":  # 4 bytes past the allocation
            return torch.cat([torch.zeros(1), t]).to(device)[1:]
        if t.dim() == 4:
            t = t.contiguous(memory_format=torch.channels_last)
        return t.to(device)

    params: dict = {}
    for k, (group, name, _) in enumerate(ADAM_LEAVES):
        t = draw(k)
        t = placed(k, t) if name == "view" else t.to(device)
        if name is None:
            params[group] = t
        else:
            params.setdefault(group, {})[name] = t
    steps = []
    for _ in range(3):
        grads = [placed(k, draw(k)) for k in range(len(ADAM_LEAVES))]
        grads[8] = None
        steps.append(grads)
    return params, steps


# (clip, weight decay): the norm over the clip (scale < 1) and under it, and
# no decay
ADAM_CASES = [(0.5, 1e-3), (1e4, 1e-3), (0.5, 0.0)]
ADAM_IDS = ["clipped", "unclipped", "no-decay"]


def _adam_run(device, algo, clip, wd, seed=0, ok=True):
    """Three steps of the chain on ``device``: (leaves, state) after each."""
    from mgnns_tpu_torch.engine.optim import Optimizer
    from mgnns_tpu_torch.utils import tree_leaves

    params, steps = _adam_case(device, seed)
    opt = Optimizer(params, lr=1e-2, lrp=0.1, weight_decay=wd, grad_clip=clip, algo=algo)
    state = opt.init(params)
    leaves = tree_leaves(params)
    out = [[t.detach().cpu().clone() for t in leaves + opt.tensors(state)]]
    for grads in steps:
        opt.apply(leaves, grads, state, torch.tensor(ok, device=device))
        out.append([t.detach().cpu().clone() for t in leaves + opt.tensors(state)])
    return out


def _chain_f32(p, g, m, v, factor, scale, wd, bc1, bc2, neg_lr):
    """One leaf's step of the chain in engine/optim.py's order, one float32
    numpy operation at a time (each correctly rounded, none fused: torch's
    CPU sqrt and its division by a scalar are not): the arithmetic the
    kernels are written to.  numpy arrays in and out: (p, m, v)."""
    f = np.float32
    g = (np.zeros_like(p) if g is None else g) * scale
    if wd:
        g = g + f(wd) * p
    u = g
    if m is not None:
        m = m * f(0.9) + f(0.1) * g
        v = v * f(0.999) + f(0.001) * (g * g)
        u = (m / bc1) / (np.sqrt(v / bc2) + f(1e-8))
    return p + (u * f(factor)) * neg_lr, m, v


@pytest.mark.cuda
@pytest.mark.parametrize("algo", ["adam", "sgd"])
@pytest.mark.parametrize("clip,wd", ADAM_CASES, ids=ADAM_IDS)
def test_adam_kernels_compute_the_chain(cuda_device, algo, clip, wd):
    """Three steps of the kernels against the chain evaluated on CPU copies
    in the same float32 operations (``_chain_f32``), from the step's norm
    and the schedule's device scalars: every parameter and moment bit for
    bit, whatever its gradient's layout; the norm within 1e-6 of the
    gradients' float64 norm."""
    from mgnns_tpu_torch.engine.optim import Optimizer
    from mgnns_tpu_torch.kernels import adam
    from mgnns_tpu_torch.utils import tree_leaves

    params, steps = _adam_case(cuda_device, 0)
    opt = Optimizer(params, lr=1e-2, lrp=0.1, weight_decay=wd, grad_clip=clip, algo=algo)
    state = opt.init(params)
    leaves = tree_leaves(params)
    host = [t.cpu().numpy().copy() for t in leaves]
    hm = [t.cpu().numpy().copy() for t in state["mu"]] if algo == "adam" else None
    hv = [t.cpu().numpy().copy() for t in state["nu"]] if algo == "adam" else None
    f = np.float32
    for grads in steps:
        matched = adam.match_layouts(leaves, grads)
        have = [i for i, t in enumerate(matched) if t is not None]
        norm = adam.sum_squares([leaves[i] for i in have], [matched[i] for i in have])[1]
        norm = f(norm.item())
        bc1, bc2, neg_lr = (None if t is None else f(t.reshape(()).item())
                            for t in opt._schedule(state["count"]))
        opt.apply(leaves, grads, state, torch.tensor(True, device=cuda_device))
        want_norm = math.sqrt(sum(float((t.double() ** 2).sum()) for t in grads if t is not None))
        assert abs(float(norm) - want_norm) <= 1e-6 * want_norm
        scale = f(1) if norm < f(clip) else (f(1) / norm) * f(clip)
        for k, i in enumerate(opt.trained):
            gi = None if grads[i] is None else grads[i].cpu().numpy()
            host[i], mk, vk = _chain_f32(host[i], gi, None if hm is None else hm[k],
                                         None if hv is None else hv[k], opt.factors[i], scale,
                                         wd, bc1, bc2, neg_lr)
            if hm is not None:
                hm[k], hv[k] = mk, vk
        got = leaves + (state["mu"] + state["nu"] if hm is not None else [])
        for j, (a, b) in enumerate(zip(got, host + (hm + hv if hm is not None else []))):
            assert np.array_equal(a.cpu().numpy(), b), f"tensor {j}"


def _ulp(t: torch.Tensor) -> torch.Tensor:
    """The spacing of float32 values at ``|t|``, in float64."""
    a = t.abs()
    return (torch.nextafter(a, torch.full_like(a, math.inf)) - a).double()


@pytest.mark.cuda
@pytest.mark.parametrize("algo", ["adam", "sgd"])
@pytest.mark.parametrize("clip,wd", ADAM_CASES, ids=ADAM_IDS)
def test_adam_kernels_near_the_plain_chain(cuda_device, algo, clip, wd):
    """Three steps of the kernels against the plain chain
    (``_plain_chain``: ``torch._foreach_*`` and ``torch.where``) on the
    card, each step from the same state (a copy of the kernels'), on
    ``_adam_case``'s aligned values, where nothing cancels: every parameter
    and moment within rtol 1e-6 (atol 1e-12) of the plain chain's, and
    every parameter's step within 1e-6 of the plain chain's step plus one
    unit in the last place of the larger parameter (each rounds the sum
    ``p + step``).  The two need not be bit-equal: the norm's sum runs in another
    order and the card's ``_foreach_*`` kernels fuse some multiply-adds.
    The counters show one update launch, two norm launches and the one
    copied gradient a step."""
    from mgnns_tpu_torch.engine.optim import Optimizer
    from mgnns_tpu_torch.kernels import adam
    from mgnns_tpu_torch.utils import tree_leaves

    params, steps = _adam_case(cuda_device, 2, aligned=True)
    opt = Optimizer(params, lr=1e-2, lrp=0.1, weight_decay=wd, grad_clip=clip, algo=algo)
    state = opt.init(params)
    leaves = tree_leaves(params)
    ok = torch.tensor(True, device=cuda_device)
    adam.launches = adam.norm_launches = 0
    for step, grads in enumerate(steps, 1):
        before = [t.clone() for t in leaves]
        plain = [t.clone() for t in leaves]
        pstate = {k: [t.clone() for t in v] if isinstance(v, list) else v.clone()
                  for k, v in state.items()}
        opt.apply(leaves, grads, state, ok)
        opt._plain_chain(plain, grads, pstate, ok)
        for i, (a, b) in enumerate(zip(leaves + opt.tensors(state), plain + opt.tensors(pstate))):
            a, b = a.double(), b.double()
            err = (a - b).abs() / (1e-6 * b.abs() + 1e-12)
            assert not err.numel() or float(err.max()) <= 1.0, (
                f"step {step}, tensor {i}: {float(err.max())} of the bound")
        for i, (a, b, p0) in enumerate(zip(leaves, plain, before)):
            # the parameters' difference is the steps' difference
            err = (a.double() - b.double()).abs() / (
                1e-6 * (b.double() - p0.double()).abs() + _ulp(torch.maximum(a.abs(), b.abs())))
            assert not err.numel() or float(err.max()) <= 1.0, (
                f"step {step}, leaf {i}'s step: {float(err.max())} of the bound")
    assert (adam.launches, adam.norm_launches, adam.leaves, adam.grad_copies) == (3, 6, 11, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("algo", ["adam", "sgd"])
def test_adam_kernels_near_the_cpu_chain(cuda_device, algo):
    """Three steps of the kernels against the plain chain on CPU copies of
    the same tensors in the clipped case, where the decay term cancels the
    clipped gradient (``wd * p`` and ``g * scale`` of one size): each
    tensor within 1e-4 of its largest magnitude.  The CPU's
    ``torch._foreach_*`` kernels fuse multiply-adds and its norm sums in
    another order, and where ``g * scale + wd * p`` cancels, Adam's
    division by ``sqrt(v) + eps`` carries the last bits into the step (up
    to 1.9e-5 of scale).  It prints, for each step and kind of tensor, the
    elements beyond rtol 1e-6, and for the first step how many of them sit
    where a sum cancelled to under half its terms' magnitude (``g * scale
    + wd * p`` for the moments, ``p + step`` for the parameters) and the
    two norms' errors against float64."""
    from mgnns_tpu_torch.kernels import adam
    from mgnns_tpu_torch.utils import tree_leaves

    clip, wd = 0.5, 1e-3
    got = _adam_run(cuda_device, algo, clip, wd)
    want = _adam_run(torch.device("cpu"), algo, clip, wd)
    n_leaves = len(ADAM_LEAVES)
    trained = [k for k, (group, _, _) in enumerate(ADAM_LEAVES) if group != "object_A"]
    # each tensor of a step's list: (kind, leaf)
    kinds = [("p", k) for k in range(n_leaves)] + [("count", None)]
    if algo == "adam":
        kinds += [("mu", k) for k in trained] + [("nu", k) for k in trained]
    # the first step's norms and each element's cancellation
    _, steps = _adam_case(torch.device("cpu"), 0)
    present = [t for t in steps[0] if t is not None]
    exact = math.sqrt(sum(float((t.double() ** 2).sum()) for t in present))
    cpu_norm = float(torch.linalg.vector_norm(torch.stack(torch._foreach_norm(present))))
    card, card_steps = _adam_case(cuda_device, 0)
    leaves = tree_leaves(card)
    matched = adam.match_layouts(leaves, card_steps[0])
    have = [i for i, t in enumerate(matched) if t is not None]
    card_norm = float(adam.sum_squares([leaves[i] for i in have],
                                       [matched[i] for i in have])[1])
    scale = min(1.0, clip / exact)
    p0 = [t.double() for t in want[0][:n_leaves]]
    cancelled = {}
    for k in trained:
        gs = steps[0][k].double() * scale if steps[0][k] is not None else 0 * p0[k]
        cancelled[("mu", k)] = cancelled[("nu", k)] = (
            (gs + wd * p0[k]).abs() < 0.5 * (gs.abs() + wd * p0[k].abs()))
        p1 = want[1][k].double()
        cancelled[("p", k)] = p1.abs() < 0.5 * (p0[k].abs() + (p1 - p0[k]).abs())
    for step in range(1, len(want)):
        far: dict = {}
        for i, (x, y) in enumerate(zip(got[step], want[step])):
            if not y.numel():
                continue
            err = float((x - y).abs().max()) / max(float(y.abs().max()), 1e-30)
            assert err <= 1e-4, f"step {step}, tensor {i}: {err} of scale"
            beyond = (x.double() - y.double()).abs() > 1e-6 * y.double().abs() + 1e-12
            kind = kinds[i][0]
            n, c = far.get(kind, (0, 0))
            cut = int(cancelled[kinds[i]][beyond].sum()) if kinds[i] in cancelled else 0
            far[kind] = (n + int(beyond.sum()), c + cut)
        total = sum(t.numel() for t in want[step][:n_leaves])
        said = {k: v[0] for k, v in far.items()} if step > 1 else far
        print(f"{algo}, clipped, step {step}: elements beyond rtol 1e-6 of the CPU chain "
              f"{said} of {total} a kind"
              + (" (beyond, of which where a sum cancelled); the norms' relative errors "
                 f"against float64: kernels {abs(card_norm - exact) / exact}, CPU chain "
                 f"{abs(cpu_norm - exact) / exact}" if step == 1 else ""))


@pytest.mark.cuda
def test_adam_kernels_are_deterministic_and_capture(cuda_device):
    """Two runs of the kernels give the same bits, and so do three replays
    of a captured step against three eager ones."""
    from mgnns_tpu_torch.engine.optim import Optimizer
    from mgnns_tpu_torch.utils import tree_leaves

    first, second = (_adam_run(cuda_device, "adam", 0.5, 1e-3) for _ in range(2))
    for a, b in zip(first[-1], second[-1]):
        assert torch.equal(a, b)
    params, steps = _adam_case(cuda_device, 0)
    grads = steps[0]
    opt = Optimizer(params, lr=1e-2, grad_clip=0.5)
    state = opt.init(params)
    leaves = tree_leaves(params)
    flag = torch.tensor(False, device=cuda_device)
    opt.update(leaves, grads, state, flag, True)  # held: the constants made, nothing moved
    assert int(state["count"]) == 0
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        opt.update(leaves, grads, state, flag, True)
    flag.fill_(True)
    for _ in range(3):
        graph.replay()
    eager_params, _ = _adam_case(cuda_device, 0)
    eager = Optimizer(eager_params, lr=1e-2, grad_clip=0.5)
    estate = eager.init(eager_params)
    eleaves = tree_leaves(eager_params)
    for _ in range(3):
        eager.apply(eleaves, grads, estate, torch.tensor(True, device=cuda_device))
    torch.cuda.synchronize()
    for a, b in zip(leaves + opt.tensors(state), eleaves + eager.tensors(estate)):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_adam_kernels_store_nothing_where_ok_is_false(cuda_device):
    """A step whose flag is false, after one that moved everything, leaves
    every parameter and state tensor bit-equal, its gradients non-finite."""
    from mgnns_tpu_torch.engine.optim import Optimizer
    from mgnns_tpu_torch.utils import tree_leaves

    params, steps = _adam_case(cuda_device, 1)
    opt = Optimizer(params, lr=1e-2, grad_clip=0.5)
    state = opt.init(params)
    leaves = tree_leaves(params)
    opt.apply(leaves, steps[0], state, torch.tensor(True, device=cuda_device))
    before = [t.clone() for t in leaves + opt.tensors(state)]
    bad = [None if t is None else torch.full_like(t, float("nan")) for t in steps[1]]
    opt.apply(leaves, bad, state, torch.tensor(False, device=cuda_device))
    torch.cuda.synchronize()
    for a, b in zip(before, leaves + opt.tensors(state)):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_guarded_copy_kernel(cuda_device):
    """``select_`` on the card: one launch copies every tensor byte for byte
    where the flag holds (and for None), keeps every one where it does not
    (NaN sources included), and takes odd sizes, an unaligned view, another
    dtype and a source laid out unlike its target."""
    from mgnns_tpu_torch.engine.optim import select_
    from mgnns_tpu_torch.kernels import adam

    def case():
        g = torch.Generator(device=cuda_device).manual_seed(4)
        olds = [torch.randn(5, device=cuda_device, generator=g),
                torch.randn(1 + 70_001, device=cuda_device, generator=g)[1:],
                torch.randint(0, 9, (13,), device=cuda_device, generator=g, dtype=torch.int64),
                torch.randn(0, device=cuda_device), torch.randn(4, 6, device=cuda_device,
                                                                generator=g)]
        news = [torch.full((5,), float("nan"), device=cuda_device),
                torch.randn(70_001, device=cuda_device, generator=g),
                torch.randint(0, 9, (13,), device=cuda_device, generator=g, dtype=torch.int64),
                torch.randn(0, device=cuda_device),
                torch.randn(6, 4, device=cuda_device, generator=g).t()]
        return olds, news

    for ok in (False, True, None):
        olds, news = case()
        kept = [t.clone() for t in olds]
        adam.select_launches = 0
        select_(olds, news, None if ok is None else torch.tensor(ok, device=cuda_device))
        torch.cuda.synchronize()
        assert adam.select_launches == 1
        for old, new, k in zip(olds, news, kept):
            want = k if ok is False else new
            assert torch.equal(old.view(-1).view(torch.uint8) if old.numel() else old,
                               want.reshape(-1).view(torch.uint8) if old.numel() else want)


@pytest.mark.cuda
def test_fusion_step_updates_every_leaf_in_one_launch(cuda_device):
    """One Engine step of the 64 px fusion model: every trained leaf in one
    update launch, the norm in two, the BN statistics' guarded copy in one;
    the gradients copied to match their parameters are counted (printed)."""
    from mgnns_tpu_torch.engine.metrics import confusion_init
    from mgnns_tpu_torch.kernels import adam

    engine, _, batches = _fusion_plan_engine(cuda_device, 0.0)
    adam.launches = adam.norm_launches = adam.select_launches = 0
    engine.train_step(batches[0], confusion_init(7, cuda_device))
    torch.cuda.synchronize()
    print(f"fusion step: {adam.leaves} trained leaves, {adam.grad_copies} gradients copied")
    assert adam.leaves == len(engine.opt.trained) > 600
    assert (adam.launches, adam.norm_launches, adam.select_launches) == (1, 2, 1)
