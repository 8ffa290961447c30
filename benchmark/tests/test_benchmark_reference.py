"""The reference and the benchmark's own inputs against the port, on the CPU
at small sizes, and the closed-form FLOPs against ``FlopCounterMode``."""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import data as D
from benchmark import flops as F
from benchmark import program as P
from benchmark import weights as W
from benchmark.mixes import train_epochs as TE
from benchmark.reference import model as R
from benchmark.reference import text as T
from benchmark.tests.tiny import tiny_cell

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def fusion():
    cell = tiny_cell("mgnns-tumemo.train-b16", compute_dtype="float32", bn_mode="frozen")
    cfg = cell.config
    vocab, docs, keys, pmi = D.text_side(cfg)
    params, stats, consts = W.fusion_weights(cfg, len(keys) + 1, D.constants(cfg, 5), 5, "cpu")
    recs = D.records(cfg, 4, 5)
    batch = TE.reference_batch(cfg, recs, vocab, keys, "cpu")
    return cell, vocab, keys, params, stats, consts, batch


def test_inputs_equal_the_ports():
    from mgnns_tpu_torch.data.images import synthetic_image_uint8
    from mgnns_tpu_torch.data.text import encode_texts
    from mgnns_tpu_torch.graphs.pmi import cal_pmi
    from mgnns_tpu_torch.graphs.vocab import make_word_to_id

    cfg = tiny_cell("mgnns-tumemo.train-b16").config
    vocab, docs, keys, pmi = D.text_side(cfg)
    graph = cal_pmi(docs, vocab, window_size=cfg["window_size"],
                    min_cooccurrence=cfg["min_cooccurrence"], max_len=cfg["max_len"])
    np.testing.assert_array_equal(graph.keys, keys)
    np.testing.assert_array_equal(graph.pmi, pmi)
    texts = docs[:20] + ["w0 unknownword w1 w1 w0", ""]
    ours = T.encode(texts, vocab, keys, cfg["max_len"], cfg["ngram"])
    theirs = encode_texts(texts, make_word_to_id(vocab), graph, P.graph_config(cfg))
    for k, v in zip(("ids", "lens", "mask", "eids"), theirs):
        np.testing.assert_array_equal(ours[k], v)
    np.testing.assert_array_equal(T.synthetic_pixels("r1-2", 40), synthetic_image_uint8("r1-2", 40))


def test_decoded_pixels_equal_the_ports(tmp_path):
    from mgnns_tpu_torch.data.images import load_image_uint8

    names = D.write_jpegs(str(tmp_path), 2, 20, 60, 3)
    for n in names:
        path = os.path.join(tmp_path, n)
        np.testing.assert_array_equal(T.decoded_pixels(path, 32),
                                      load_image_uint8(path, size=32, backend="pil"))


def test_fusion_forward_equals_the_ports(fusion):
    from mgnns_tpu_torch.models.mgnns import mgnns_apply

    cell, vocab, keys, params, stats, consts, batch = fusion
    cfg = cell.config
    mcfg = P.model_config(cfg, cell.params, len(keys) + 1)
    with torch.no_grad():
        ref, _ = R.fusion_forward(params, stats, consts, batch, cfg)
        got, _, _ = mgnns_apply(params, stats, consts, batch, cfg=mcfg)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)


def test_text_forward_equals_the_ports():
    from mgnns_tpu_torch.models.text_only import text_model_apply

    cell = tiny_cell("textgcn-tumemo.serve-poisson")
    cfg = cell.config
    vocab, docs, keys, _ = D.text_side(cfg)
    params = W.text_weights(cfg, len(keys) + 1, 9, "cpu")
    enc = T.encode(docs[:6], vocab, keys, cfg["max_len"], cfg["ngram"])
    batch = {k: torch.as_tensor(v) for k, v in enc.items()}
    with torch.no_grad():
        torch.testing.assert_close(text_model_apply(params, batch, ngram=cfg["ngram"]),
                                   R.text_forward(params, batch), rtol=1e-6, atol=1e-6)


def test_train_step_equals_the_ports(fusion):
    """One step from the same weights, dropout masks and all: the loss and
    the gradient the optimizer got, leaf by leaf, and the parameters after."""
    from mgnns_tpu_torch.engine.metrics import confusion_init
    from mgnns_tpu_torch.engine.train import Engine

    cell, vocab, keys, params, stats, consts, batch = fusion
    cfg, wl = cell.config, cell.params
    opt = wl["optimizer"]
    eng = Engine(P.fusion_apply(P.model_config(cfg, wl, len(keys) + 1), consts),
                 TE.clone(params), TE.clone(stats), num_classes=cfg["num_labels"], lr=opt["lr"],
                 lrp=opt["lrp"], weight_decay=opt["weight_decay"], grad_clip=opt["grad_clip"],
                 seed=11, device="cpu")
    prog = {k: v for k, v in batch.items()}
    prog["weight"] = prog["weight"].numpy()
    prog["label"] = prog["label"].numpy()
    loss = float(eng.train_step(prog, confusion_init(cfg["num_labels"], "cpu")))
    p, s = TE.clone(params), TE.clone(stats)
    adam = R.Adam(p, opt)
    ref_loss, got = R.fusion_train_step(p, s, consts, batch, dict(cfg, bn_mode="frozen"), adam,
                                        R.derive_seed(11, 0), torch.float32)
    assert loss == pytest.approx(ref_loss, rel=1e-6)
    paths = R.paths(eng.params)
    mine = dict(zip(adam.names, got))
    for m, i in zip(eng.opt_state["mu"], eng.opt.trained):
        torch.testing.assert_close(m / 0.1, mine[paths[i]], rtol=1e-4, atol=1e-6)
    for a, b in zip(R.leaves(eng.params), R.leaves(p)):
        torch.testing.assert_close(a, b, rtol=0, atol=2 * opt["lr"] * 10)


def test_closed_form_flops_equal_flop_counter():
    """At 64 px, so that the trunks' features have more than one pixel (an
    einsum over one key runs as a product of elements, which the counter
    does not see)."""
    cell = tiny_cell("mgnns-tumemo.train-b16", compute_dtype="float32", bn_mode="frozen")
    cfg = dict(cell.config, image_size=64)
    vocab, docs, keys, pmi = D.text_side(cfg)
    params, stats, consts = W.fusion_weights(cfg, len(keys) + 1, D.constants(cfg, 5), 5, "cpu")
    batch = TE.reference_batch(cfg, D.records(cfg, 2, 5), vocab, keys, "cpu")
    B = batch["ids"].shape[0]
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        R.fusion_forward(params, stats, consts, batch, cfg)
    assert counter.get_total_flops() == F.forward_flops(cfg, B)
    adam = R.Adam(params, cell.params["optimizer"])
    with FlopCounterMode(display=False) as counter:
        R.fusion_train_step(TE.clone(params), TE.clone(stats), consts, batch,
                            dict(cfg, bn_mode="frozen"), adam, 3, torch.float32)
    assert counter.get_total_flops() == F.train_step_flops(cfg, B)
    text = W.text_weights(cfg, len(keys) + 1, 1, "cpu")
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        R.text_forward(text, batch)
    assert counter.get_total_flops() == F.text_forward_flops(cfg, B)
