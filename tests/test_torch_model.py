"""The port's models and Predictor against the JAX package, on the CPU.

Weights are made by the JAX package's own initializers, converted with
``mgnns_tpu_torch.convert``; inputs come from numpy seeds and go to both.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mgnns_tpu.config import ModelConfig as JModelConfig
from mgnns_tpu.config import TextGraphConfig as JTextGraphConfig
from mgnns_tpu.graphs.cooccur import gen_A
from mgnns_tpu.graphs.pmi import cal_pmi
from mgnns_tpu.graphs.vocab import build_vocab, make_word_to_id
from mgnns_tpu.data.text import encode_texts as j_encode_texts
from mgnns_tpu.models import mgnns_apply as j_mgnns_apply
from mgnns_tpu.models import text_model_apply as j_text_model_apply
from mgnns_tpu.models import text_model_init as j_text_model_init
from mgnns_tpu.models.mgnns import mgnns_init as j_mgnns_init
from mgnns_tpu.serving import Predictor as JPredictor

from mgnns_tpu_torch import convert
from mgnns_tpu_torch.config import ModelConfig, TextGraphConfig
from mgnns_tpu_torch.graphs.pmi import PmiGraph
from mgnns_tpu_torch.models.mgnns import mgnns_apply, mgnns_init
from mgnns_tpu_torch.models.text_only import text_model_apply
from mgnns_tpu_torch.serving import Predictor

CORPUS = ["the cat sat on the mat", "a dog met a cat", "the mat sat still",
          "dogs and cats and logs"]
LABELS = {f"l{i}": i for i in range(7)}
CPU = "cpu"


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def fusion():
    """The JAX fusion model at the shapes of tests/test_full_parity.py:303
    (image 64, 5/6 classes, L=10, ngram 2), its converted port twin, and a
    parity batch."""
    L, ngram, obj_c, plc_c = 10, 2, 5, 6
    vocab = build_vocab(CORPUS, 1)
    graph = cal_pmi(CORPUS, vocab, ngram + 1, 1, max_len=L)
    r = np.random.default_rng(0)
    kw = dict(vocab_size=len(vocab), edges_num=graph.num_edges, image_size=64,
              object_num_classes=obj_c, place_num_classes=plc_c)
    jcfg, cfg = JModelConfig(**kw), ModelConfig(**kw)
    oA, _ = gen_A(obj_c, 0.4, {"nums": r.integers(1, 5, obj_c).astype(float),
                               "adj": r.integers(0, 4, (obj_c, obj_c)).astype(float)})
    pA, _ = gen_A(plc_c, 0.3, {"nums": r.integers(1, 5, plc_c).astype(float),
                               "adj": r.integers(0, 4, (plc_c, plc_c)).astype(float)})
    label_emb = r.standard_normal((7, 300)).astype(np.float32)
    object_inp = r.standard_normal((obj_c, 300)).astype(np.float32)
    place_inp = r.standard_normal((plc_c, 300)).astype(np.float32)
    jparams, jstate, jconsts = j_mgnns_init(
        jax.random.key(0), jcfg, num_edges=graph.num_edges,
        label_embedding=label_emb, object_A=oA, place_A=pA)
    gcfg = JTextGraphConfig(ngram=ngram, max_len=L)
    ids, lens, mask, eids = j_encode_texts(CORPUS, make_word_to_id(vocab), graph, gcfg)
    batch = {"ids": ids, "lens": lens, "mask": mask, "eids": eids,
             "image": r.standard_normal((len(CORPUS), 64, 64, 3)).astype(np.float32)}
    params, stats, consts = convert.from_jax_params(
        _np(jparams), _np(jstate),
        dict(_np(jconsts), object_inp=object_inp, place_inp=place_inp), device=CPU)
    return dict(vocab=vocab, graph=graph, jcfg=jcfg, cfg=cfg, gcfg=gcfg,
                jparams=jparams, jstate=jstate, jconsts=jconsts,
                object_inp=object_inp, place_inp=place_inp,
                params=params, stats=stats, consts=consts, batch=batch)


def _jax_logits(f, batch):
    full = {k: jnp.asarray(v) for k, v in batch.items()}
    full["object_inp"] = jnp.asarray(f["object_inp"])
    full["place_inp"] = jnp.asarray(f["place_inp"])
    logits, _, _ = j_mgnns_apply(f["jparams"], f["jstate"], f["jconsts"], full,
                                 cfg=f["jcfg"], train=False)
    return np.asarray(logits)


@pytest.mark.parametrize("image", ["float", "uint8"])
def test_fusion_logits_match_jax(fusion, image):
    """Full-model logits within the tolerance of tests/test_full_parity.py
    (atol 5e-3, rtol 1e-3: float32 reductions in another order through two
    ResNet trunks), for normalized float images and raw uint8 pixels."""
    batch = dict(fusion["batch"])
    if image == "uint8":
        batch["image"] = np.random.default_rng(1).integers(
            0, 256, batch["image"].shape, dtype=np.uint8)
    want = _jax_logits(fusion, batch)
    with torch.inference_mode():
        got = mgnns_apply(fusion["params"], fusion["stats"], fusion["consts"],
                          {k: torch.from_numpy(v) for k, v in batch.items()},
                          cfg=fusion["cfg"])[0].numpy()
    assert got.shape == (len(CORPUS), 7) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=5e-3, rtol=1e-3)


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_shapes(v) for v in tree]
    return (tuple(tree.shape), tree.dtype)


def test_mgnns_init_shapes_match_jax(fusion):
    """The port's seeded init builds the tree the converter builds from the
    JAX package's init: same keys, shapes and dtypes."""
    f = fusion
    r = np.random.default_rng(2)
    params, stats, consts = mgnns_init(
        f["cfg"], num_edges=f["graph"].num_edges,
        label_embedding=r.standard_normal((7, 300)),
        object_A=np.asarray(f["jparams"]["object_A"]), place_A=np.asarray(f["jparams"]["place_A"]),
        object_inp=f["object_inp"], place_inp=f["place_inp"], seed=3, device=CPU)
    assert _shapes(params) == _shapes(f["params"])
    assert _shapes(stats) == _shapes(f["stats"])
    assert _shapes(consts) == _shapes(f["consts"])
    assert (params["embedding"]["table"][0] == 0).all()


@pytest.fixture(scope="module")
def text_model(fusion):
    jparams = j_text_model_init(jax.random.key(1), len(fusion["vocab"]), 7,
                                fusion["graph"].num_edges)
    return jparams, convert.text_model_from_jax_params(_np(jparams), device=CPU)


def test_text_model_logits_match_jax(fusion, text_model):
    jparams, params = text_model
    batch = fusion["batch"]
    want = np.asarray(j_text_model_apply(
        jparams, {k: jnp.asarray(batch[k]) for k in ("ids", "lens", "eids")}, ngram=2))
    with torch.inference_mode():
        got = text_model_apply(params, {k: torch.from_numpy(batch[k])
                                        for k in ("ids", "lens", "eids")}, ngram=2).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


RECORDS = [{"id": f"r{i}", "text": t} for i, t in enumerate(
    CORPUS + ["the cat met a dog", "", "logs and mats sat", "unseen words only"])]


def _port_graph(graph):
    return PmiGraph(graph.vocab_size, graph.keys, graph.pmi)


@pytest.mark.parametrize("text_only", [False, True], ids=["fusion", "text_only"])
def test_predictor_matches_jax_predictor(fusion, text_model, text_only):
    """Both Predictors answer the same 8 records in 3 chunks of max_batch 3
    (one bucket, so JAX compiles once); labels agree where the top-2 gap
    exceeds 1e-2, probabilities within 1e-4."""
    f = fusion
    common = dict(vocab=f["vocab"], label_map=LABELS, image_backend="synthetic",
                  max_batch=3, text_only=text_only, batch_buckets=[3])
    if text_only:
        jparams, params = text_model

        def apply_fn(p, bs, batch):
            return j_text_model_apply(p, batch, ngram=2)

        jpred = JPredictor(graph=f["graph"], graph_cfg=f["gcfg"], apply_fn=apply_fn,
                           params=jparams, batch_stats={}, **common)
        pred = Predictor(graph=_port_graph(f["graph"]), graph_cfg=TextGraphConfig(ngram=2, max_len=10),
                         params=params, device=CPU, **common)
    else:
        object_inp, place_inp = jnp.asarray(f["object_inp"]), jnp.asarray(f["place_inp"])

        def apply_fn(p, bs, batch):
            full = dict(batch, object_inp=object_inp, place_inp=place_inp)
            return j_mgnns_apply(p, bs, f["jconsts"], full, cfg=f["jcfg"], train=False)[0]

        jpred = JPredictor(graph=f["graph"], graph_cfg=f["gcfg"], apply_fn=apply_fn,
                           params=f["jparams"], batch_stats=f["jstate"],
                           image_size=64, **common)
        pred = Predictor(graph=_port_graph(f["graph"]), graph_cfg=TextGraphConfig(ngram=2, max_len=10),
                         params=f["params"], batch_stats=f["stats"], consts=f["consts"],
                         cfg=f["cfg"],
                         device=CPU, **common)
    want = jpred.predict(RECORDS)
    got = pred.predict(RECORDS)
    pred.close()
    assert len(got) == len(RECORDS)
    for g_, w_ in zip(got, want):
        pg, pw = np.array(list(g_["probs"].values())), np.array(list(w_["probs"].values()))
        np.testing.assert_allclose(pg, pw, atol=1e-4)
        assert abs(pg.sum() - 1.0) < 1e-5
        top2 = np.sort(pw)[-2:]
        if top2[1] - top2[0] > 1e-2:
            assert g_["label"] == w_["label"]
