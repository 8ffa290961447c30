"""The port's host side against the JAX package's, array for array, on a
seeded synthetic corpus: vocabulary, PMI graph, window edge ids, request
encoding, label graphs, synthetic images, batch buckets and the preproc
artifacts (which each package must read from the other)."""

import os

import numpy as np
import pytest
import torch

from mgnns_tpu.config import TextGraphConfig as JTextGraphConfig
from mgnns_tpu.data import images as jimages
from mgnns_tpu.data.text import encode_texts as j_encode_texts
from mgnns_tpu.graphs import cooccur as jcooccur
from mgnns_tpu.graphs import pmi as jpmi
from mgnns_tpu.graphs import vocab as jvocab
from mgnns_tpu import serving as jserving

from mgnns_tpu_torch import serving
from mgnns_tpu_torch.config import TextGraphConfig
from mgnns_tpu_torch.data import images
from mgnns_tpu_torch.data.text import encode_texts
from mgnns_tpu_torch.graphs import cooccur, pmi, vocab


@pytest.fixture(scope="module")
def corpus():
    """600 documents of 1-120 tokens, Zipf-like over 400 words (some docs
    exceed max_len and are dropped from the PMI counts)."""
    r = np.random.default_rng(0)
    words = np.array([f"w{i}" for i in range(400)])
    p = 1.0 / np.arange(1, 401) ** 1.1
    p /= p.sum()
    return [" ".join(r.choice(words, size=r.integers(1, 121), p=p)) for _ in range(600)]


@pytest.fixture(scope="module")
def graphs(corpus):
    v = vocab.build_vocab(corpus, 2)
    return v, jpmi.cal_pmi(corpus, v, 6, 2), pmi.cal_pmi(corpus, v, 6, 2)


def test_vocab_matches(corpus):
    assert vocab.build_vocab(corpus, 2) == jvocab.build_vocab(corpus, 2)
    assert vocab.words_to_ids(["w0", "zzz"], vocab.make_word_to_id(["PAD", "UNK", "w0"])) == [2, 1]


def test_cal_pmi_matches(graphs):
    _, jg, g = graphs
    assert g.vocab_size == jg.vocab_size and g.num_edges == jg.num_edges > 100
    np.testing.assert_array_equal(g.keys, jg.keys)
    np.testing.assert_array_equal(g.pmi, jg.pmi)


@pytest.mark.parametrize("ngram", [2, 4])
def test_doc_window_edge_ids_match(corpus, graphs, ngram):
    v, jg, g = graphs
    w2i = vocab.make_word_to_id(v)
    L = 100
    ids = np.zeros((64, L), np.int32)
    lens = np.zeros(64, np.int32)
    for n, t in enumerate(corpus[:64]):
        toks = vocab.words_to_ids(t.split(" "), w2i)[:L]
        ids[n, : len(toks)] = toks
        lens[n] = len(toks)
    got = pmi.doc_window_edge_ids(ids, lens, ngram, g)
    assert got.any()
    np.testing.assert_array_equal(got, jpmi.doc_window_edge_ids(ids, lens, ngram, jg))


def test_encode_texts_matches(corpus, graphs):
    v, jg, g = graphs
    w2i = vocab.make_word_to_id(v)
    texts = corpus[:40] + ["", "unseen words only", " ".join(["w1"] * 150)]
    got = encode_texts(texts, w2i, g, TextGraphConfig())
    want = j_encode_texts(texts, w2i, jg, JTextGraphConfig())
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert got[1].min() == 1 and got[1].max() == 100  # lens clamped to [1, L]


@pytest.mark.parametrize("C,t", [(80, 0.4), (365, 0.3)])
def test_gen_A_matches(C, t):
    r = np.random.default_rng(C)
    data = {"nums": r.integers(1, 50, C).astype(float),
            "adj": r.integers(0, 30, (C, C)).astype(float)}
    for a, b in zip(cooccur.gen_A(C, t, data), jcooccur.gen_A(C, t, data)):
        np.testing.assert_array_equal(a, b)
    A = cooccur.gen_A(C, t, data)[0]
    np.testing.assert_allclose(cooccur.gen_adj(torch.from_numpy(A)).numpy(),
                               np.asarray(jcooccur.gen_adj(A)), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("key,size", [("a", 448), ("post-17", 64), ("", 13)])
def test_synthetic_image_bit_exact(key, size):
    got = images.synthetic_image_uint8(key, size)
    assert got.dtype == np.uint8 and got.shape == (size, size, 3)
    np.testing.assert_array_equal(got, jimages.synthetic_image_uint8(key, size))


def test_load_image_uint8(tmp_path):
    from PIL import Image

    path = str(tmp_path / "x.png")
    Image.fromarray(np.random.default_rng(0).integers(0, 256, (30, 50, 3), dtype=np.uint8)).save(path)
    np.testing.assert_array_equal(
        images.load_image_uint8(path, size=32, backend="pil"),
        jimages.load_image_uint8(path, size=32, train=False, rng=None, backend="pil"))
    missing = str(tmp_path / "missing.jpg")
    np.testing.assert_array_equal(
        images.load_image_uint8(missing, size=16, backend="pil", sample_key="k"),
        images.synthetic_image_uint8("k", 16))


@pytest.mark.parametrize("requested,max_batch", [(None, 16), (None, 64), ([2, 8], 16), ([5], 5)])
def test_resolve_batch_buckets_matches(requested, max_batch):
    assert serving.resolve_batch_buckets(requested, max_batch) == \
        jserving.resolve_batch_buckets(requested, max_batch, 1)


def test_resolve_batch_buckets_rejects():
    with pytest.raises(ValueError):
        serving.resolve_batch_buckets([32], 16)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_preproc_artifacts_interchange(tmp_path, graphs, writer):
    """Each package reads the preproc artifacts the other writes."""
    v, jg, g = graphs
    labels = {"happy": 0, "sad": 1}
    d = str(tmp_path / writer)
    if writer == "port":
        serving.save_preproc(d, v, g, labels, TextGraphConfig(ngram=3))
        out = jserving.load_preproc(d)
    else:
        jserving.save_preproc(d, v, jg, labels, JTextGraphConfig(ngram=3))
        out = serving.load_preproc(d)
    v2, g2, labels2, cfg2 = out
    assert v2 == v and labels2 == labels and cfg2.ngram == 3
    np.testing.assert_array_equal(g2.keys, g.keys)
    np.testing.assert_array_equal(g2.pmi, g.pmi)
    assert serving.load_preproc(os.path.join(d, "absent")) is None
