"""The port's native host preprocessing (``mgnns_tpu_torch/native.py``, the
library built from ``mgnns_tpu_torch/csrc/host_preproc.cpp``) against the
JAX package's (``mgnns_tpu/native.py`` on ``native/libhost_preproc.so``) and
against the port's numpy paths, array for array, on seeded Zipf corpora
with out-of-vocabulary tokens (-1), empty documents and documents of
length L-1 and L; then its build: where the library lands, a compiler that
fails, and no compiler at all."""

import hashlib
import os

import numpy as np
import pytest

from mgnns_tpu import native as jnative
from mgnns_tpu.graphs import pmi as jpmi

from mgnns_tpu_torch import native
from mgnns_tpu_torch.graphs import pmi, vocab
from mgnns_tpu_torch.kernels import build

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
L, V = 24, 60


def _ids(seed: int) -> tuple[np.ndarray, np.ndarray]:
    """[120, L] ids over a V-word Zipf vocabulary (1 .. V-1), one token in
    ten out of vocabulary (-1), PAD (0) after each document's length; the
    first documents are empty, of length L-1 and of length L."""
    r = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, V) ** 1.1
    lens = r.integers(0, L + 1, 120).astype(np.int32)
    lens[:5] = [0, L - 1, L, 0, L]
    ids = np.zeros((len(lens), L), np.int32)
    for i, k in enumerate(lens):
        toks = r.choice(np.arange(1, V), size=k, p=p / p.sum()).astype(np.int32)
        toks[r.random(k) < 0.1] = -1
        ids[i, :k] = toks
    return ids, lens


def _digest(directory: str) -> dict:
    out = {}
    for name in sorted(os.listdir(directory)):
        with open(os.path.join(directory, name), "rb") as f:
            out[name] = hashlib.sha256(f.read()).hexdigest()
    return out


@pytest.fixture
def forced(monkeypatch):
    """Both packages' native counters at any corpus size."""
    monkeypatch.setattr(native, "_NATIVE_PAIR_THRESHOLD", 0)
    monkeypatch.setattr(jnative, "_NATIVE_PAIR_THRESHOLD", 0)


@pytest.mark.parametrize("ngram", [0, 1, 4])
@pytest.mark.parametrize("window", [1, 3, 6])
@pytest.mark.parametrize("seed", [0, 1])
def test_native_equals_the_jax_package_and_numpy(forced, seed, window, ngram):
    """``pmi_pair_count`` (keys, counts, word counts) and ``window_edge_ids``
    of the port's library equal the JAX package's library and the port's
    numpy versions exactly."""
    assert native.available() and jnative.available()
    ids, lens = _ids(seed)
    got = native.pmi_pair_count(ids, V, window)
    for want in (jnative.pmi_pair_count(ids, V, window),
                 native.pmi_pair_count_numpy(ids, V, window)):
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    keys = got[0][got[1] >= 2]  # a graph's edges: the pairs seen twice
    graph = pmi.PmiGraph(V, keys, np.ones(len(keys), np.float32))
    eids = native.window_edge_ids(ids, lens, ngram, keys, V)
    assert eids.shape == (len(ids), L, 2 * ngram + 1) and eids.dtype == np.int32
    assert eids.any() or ngram == 0
    np.testing.assert_array_equal(eids, jnative.window_edge_ids(ids, lens, ngram, keys, V))
    np.testing.assert_array_equal(eids, pmi.doc_window_edge_ids_numpy(ids, lens, ngram, graph))
    np.testing.assert_array_equal(eids, pmi.doc_window_edge_ids(ids, lens, ngram, graph))


def test_pair_count_regrows_an_overflowing_table(forced, monkeypatch):
    """At a first capacity of one pair the table overflows and grows x4 until
    it holds every distinct pair; the answer is the numpy one."""
    ids, _ = _ids(2)
    lib = native._load()
    caps = []

    class Spy:
        def __getattr__(self, name):
            return getattr(lib, name)

        def pmi_pair_count(self, *args):
            caps.append(args[7])
            return lib.pmi_pair_count(*args)

    monkeypatch.setattr(native, "FIRST_CAPACITY", (1, 1))
    monkeypatch.setattr(native, "_load", Spy)
    got = native.pmi_pair_count(ids, V, 3)
    want = native.pmi_pair_count_numpy(ids, V, 3)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert caps[0] == 1 and len(caps) > 3
    assert all(b == 4 * a for a, b in zip(caps, caps[1:]))
    assert caps[-2] < len(want[0]) <= caps[-1]


def test_cal_pmi_equals_the_jax_package(forced, monkeypatch):
    """``cal_pmi`` on the native counter equals ``mgnns_tpu.graphs.pmi.
    cal_pmi`` and the port's numpy run, keys and PMI values exactly."""
    r = np.random.default_rng(3)
    words = np.array([f"w{i}" for i in range(300)])
    p = 1.0 / np.arange(1, 301) ** 1.1
    texts = [" ".join(r.choice(words, size=r.integers(0, 40), p=p / p.sum()))
             for _ in range(400)]
    v = vocab.build_vocab(texts, 3)  # rare words out of vocabulary
    got = pmi.cal_pmi(texts, v, 6, 2, max_len=30)
    want = jpmi.cal_pmi(texts, v, 6, 2, max_len=30)
    monkeypatch.setattr(native, "_load", lambda: None)
    plain = pmi.cal_pmi(texts, v, 6, 2, max_len=30)
    assert got.num_edges == want.num_edges == plain.num_edges > 100
    for other in (want, plain):
        np.testing.assert_array_equal(got.keys, other.keys)
        np.testing.assert_array_equal(got.pmi, other.pmi)


def test_window_edge_ids_refuses_lengths_past_the_row():
    ids, lens = _ids(0)
    lens = lens.copy()
    lens[7] = L + 1
    with pytest.raises(ValueError, match="exceeds the 24 columns"):
        native.window_edge_ids(ids, lens, 2, np.arange(5, dtype=np.int64), V)


def test_library_lands_in_the_build_directory_and_native_is_untouched(tmp_path, monkeypatch):
    """The library comes from the port's source into ``build/torch_ext/``
    (its log beside it); a fresh build elsewhere writes nothing under
    ``native/``, and the JAX package's library is never what the port loads."""
    before = _digest(os.path.join(ROOT, "native"))
    lib = build.load_host("host_preproc")
    path = lib.lib._name
    assert os.path.dirname(path) == os.path.join(ROOT, "build", "torch_ext")
    assert os.path.basename(path).startswith("libhost_preproc-") and path.endswith(".so")
    assert os.path.exists(path[:-3] + ".log")
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(build, "_host_loaded", {})
    fresh = build.load_host("host_preproc")
    assert fresh.seconds > 0 and os.path.dirname(fresh.lib._name) == str(tmp_path)
    assert os.path.basename(fresh.lib._name) == os.path.basename(path)  # same source, host
    assert sorted(os.listdir(tmp_path)) == sorted(
        os.path.basename(x) for x in (path, path[:-3] + ".log"))
    assert _digest(os.path.join(ROOT, "native")) == before
    assert build.HOST_CSRC_DIR == os.path.join(ROOT, "mgnns_tpu_torch", "csrc")


def test_a_failing_compiler_raises_with_its_log(tmp_path, monkeypatch):
    cxx = tmp_path / "c++"
    cxx.write_text("#!/bin/sh\n"
                   "case \"$*\" in *--help=target*) echo '-march= testcpu'; exit 0;; esac\n"
                   "echo 'host_preproc.cpp:1: error: the compiler says no' >&2; exit 1\n")
    cxx.chmod(0o755)
    monkeypatch.setattr(build, "_cxx", lambda: str(cxx))
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "out"))
    monkeypatch.setattr(build, "_host_loaded", {})
    with pytest.raises(RuntimeError, match="(?s)exited with 1.*the compiler says no"):
        native.available()
    assert os.listdir(tmp_path / "out") == []


def test_without_a_compiler_the_numpy_paths_answer(monkeypatch, forced):
    """No compiler: ``available()`` is False, the pair count and the edge
    ids take their numpy paths, and ``window_edge_ids`` raises."""
    monkeypatch.setattr(build, "_cxx", lambda: None)
    monkeypatch.setattr(build, "_host_loaded", {})
    assert native.available() is False
    ids, lens = _ids(4)
    got = native.pmi_pair_count(ids, V, 3)
    for g, w in zip(got, jnative.pmi_pair_count(ids, V, 3)):
        np.testing.assert_array_equal(g, w)
    graph = pmi.PmiGraph(V, got[0], np.ones(len(got[0]), np.float32))
    np.testing.assert_array_equal(pmi.doc_window_edge_ids(ids, lens, 2, graph),
                                  jnative.window_edge_ids(ids, lens, 2, got[0], V))
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        native.window_edge_ids(ids, lens, 2, got[0], V)
