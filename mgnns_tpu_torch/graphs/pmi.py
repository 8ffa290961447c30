"""PMI word-co-occurrence graph construction, vectorized and sparse.

A copy of the JAX package's ``mgnns_tpu/graphs/pmi.py`` on its numpy paths.

Reproduces the math of reference ``utils/pmi.py:28-105`` without the O(V^2)
dense matrices and Python loops:

- documents with >= max_len tokens are *dropped* and the rest padded with
  ``PAD`` to exactly max_len (reference ``text_padding``, ``utils/pmi.py:8-16``
  — note the reference keeps only ``len < 100``);
- windowed pair counts over offsets ``[-window, +window)`` excluding the
  center (reference ``:48-58``: ``start=max(0,i-w)``, ``end=min(len,i+w)``,
  i.e. the forward reach is ``window-1``);
- source tokens must be in-vocab and not PAD; target tokens must be in-vocab
  (a literal PAD target is counted into the pair matrix but never yields an
  edge because PAD's unigram count is zero — reference ``:43-57``, ``:76-77``);
- pairs with count < min_cooccurrence are zeroed (``:59-67``);
- PMI = log(p_ij / (p_i p_j)), non-positive values dropped (``:69-87``, the
  clamp at ``:87`` plus the ``!= 0`` test at ``:94``);
- surviving cells are enumerated row-major into edge ids starting at 1, with
  id 0 reserved as the "no edge" slot (``:89-105``).

Instead of a dense [V, V] ``edges_mappings`` matrix (the reference
materializes ~3.2 GB for V=20k) the graph is kept as a sorted sparse key
array; lookups are binary searches (``PmiGraph.lookup``).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from mgnns_tpu_torch.graphs.vocab import make_word_to_id, tokenize


@dataclasses.dataclass
class PmiGraph:
    """Sparse global PMI graph over the vocabulary.

    Attributes:
      vocab_size: V.
      keys: sorted int64 array of ``src * V + dst`` for the E real edges.
      pmi: float32 array [E] of PMI values aligned with ``keys``.
      num_edges: E + 1 (the reference's ``count``, including reserved id 0,
        ``utils/pmi.py:90-97``) — the size of the edge-weight table.
    """

    vocab_size: int
    keys: np.ndarray
    pmi: np.ndarray

    @property
    def num_edges(self) -> int:
        return int(self.keys.shape[0]) + 1

    def initial_edge_weights(self, trainable_init_one: bool = True) -> np.ndarray:
        """Edge-weight table [num_edges, 1]: all ones (reference
        ``models/Text_GCN.py:68``), or else the PMI values with 0.0 at the
        reserved slot (``:72``, ``utils/pmi.py:89``)."""
        if trainable_init_one:
            return np.ones((self.num_edges, 1), dtype=np.float32)
        w = np.zeros((self.num_edges, 1), dtype=np.float32)
        w[1:, 0] = self.pmi
        return w

    def lookup(self, src: np.ndarray, dst: np.ndarray) -> np.ndarray:
        """Edge ids for (src, dst) word-id pairs; 0 where no edge exists.

        Equivalent to indexing the reference's dense ``edges_mappings``
        (``models/Text_GCN.py:134,160,164``).
        """
        src = np.asarray(src, dtype=np.int64)
        dst = np.asarray(dst, dtype=np.int64)
        q = src * self.vocab_size + dst
        idx = np.searchsorted(self.keys, q)
        idx_c = np.minimum(idx, len(self.keys) - 1) if len(self.keys) else idx * 0
        found = np.zeros(q.shape, dtype=bool)
        if len(self.keys):
            found = self.keys[idx_c] == q
        return np.where(found, idx_c + 1, 0).astype(np.int32)


def pad_and_filter(texts: Sequence[str], max_len: int = 100) -> list[list[str]]:
    """Reference ``text_padding`` (``utils/pmi.py:8-16``): keep documents with
    fewer than ``max_len`` tokens, pad each with 'PAD' to exactly max_len."""
    out = []
    for text in texts:
        words = tokenize(text)
        if len(words) < max_len:
            out.append(words + ["PAD"] * (max_len - len(words)))
    return out


def _corpus_to_ids(docs: list[list[str]], w2i: dict[str, int]) -> np.ndarray:
    """[N, L] int32 word ids; -1 marks out-of-vocab tokens (the reference's
    KeyError-skip path, ``utils/pmi.py:44-47,55-58``)."""
    if not docs:
        return np.zeros((0, 0), dtype=np.int32)
    lens = {len(d) for d in docs}
    assert len(lens) == 1, "docs must be padded to a common length"
    flat = [w2i.get(w, -1) for d in docs for w in d]
    return np.asarray(flat, dtype=np.int32).reshape(len(docs), -1)


def pmi_pair_count(ids: np.ndarray, vocab_size: int, window: int):
    """(sorted_keys, counts, word_counts) from an [N, L] padded id matrix
    (-1 = OOV, 0 = PAD): unigram counts of in-vocab non-PAD tokens and the
    windowed pair counts of reference ``utils/pmi.py:40-58``.  The numpy
    counter of the JAX package's ``mgnns_tpu/native.py:pmi_pair_count``; its
    C++ counter for very large corpora is not bound here yet."""
    ids = np.ascontiguousarray(ids, np.int32)
    L = ids.shape[1]
    src_valid = ids > 0
    wc = np.bincount(ids[src_valid].ravel(), minlength=vocab_size).astype(np.int64)
    chunks = []
    for o in range(-window, window):
        if o == 0:
            continue
        if o > 0:
            s, t = ids[:, : L - o], ids[:, o:]
        else:
            s, t = ids[:, -o:], ids[:, : L + o]
        m = (s > 0) & (t >= 0)
        chunks.append(s[m].astype(np.int64) * vocab_size + t[m].astype(np.int64))
    allk = np.concatenate(chunks) if chunks else np.zeros((0,), np.int64)
    keys, counts = np.unique(allk, return_counts=True)
    return keys, counts.astype(np.int64), wc


def cal_pmi(
    texts: Sequence[str],
    vocab: Sequence[str],
    window_size: int = 6,
    min_cooccurrence: int = 2,
    max_len: int = 100,
) -> PmiGraph:
    """Vectorized equivalent of reference ``cal_PMI`` (``utils/pmi.py:28-105``).

    Args:
      texts: raw train-split texts (whitespace-tokenized).
      vocab: vocab list with PAD at 0 (see :mod:`mgnns_tpu_torch.graphs.vocab`).
      window_size: co-occurrence window (reach ``window_size`` back,
        ``window_size - 1`` forward — faithfully reproducing the reference's
        asymmetric ``end = min(len, i + window)``).
      min_cooccurrence: pair-count threshold.
    """
    w2i = make_word_to_id(vocab)
    docs = pad_and_filter(texts, max_len=max_len)
    ids = _corpus_to_ids(docs, w2i)
    V = len(vocab)
    if ids.size == 0:
        return PmiGraph(V, np.zeros((0,), np.int64), np.zeros((0,), np.float32))

    # Unigram + windowed pair counts (offsets o in [-window, window-1], o != 0)
    pair_keys, pair_counts, word_count = pmi_pair_count(ids, V, window_size)

    # Threshold (utils/pmi.py:59-67).
    keep = pair_counts >= min_cooccurrence
    pair_keys, pair_counts = pair_keys[keep], pair_counts[keep]

    # PMI (utils/pmi.py:69-87): p_ij / (p_i * p_j) with total = sum(unigrams).
    total = word_count.sum()
    si, di = np.divmod(pair_keys, V)
    pi = word_count[si].astype(np.float64)
    pj = word_count[di].astype(np.float64)
    ok = (pi > 0) & (pj > 0)
    pair_keys, pair_counts, pi, pj = pair_keys[ok], pair_counts[ok], pi[ok], pj[ok]
    # log((c_ij/total) / ((c_i/total)(c_j/total))) = log(c_ij * total/(c_i c_j))
    pmi = np.log(pair_counts.astype(np.float64) * total / (pi * pj))
    pos = pmi > 0  # clamp-to-0 + "!= 0" edge test (utils/pmi.py:87,94)
    pair_keys, pmi = pair_keys[pos], pmi[pos]

    # np.unique returns sorted keys == the reference's row-major enumeration.
    return PmiGraph(V, pair_keys.astype(np.int64), pmi.astype(np.float32))


def doc_window_edge_ids(
    doc_ids: np.ndarray,
    lengths: np.ndarray,
    ngram: int,
    graph: PmiGraph,
) -> np.ndarray:
    """Per-document window edge-id tensor for the text-level GCN.

    For each batch position ``j`` (the *destination*) and window slot
    ``o in [-ngram, ngram]``, the id of the global edge
    ``(word[j+o] -> word[j])`` — 0 when absent from the PMI graph or out of
    bounds.  This is the host half of the device-side aggregation that
    replaces the per-doc DGL subgraph build in reference
    ``models/Text_GCN.py:142-211``; the center slot ``o = 0`` carries the
    self-loop edge ``edges_matrix[w, w]`` (reference ``:163-164``).

    Args:
      doc_ids: [N, L] int array of word ids, PAD(0)-padded *suffix-only* (the
        dataset pads at the end, so de-padding never reorders tokens and
        window offsets over de-padded positions equal raw-position offsets).
      lengths: [N] true token counts.
      ngram: window radius.
      graph: the global PMI graph.

    Returns:
      [N, L, 2*ngram+1] int32 edge ids (0 where invalid; validity masks are
      recomputed on device from ``lengths``).
    """
    doc_ids = np.asarray(doc_ids)
    lengths = np.asarray(lengths)
    N, L = doc_ids.shape
    W = 2 * ngram + 1
    out = np.zeros((N, L, W), dtype=np.int32)
    pos = np.arange(L)
    for k, o in enumerate(range(-ngram, ngram + 1)):
        s_pos = np.clip(pos + o, 0, L - 1)
        src = doc_ids[:, s_pos]          # word at j + o
        dst = doc_ids                    # word at j
        eid = graph.lookup(src, dst)
        valid = ((pos + o) >= 0) & ((pos + o) < lengths[:, None]) & (pos < lengths[:, None])
        out[:, :, k] = np.where(valid, eid, 0)
    return out
