"""The benchmark's own inputs and host encode: the synthetic corpus, the
PMI word graph, the label graphs, a post's token ids and window edge ids,
and its pixels.

A frozen numpy copy of what the reference model (Yang et al., ACL 2021,
``utils/pmi.py``, ``utils/util.py``) and the port compute on the host, kept
here so that the yardstick does not move when the program does.  Nothing
here imports the program.
"""

from __future__ import annotations

import hashlib

import numpy as np

PAD, UNK = "PAD", "UNK"


def synthetic_corpus(vocab_size: int, n_docs: int, min_len: int = 5, max_len: int = 90,
                     seed: int = 0) -> tuple[list[str], list[str]]:
    """(vocabulary, documents): ``n_docs`` documents of ``min_len`` to
    ``max_len`` tokens, Zipf-like (exponent 1.1) over the ``vocab_size - 2``
    words after PAD and UNK."""
    r = np.random.default_rng(seed)
    vocab = [PAD, UNK] + [f"w{i}" for i in range(vocab_size - 2)]
    p = 1.0 / np.arange(1, vocab_size - 1) ** 1.1
    lens = r.integers(min_len, max_len + 1, n_docs)
    toks = r.choice(vocab_size - 2, size=int(lens.sum()), p=p / p.sum())
    words = np.array(vocab[2:])[toks]
    cuts = np.cumsum(lens)[:-1]
    return vocab, [" ".join(d) for d in np.split(words, cuts)]


def word_ids(texts: list[str], vocab: list[str], L: int) -> tuple[np.ndarray, np.ndarray]:
    """(ids [N, L] int32, PAD-suffixed, UNK for unknown words; lens [N],
    at least 1): a text is split on single spaces and cut at ``L``."""
    w2i = {w: i for i, w in enumerate(vocab)}
    ids = np.zeros((len(texts), L), np.int32)
    lens = np.zeros((len(texts),), np.int32)
    for n, text in enumerate(texts):
        toks = [w2i.get(w, 1) for w in text.split(" ")][:L]
        ids[n, :len(toks)] = toks
        lens[n] = max(len(toks), 1)
    return ids, lens


def pmi_graph(texts: list[str], vocab: list[str], window: int, min_count: int,
              max_len: int) -> tuple[np.ndarray, np.ndarray]:
    """(keys, pmi): the sorted ``src * V + dst`` keys of the positive-PMI
    word pairs and their PMI (reference ``utils/pmi.py:28-105``): documents
    of ``max_len`` tokens or more are dropped, the rest PAD-padded; pairs at
    offsets ``[-window, window)`` but 0, sources in-vocab and not PAD;
    pairs seen fewer than ``min_count`` times dropped.  Edge id ``k + 1``
    is ``keys[k]``; 0 means no edge."""
    V = len(vocab)
    w2i = {w: i for i, w in enumerate(vocab)}
    docs = []
    for t in texts:
        words = t.split(" ")
        if len(words) < max_len:
            docs.append([w2i.get(w, -1) for w in words] + [0] * (max_len - len(words)))
    ids = np.asarray(docs, np.int64)
    wc = np.bincount(ids[ids > 0].ravel(), minlength=V).astype(np.int64)
    keys = []
    for o in range(-window, window):
        if o == 0:
            continue
        s, t = (ids[:, :max_len - o], ids[:, o:]) if o > 0 else (ids[:, -o:], ids[:, :max_len + o])
        m = (s > 0) & (t >= 0)
        keys.append(s[m] * V + t[m])
    keys, counts = np.unique(np.concatenate(keys), return_counts=True)
    keep = counts >= min_count
    keys, counts = keys[keep], counts[keep]
    si, di = np.divmod(keys, V)
    pi, pj = wc[si].astype(np.float64), wc[di].astype(np.float64)
    ok = (pi > 0) & (pj > 0)
    keys, counts, pi, pj = keys[ok], counts[ok], pi[ok], pj[ok]
    pmi = np.log(counts.astype(np.float64) * wc.sum() / (pi * pj))
    pos = pmi > 0
    return keys[pos].astype(np.int64), pmi[pos].astype(np.float32)


def window_edge_ids(ids: np.ndarray, lens: np.ndarray, ngram: int, keys: np.ndarray,
                    V: int) -> np.ndarray:
    """[N, L, 2*ngram+1] int32: for position ``j`` and slot ``o``, the id of
    the edge ``word[j+o] -> word[j]``, 0 where there is none or the slot
    falls outside the document (reference ``models/Text_GCN.py:142-211``)."""
    N, L = ids.shape
    pos = np.arange(L)
    out = np.zeros((N, L, 2 * ngram + 1), np.int32)
    for k, o in enumerate(range(-ngram, ngram + 1)):
        src = ids[:, np.clip(pos + o, 0, L - 1)].astype(np.int64)
        q = src * V + ids.astype(np.int64)
        idx = np.minimum(np.searchsorted(keys, q), max(len(keys) - 1, 0))
        hit = keys[idx] == q if len(keys) else np.zeros(q.shape, bool)
        valid = (pos + o >= 0) & (pos + o < lens[:, None]) & (pos < lens[:, None])
        out[:, :, k] = np.where(hit & valid, idx + 1, 0)
    return out


def encode(texts: list[str], vocab: list[str], keys: np.ndarray, L: int, ngram: int) -> dict:
    """The model's text inputs of ``texts``: ``ids``, ``lens``, ``mask``,
    ``eids`` as numpy arrays."""
    ids, lens = word_ids(texts, vocab, L)
    mask = (np.arange(L)[None, :] < lens[:, None]).astype(np.float32)
    return {"ids": ids, "lens": lens, "mask": mask,
            "eids": window_edge_ids(ids, lens, ngram, keys, len(vocab))}


def label_graph(C: int, t: float, gama: float, r: np.random.Generator) -> np.ndarray:
    """A label graph of ``C`` classes from seeded co-occurrence counts,
    binarized at ``t`` and reweighted by ``gama`` (reference ``gen_A``,
    ``utils/util.py:383-398``), float32."""
    nums = r.integers(1, 200, C).astype(np.float64)
    adj = r.integers(0, 60, (C, C)).astype(np.float64) / nums[:, None]
    adj = np.where(adj < t, 0.0, 1.0)
    adj = adj * gama / (adj.sum(0, keepdims=True) + 1e-6)
    return (adj + (1 - gama) * np.identity(C)).astype(np.float32)


def synthetic_pixels(key: str, size: int) -> np.ndarray:
    """[size, size, 3] uint8: smooth gradients and coarse noise seeded by an
    md5 of ``key`` (the port's and the JAX package's stand-in for a missing
    image file)."""
    g = np.random.default_rng(int(hashlib.md5(key.encode()).hexdigest()[:8], 16))
    y = np.linspace(0, 1, size, dtype=np.float32)
    base = np.outer(y, y)[..., None] * g.uniform(0.2, 0.8, (1, 1, 3)).astype(np.float32)
    small = max(size // 8, 1)
    factor = -(-size // small)
    coarse = g.normal(0, 0.05, (small, small, 3)).astype(np.float32)
    noise = np.repeat(np.repeat(coarse, factor, 0), factor, 1)[:size, :size]
    return (np.clip(base + noise + 0.3, 0.0, 1.0) * 255).astype(np.uint8)


def decoded_pixels(path: str, size: int) -> np.ndarray:
    """[size, size, 3] uint8 of an image file: RGB, bilinear square resize
    (reference ``Warp``, ``utils/util.py:67-77``)."""
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB").resize((size, size), Image.BILINEAR), np.uint8)
