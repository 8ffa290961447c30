"""ctypes bindings of the native host preprocessing (``mgnns_tpu/native.py``).

The library is the port's own ``mgnns_tpu_torch/csrc/host_preproc.cpp``,
built at first use by the host C++ compiler into ``build/torch_ext/``
(:func:`mgnns_tpu_torch.kernels.build.load_host`).  It exposes:

- :func:`pmi_pair_count`: sparse windowed co-occurrence counting (a C++
  open-addressing hash in place of the numpy concat + unique pass of
  :func:`pmi_pair_count_numpy` for very large corpora), for
  :func:`mgnns_tpu_torch.graphs.pmi.cal_pmi`;
- :func:`window_edge_ids`: each document's window edge ids by binary
  search, the native path of
  :func:`mgnns_tpu_torch.graphs.pmi.doc_window_edge_ids`.

Without a C++ compiler :func:`available` is False and both callers take
their numpy paths, as the JAX package does; a compiler that fails raises
with its output (the JAX package would fall back quietly).
"""

from __future__ import annotations

import ctypes

import numpy as np

from mgnns_tpu_torch.kernels import build

# Below this many candidate pairs the vectorized numpy pass is faster than
# the C++ hash (the JAX package measured 0.21 s against 0.64 s on 10k TumEmo
# documents); above it numpy's O(pairs) temporaries bound the memory, and the
# native counter's table does not grow with the pairs.
_NATIVE_PAIR_THRESHOLD = 50_000_000
# the first hash table holds max(lo, min(candidate_pairs // 8, hi)) distinct
# pairs, an estimate of the distinct count, and grows x4 on overflow
FIRST_CAPACITY = (1 << 20, 1 << 23)


def _load():
    """The library with its signatures declared, or None without a compiler."""
    lib = build.load_host("host_preproc")
    if lib is None:
        return None
    lib = lib.lib
    if lib.pmi_pair_count.argtypes is None:
        i32, i64 = ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64)
        lib.pmi_pair_count.restype = ctypes.c_int64
        lib.pmi_pair_count.argtypes = [i32, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                                       ctypes.c_int64, i64, i64, ctypes.c_int64, i64]
        lib.window_edge_ids.restype = None
        lib.window_edge_ids.argtypes = [i32, i32, ctypes.c_int64, ctypes.c_int64,
                                        ctypes.c_int64, i64, ctypes.c_int64, ctypes.c_int64,
                                        i32]
    return lib


def available() -> bool:
    return _load() is not None


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def pmi_pair_count(ids: np.ndarray, vocab_size: int, window: int):
    """(sorted_keys, counts, word_counts) from an [N, L] padded id matrix
    (-1 = OOV, 0 = PAD): unigram counts of in-vocab non-PAD tokens and the
    windowed pair counts of reference ``utils/pmi.py:40-58``.  The native
    counter runs above :data:`_NATIVE_PAIR_THRESHOLD` candidate pairs when
    the library is available, :func:`pmi_pair_count_numpy` otherwise; both
    give the same arrays."""
    ids = np.ascontiguousarray(ids, np.int32)
    N, L = ids.shape
    candidate_pairs = N * L * 2 * window
    lib = _load() if candidate_pairs > _NATIVE_PAIR_THRESHOLD else None
    if lib is None:
        return pmi_pair_count_numpy(ids, vocab_size, window)
    # a table sized to the worst case would take tens of GB exactly where this
    # path is meant to run: size it to an estimate and grow on overflow
    lo, hi = FIRST_CAPACITY
    cap = int(max(lo, min(candidate_pairs // 8, hi)))
    while True:
        out_keys = np.empty(cap, np.int64)
        out_counts = np.empty(cap, np.int64)
        wc = np.zeros(vocab_size, np.int64)
        n = lib.pmi_pair_count(_ptr(ids, ctypes.c_int32), N, L, vocab_size, window,
                               _ptr(out_keys, ctypes.c_int64), _ptr(out_counts, ctypes.c_int64),
                               cap, _ptr(wc, ctypes.c_int64))
        if n >= 0:
            order = np.argsort(out_keys[:n], kind="stable")
            return out_keys[:n][order], out_counts[:n][order], wc
        if cap >= candidate_pairs:  # the distinct pairs cannot outnumber the candidates
            raise RuntimeError(f"pmi_pair_count overflowed {cap} slots for "
                               f"{candidate_pairs} candidate pairs")
        cap = min(cap * 4, candidate_pairs)


def pmi_pair_count_numpy(ids: np.ndarray, vocab_size: int, window: int):
    """:func:`pmi_pair_count` in numpy: offsets ``o`` in ``[-window,
    window)``, ``o != 0``, sources in-vocab and not PAD, targets in-vocab."""
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


def window_edge_ids(ids: np.ndarray, lens: np.ndarray, ngram: int,
                    sorted_keys: np.ndarray, vocab_size: int) -> np.ndarray:
    """[N, L, 2*ngram+1] int32 edge ids by the native binary search: the id
    of edge ``(ids[n, j+o] -> ids[n, j])`` (its index in ``sorted_keys`` + 1)
    where ``j < lens[n]`` and ``0 <= j+o < lens[n]``, else 0.

    The numpy version is the only caller's other path
    (:func:`mgnns_tpu_torch.graphs.pmi.doc_window_edge_ids`), so this raises
    when the library is unavailable, and it refuses ``lens`` above ``L``:
    the C loop would read the next document's row."""
    ids = np.ascontiguousarray(ids, np.int32)
    lens = np.ascontiguousarray(lens, np.int32)
    sorted_keys = np.ascontiguousarray(sorted_keys, np.int64)
    N, L = ids.shape
    if lens.shape != (N,):
        raise ValueError(f"lens of shape {lens.shape} for {N} documents")
    if N and int(lens.max()) > L:
        raise ValueError(f"a length of {int(lens.max())} exceeds the {L} columns of ids")
    lib = _load()
    if lib is None:
        raise RuntimeError("the native library is unavailable (no C++ compiler); use "
                           "graphs.pmi.doc_window_edge_ids")
    out = np.empty((N, L, 2 * ngram + 1), np.int32)
    lib.window_edge_ids(_ptr(ids, ctypes.c_int32), _ptr(lens, ctypes.c_int32), N, L, ngram,
                        _ptr(sorted_keys, ctypes.c_int64), len(sorted_keys), vocab_size,
                        _ptr(out, ctypes.c_int32))
    return out
