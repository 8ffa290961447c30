"""A cell's inputs, made from its configuration and the run's seed.

The corpus, its vocabulary and its PMI graph are the configuration's and do
not change with the seed (a user's corpus is fixed; its posts are not).
The records, their labels and pixels, the label graphs, the GloVe-like
constants, the posts a serving cell sends and their images come from the
seed.  Everything here is the benchmark's own (``benchmark.reference.text``);
the program gets the results as the artifacts a user would hand it.
"""

from __future__ import annotations

import functools
import os

import numpy as np

from benchmark.reference import text as T


def rng(seed: int, *tag: int) -> np.random.Generator:
    return np.random.default_rng([abs(int(seed)), *tag])


@functools.lru_cache(maxsize=2)
def corpus(vocab_size: int, n_docs: int, window: int, min_count: int, max_len: int):
    """(vocabulary, documents, graph keys, graph PMI) of the configuration."""
    vocab, docs = T.synthetic_corpus(vocab_size, n_docs)
    keys, pmi = T.pmi_graph(docs, vocab, window, min_count, max_len)
    return vocab, docs, keys, pmi


def text_side(cfg: dict):
    return corpus(cfg["vocab_size"], cfg["corpus_docs"], cfg["window_size"],
                  cfg["min_cooccurrence"], cfg["max_len"])


def constants(cfg: dict, seed: int) -> dict:
    """The label graphs and the label, object and place word vectors."""
    r = rng(seed, 1)
    out = {f"{side}_A": T.label_graph(cfg[f"{side}_num_classes"], cfg[f"{side}_t"], cfg["gama"], r)
           for side in ("object", "place")}
    out["label_query"] = (0.35 * r.standard_normal((cfg["num_labels"], cfg["in_channel"])))
    out["object_inp"] = 0.35 * r.standard_normal((cfg["object_num_classes"], cfg["in_channel"]))
    out["place_inp"] = 0.35 * r.standard_normal((cfg["place_num_classes"], cfg["in_channel"]))
    return {k: np.asarray(v, np.float32) for k, v in out.items()}


def labels(cfg: dict) -> list[str]:
    return [f"label{i}" for i in range(cfg["num_labels"])]


def records(cfg: dict, n: int, seed: int) -> list[dict]:
    """``n`` records of distinct documents, in the seed's order, with
    seeded labels; a record's pixels are keyed by its id."""
    _, docs, _, _ = text_side(cfg)
    r = rng(seed, 2)
    pick = r.choice(len(docs), size=n, replace=n > len(docs))
    lab = r.integers(0, cfg["num_labels"], n)
    names = labels(cfg)
    return [{"id": f"r{seed}-{i}", "text": docs[int(d)], "image": f"r{seed}-{i}.jpg",
             "label": names[int(lab[i])]} for i, d in enumerate(pick)]


def write_label_map(root: str, cfg: dict) -> dict:
    import json

    label_map = {name: i for i, name in enumerate(labels(cfg))}
    with open(os.path.join(root, "label.json"), "w") as f:
        json.dump(label_map, f)
    return label_map


def write_jpegs(root: str, n: int, min_side: int, max_side: int, seed: int) -> list[str]:
    """``n`` seeded JPEG files of ``min_side`` to ``max_side`` pixels a side
    (independent width and height) under ``root``; their names."""
    from PIL import Image

    r = rng(seed, 3)
    names = []
    for i in range(n):
        w, h = (int(x) for x in r.integers(min_side, max_side + 1, 2))
        small = T.synthetic_pixels(f"jpeg{seed}-{i}", 64)
        img = Image.fromarray(small).resize((w, h), Image.BILINEAR)
        name = f"img{i}.jpg"
        img.save(os.path.join(root, name), quality=90)
        names.append(name)
    return names


def posts(cfg: dict, n_posts: int, min_tokens: int, max_tokens: int, seed: int) -> list[str]:
    """``n_posts`` distinct seeded documents of ``min_tokens`` to
    ``max_tokens`` tokens."""
    _, docs, _, _ = text_side(cfg)
    ok = [i for i, d in enumerate(docs) if min_tokens <= d.count(" ") + 1 <= max_tokens]
    pick = rng(seed, 4).choice(len(ok), size=n_posts, replace=False)
    return [docs[ok[int(i)]] for i in pick]


def schedule(rate: float, seconds: float, seed: int) -> np.ndarray:
    """Send times of an open loop of Poisson arrivals at ``rate`` a second
    over ``seconds``: the same gaps for every seed (exponential quantiles),
    in the seed's order, so every seed offers the same load."""
    n = max(int(round(rate * seconds)), 1)
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n) / rate
    gaps *= seconds / gaps.sum()
    return np.concatenate([[0.0], np.cumsum(rng(seed, 5).permutation(gaps))[:-1]])
