"""Vocabulary construction from the training corpus.

Re-implements the behavior of reference ``utils/vocab_new.py``: word-frequency
vocabulary over the train split in first-occurrence order, frequency threshold
``text_min_count``, with ``PAD`` (id 0) and ``UNK`` (id 1) prepended
(reference ``utils/vocab_new.py:35-70``).
"""

from __future__ import annotations

import csv
import os
from collections import Counter
from typing import Iterable, Sequence

PAD_TOKEN = "PAD"
UNK_TOKEN = "UNK"
PAD_ID = 0
UNK_ID = 1


def tokenize(text: str) -> list[str]:
    """Reference tokenization is a plain split on single spaces
    (``utils/vocab_new.py:39``)."""
    return text.split(" ")


def build_vocab(texts: Iterable[str], min_count: int) -> list[str]:
    """Build the vocab list: tokens with frequency >= min_count in
    first-occurrence order, prefixed by PAD and UNK.

    Matches reference ``utils/vocab_new.py:35-70`` (which iterates insertion
    order of a dict built in corpus order).
    """
    freq: Counter[str] = Counter()
    order: dict[str, None] = {}
    for text in texts:
        for word in tokenize(text):
            freq[word] += 1
            if word not in order:
                order[word] = None
    kept = [w for w in order if freq[w] >= min_count]
    return [PAD_TOKEN, UNK_TOKEN] + kept


def save_vocab(vocab: Sequence[str], path: str, freq: dict[str, int] | None = None) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write("\n".join(vocab))
    if freq is not None:
        with open(os.path.join(os.path.dirname(path), "freq.csv"), "w") as f:
            writer = csv.writer(f)
            writer.writerows(freq.items())


def load_vocab(path: str) -> list[str]:
    """Load a vocab file; reference reads with ``f.read().split('\\n')``
    (``utils/vocab_new.py:27-33``)."""
    with open(path) as f:
        return f.read().split("\n")


def get_vocab_list(data_root_path: str, vocab_root_path: str, text_min_count: int) -> list[str]:
    """Load ``vocab-{k}.txt`` if present, else build from the train split.

    Mirrors reference ``utils/vocab_new.py:8-14``.
    """
    vocab_path = os.path.join(vocab_root_path, "vocab", f"vocab-{text_min_count}.txt")
    if os.path.exists(vocab_path):
        return load_vocab(vocab_path)
    import json

    train_path = os.path.join(data_root_path, "all_anno_json", "train_all_anno.json")
    texts = []
    with open(train_path) as f:
        for line in f:
            texts.append(json.loads(line)["text"])
    vocab = build_vocab(texts, text_min_count)
    save_vocab(vocab, vocab_path)
    return vocab


def make_word_to_id(vocab: Sequence[str]) -> dict[str, int]:
    return {w: i for i, w in enumerate(vocab)}


def words_to_ids(words: Sequence[str], w2i: dict[str, int]) -> list[int]:
    """Map tokens to ids with UNK fallback (reference
    ``utils/Multi_GCN_Co_att_dataset.py:94-99``)."""
    unk = w2i[UNK_TOKEN]
    return [w2i.get(w, unk) for w in words]
