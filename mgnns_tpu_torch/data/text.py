"""Text side of the pipeline: annotations -> static-shape numpy tensors.

A copy of the JAX package's ``mgnns_tpu/data/text.py``: every split is
tokenized, padded to the fixed ``max_len`` and its text-GCN window edge ids
precomputed once, so batches are array slices and the two packages encode a
text identically.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np

from mgnns_tpu_torch.config import TextGraphConfig
from mgnns_tpu_torch.graphs.pmi import PmiGraph, cal_pmi, doc_window_edge_ids
from mgnns_tpu_torch.graphs.vocab import get_vocab_list, make_word_to_id, words_to_ids


def read_anno(data_root_path: str, phase: str) -> list[dict]:
    """One JSON object per line with keys id/text/image/label/places/objects
    (reference ``utils/Multi_GCN_Co_att_dataset.py:176-203``)."""
    path = os.path.join(data_root_path, "all_anno_json", f"{phase}_all_anno.json")
    records = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                records.append(json.loads(line))
    return records


def encode_texts(
    texts: list[str],
    w2i: dict[str, int],
    graph: PmiGraph,
    cfg: TextGraphConfig,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Tokenize + pad + mask + window-edge-id encode.

    Returns (ids [N, L], lens [N], mask [N, L], eids [N, L, W]); ``lens`` is
    clamped to >= 1 so an empty text still has one (PAD) token."""
    L = cfg.max_len
    N = len(texts)
    ids = np.zeros((N, L), np.int32)
    lens = np.zeros((N,), np.int32)
    for n, text in enumerate(texts):
        toks = words_to_ids(text.split(" "), w2i)[:L]
        ids[n, : len(toks)] = toks
        lens[n] = max(len(toks), 1)
    mask = (np.arange(L)[None, :] < lens[:, None]).astype(np.float32)
    eids = doc_window_edge_ids(ids, lens, cfg.ngram, graph)
    return ids, lens, mask, eids


@dataclasses.dataclass
class TextCorpus:
    """Tokenized, padded split plus its per-doc graph tensors."""

    ids: np.ndarray          # [N, L] int32, PAD=0 suffix
    lens: np.ndarray         # [N] int32 (>= 1)
    mask: np.ndarray         # [N, L] float32
    eids: np.ndarray         # [N, L, W] int32
    texts: list[str]
    vocab: list[str]
    graph: PmiGraph

    @classmethod
    def build(cls, records: list[dict], vocab: list[str], graph: PmiGraph,
              cfg: TextGraphConfig) -> "TextCorpus":
        texts = [rec["text"] for rec in records]
        ids, lens, mask, eids = encode_texts(texts, make_word_to_id(vocab), graph, cfg)
        return cls(ids=ids, lens=lens, mask=mask, eids=eids, texts=texts, vocab=vocab, graph=graph)


def build_text_side(
    data_root_path: str,
    cfg: TextGraphConfig,
    phases: list[str],
    *,
    pmi_phase: str = "train",
) -> tuple[list[str], PmiGraph, dict[str, TextCorpus]]:
    """Vocab + PMI graph + per-split corpora; ``pmi_phase`` selects the split
    whose texts feed the PMI counts ('train' like the reference)."""
    vocab = get_vocab_list(data_root_path, data_root_path, cfg.text_min_count)
    pmi_records = read_anno(data_root_path, pmi_phase)
    graph = cal_pmi(
        [r["text"] for r in pmi_records], vocab,
        window_size=cfg.window_size, min_cooccurrence=cfg.min_cooccurrence,
        max_len=cfg.max_len,
    )
    corpora = {phase: TextCorpus.build(read_anno(data_root_path, phase), vocab, graph, cfg)
               for phase in phases}
    return vocab, graph, corpora
