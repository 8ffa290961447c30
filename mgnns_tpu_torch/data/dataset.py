"""Dataset: one split of TumEmo/MVSA with text tensors, labels and images.

A copy of the JAX package's ``mgnns_tpu/data/dataset.py``: the GloVe
constants and label graphs load once (:func:`load_constants`), the text side
is encoded once at construction (:class:`mgnns_tpu_torch.data.text.
TextCorpus`), and images decode lazily per batch into a bounded cache when
their pixels are deterministic.
"""

from __future__ import annotations

import json
import os
import pickle
import random

import numpy as np

from mgnns_tpu_torch.config import DataConfig, TextGraphConfig
from mgnns_tpu_torch.data import images as I
from mgnns_tpu_torch.data.text import TextCorpus, read_anno
from mgnns_tpu_torch.graphs.cooccur import gen_A
from mgnns_tpu_torch.graphs.pmi import PmiGraph


def _unpickle(path: str):
    with open(path, "rb") as f:
        return pickle.load(f)


def load_constants(cfg: DataConfig, *, object_t: float, place_t: float, gama: float = 0.2) -> dict:
    """The GloVe matrices and the two label graphs (``gen_A`` of the
    ``{'nums', 'adj'}`` co-occurrence pickles), as float32 numpy arrays
    (reference ``utils/Multi_GCN_Co_att_dataset.py:69-82``)."""
    object_A, _ = gen_A(80, object_t, _unpickle(cfg.object_adj_file), gama)
    place_A, _ = gen_A(365, place_t, _unpickle(cfg.place_adj_file), gama)
    return {
        "object_inp": np.asarray(_unpickle(cfg.object_inp_name), np.float32),
        "place_inp": np.asarray(_unpickle(cfg.place_inp_name), np.float32),
        "label_embedding": np.asarray(_unpickle(cfg.label_glove_name), np.float32),
        "object_A": object_A.astype(np.float32),
        "place_A": place_A.astype(np.float32),
    }


class TumblrDataset:
    """One phase split: static text tensors + lazy images + labels."""

    def __init__(
        self,
        data_cfg: DataConfig,
        graph_cfg: TextGraphConfig,
        phase: str,
        vocab: list[str],
        graph: PmiGraph,
        *,
        image_size: int = 448,
        train_transforms: bool = False,
        records: list[dict] | None = None,
        cache_images: bool = True,
        cache_limit_bytes: int = 4 << 30,
        global_len: int | None = None,
        record_offset: int = 0,
    ):
        """``records``: the split's records, or this host's contiguous slice
        of them on several hosts, whose ``global_len`` is then the split's
        length and ``record_offset`` the slice's first record (the JAX
        package's ``dataset.global_len`` and host offset)."""
        self.cfg = data_cfg
        self.phase = phase
        self.image_size = image_size
        self.train_transforms = train_transforms
        # the decoded-image cache is right when a sample's pixels are
        # deterministic: eval transforms or the synthetic backend
        self._cache_ok = cache_images and self.cacheable_images()
        self._image_cache: dict[int, np.ndarray] = {}
        self._cache_limit_bytes = cache_limit_bytes
        self._cache_bytes = 0
        self.records = records if records is not None else read_anno(data_cfg.data_root_path, phase)
        self.text = TextCorpus.build(self.records, vocab, graph, graph_cfg)
        with open(os.path.join(data_cfg.data_root_path, "label.json")) as f:
            self.cat2idx = json.load(f)
        self.num_classes = len(self.cat2idx)
        self.labels = np.asarray([self.cat2idx[r["label"]] for r in self.records], np.int32)
        self.global_len = len(self.records) if global_len is None else global_len
        self.record_offset = record_offset

    def __len__(self) -> int:
        return len(self.records)

    def cacheable_images(self) -> bool:
        return (not self.train_transforms) or self.cfg.image_backend == "synthetic"

    def image_path(self, i: int) -> str:
        return os.path.join(self.cfg.image_root, self.records[i].get("image", ""))

    def load_image(self, i: int, rng: random.Random | None = None) -> np.ndarray:
        i = int(i)
        if self._cache_ok and i in self._image_cache:
            return self._image_cache[i]
        rec = self.records[i]
        img = I.load_image_uint8(
            self.image_path(i), size=self.image_size, train=self.train_transforms, rng=rng,
            backend=self.cfg.image_backend, sample_key=str(rec.get("id", i)))
        if self._cache_ok and self._cache_bytes + img.nbytes <= self._cache_limit_bytes:
            self._image_cache[i] = img
            self._cache_bytes += img.nbytes
        return img
