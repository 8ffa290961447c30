"""Serving: predict on raw (text, image) posts with a model held on the card.

Port of the JAX package's ``mgnns_tpu/serving.py:Predictor``.  The
:class:`Predictor` owns the preprocessing state (vocab, PMI graph) and the
converted parameters, encodes each request on the host (tokenize, window
edge ids, image decode on a thread pool), pads it to the smallest batch
bucket that fits, and runs one batched eval forward on ``device``.

Usage::

    params, stats, consts = convert.from_jax_params(params_np, stats_np, consts_np)
    pred = Predictor(vocab=vocab, graph=graph, graph_cfg=TextGraphConfig(),
                     label_map=labels, params=params, batch_stats=stats,
                     consts=consts, cfg=cfg)
    out = pred.predict([{"text": "what a wonderful day", "image": "a.jpg"}])
    out[0] -> {"label": "happy", "label_id": 4, "probs": {...}}
"""

from __future__ import annotations

import json
import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from mgnns_tpu_torch.config import ModelConfig, TextGraphConfig
from mgnns_tpu_torch.data import images as I
from mgnns_tpu_torch.data.text import encode_texts
from mgnns_tpu_torch.graphs.pmi import PmiGraph
from mgnns_tpu_torch.graphs.vocab import make_word_to_id
from mgnns_tpu_torch.models.mgnns import mgnns_apply
from mgnns_tpu_torch.models.text_only import text_model_apply
from mgnns_tpu_torch.utils import resolve_device, tree_to


def resolve_batch_buckets(requested: list[int] | None, max_batch: int) -> list[int]:
    """Batch-size bucket ladder: a request for n records runs the smallest
    batch >= n instead of always the full ``max_batch``.  Defaults to powers
    of 4 below ``max_batch``."""
    if requested is None:
        requested = []
        b = 1
        while b < max_batch:
            requested.append(b)
            b *= 4
    buckets = sorted({int(b) for b in requested} | {max_batch})
    for b in buckets:
        if not 1 <= b <= max_batch:
            raise ValueError(f"batch bucket {b} invalid (max_batch {max_batch})")
    return buckets


class Predictor:
    def __init__(
        self,
        *,
        vocab: list[str],
        graph: PmiGraph,
        graph_cfg: TextGraphConfig,
        label_map: dict[str, int],
        params: dict,
        batch_stats: dict | None = None,
        consts: dict | None = None,
        cfg: ModelConfig | None = None,
        image_backend: str = "pil",
        image_root: str = ".",
        max_batch: int = 16,
        text_only: bool = False,
        strict_images: bool = True,
        batch_buckets: list[int] | None = None,
        decode_threads: int | None = None,
        device="cuda",
    ):
        """``params``: the text-only model's (``text_only=True``) or the
        fusion model's, e.g. from :mod:`mgnns_tpu_torch.convert`; the fusion
        model also takes its ``batch_stats``, ``consts`` and ``cfg``.
        Everything is moved to ``device``, which raises when it is CUDA and
        no card is present."""
        if not text_only and (batch_stats is None or consts is None or cfg is None):
            raise ValueError("the fusion model needs batch_stats, consts and cfg")
        self.device = resolve_device(device)
        self.vocab = vocab
        self.graph = graph
        self.graph_cfg = graph_cfg
        self.w2i = make_word_to_id(vocab)
        self.idx2label = {v: k for k, v in label_map.items()}
        self.params = tree_to(params, self.device)
        self.batch_stats = tree_to(batch_stats, self.device) if batch_stats is not None else None
        self.consts = tree_to(consts, self.device) if consts is not None else None
        self.cfg = cfg
        self.image_size = cfg.image_size if cfg is not None else 0
        self.image_backend = image_backend
        self.image_root = image_root
        self.max_batch = max_batch
        self.text_only = text_only
        # strict: a missing/corrupt image raises instead of silently
        # substituting the deterministic synthetic fallback pixels
        self.strict_images = strict_images
        # image decode/resize runs on a thread pool (PIL releases the GIL)
        if decode_threads is None:
            decode_threads = min(8, os.cpu_count() or 4)
        self._decode_pool = (
            ThreadPoolExecutor(decode_threads) if decode_threads > 1 else None)
        self.batch_buckets = resolve_batch_buckets(batch_buckets, max_batch)
        # per-stage latency of the most recent chunk (ms)
        self.last_timings: dict = {}

    def close(self) -> None:
        if self._decode_pool is not None:
            self._decode_pool.shutdown()

    # ------------------------------------------------------------- preproc

    def _decode_one_image(self, i: int, rec: dict) -> np.ndarray:
        path = os.path.join(self.image_root, rec.get("image", ""))
        if self.strict_images and self.image_backend == "pil":
            from PIL import Image

            try:
                with Image.open(path) as im:
                    im.verify()
            except (FileNotFoundError, OSError) as e:
                raise ValueError(
                    f"record {i} (id={rec.get('id')!r}): image {path!r} is "
                    f"missing or unreadable ({e}); pass strict_images=False to "
                    f"substitute synthetic pixels") from e
        return I.load_image_uint8(
            path, size=self.image_size, backend=self.image_backend,
            sample_key=str(rec.get("id", rec.get("text", ""))))

    def _encode_images(self, records: list[dict]) -> np.ndarray:
        if self._decode_pool is not None and len(records) > 1:
            imgs = list(self._decode_pool.map(
                self._decode_one_image, range(len(records)), records))
        else:
            imgs = [self._decode_one_image(i, r) for i, r in enumerate(records)]
        return np.stack(imgs)

    def _bucket(self, n: int) -> int:
        for b in self.batch_buckets:
            if b >= n:
                return b
        return self.max_batch

    def _encode_host(self, records: list[dict]) -> tuple[dict, int]:
        """Host preprocessing of one chunk into a numpy batch of the smallest
        bucket size >= len(records); pad slots repeat the last encoded row."""
        n = len(records)
        pad = self._bucket(n) - n

        def padrow(a: np.ndarray) -> np.ndarray:
            return a if pad == 0 else np.concatenate([a, np.repeat(a[-1:], pad, axis=0)])

        t0 = time.perf_counter()
        ids, lens, mask, eids = encode_texts(
            [r["text"] for r in records], self.w2i, self.graph, self.graph_cfg)
        t1 = time.perf_counter()
        batch = {"ids": padrow(ids), "lens": padrow(lens),
                 "mask": padrow(mask), "eids": padrow(eids)}
        t2 = t1
        if not self.text_only:
            batch["image"] = padrow(self._encode_images(records))
            t2 = time.perf_counter()
        self.last_timings["encode_text_ms"] = (t1 - t0) * 1e3
        self.last_timings["decode_images_ms"] = (t2 - t1) * 1e3
        return batch, n

    # ------------------------------------------------------------- predict

    def _forward(self, batch_np: dict) -> torch.Tensor:
        """H2D copy + eval forward + softmax; returns device probs without
        waiting for them."""
        t0 = time.perf_counter()
        batch = {k: torch.from_numpy(v).to(self.device) for k, v in batch_np.items()}
        with torch.inference_mode():
            if self.text_only:
                logits = text_model_apply(self.params, batch, ngram=self.graph_cfg.ngram)
            else:
                logits = mgnns_apply(self.params, self.batch_stats, self.consts, batch,
                                     cfg=self.cfg)[0]
            probs = torch.softmax(logits.float(), dim=-1)
        self.last_timings["forward_dispatch_ms"] = (time.perf_counter() - t0) * 1e3
        return probs

    def _format(self, probs: np.ndarray) -> list[dict]:
        results = []
        for row in probs:
            label_id = int(row.argmax())
            results.append({
                "label": self.idx2label[label_id],
                "label_id": label_id,
                "probs": {self.idx2label[j]: float(p) for j, p in enumerate(row)},
            })
        return results

    def predict(self, records: list[dict]) -> list[dict]:
        """records: list of {"text": str, "image": optional path, "id": optional}.
        Returns per record: {"label", "label_id", "probs": {name: p}}.

        Requests larger than ``max_batch`` run in chunks; the host encodes
        chunk i+1 while the card runs chunk i (the readback of a chunk waits
        until the next one is queued)."""
        for i, rec in enumerate(records):
            if "text" not in rec:
                raise ValueError(f"record {i} (id={rec.get('id')!r}) has no 'text' field")
        out: list[dict] = []
        pending = None  # (device probs, n) of the chunk in flight
        for i in range(0, len(records), self.max_batch):
            batch, n = self._encode_host(records[i : i + self.max_batch])
            probs = self._forward(batch)
            if pending is not None:
                out.extend(self._format(pending[0].cpu().numpy()[: pending[1]]))
            pending = (probs, n)
        if pending is not None:
            t0 = time.perf_counter()
            probs = pending[0].cpu().numpy()
            self.last_timings["readback_ms"] = (time.perf_counter() - t0) * 1e3
            out.extend(self._format(probs[: pending[1]]))
        return out

    def warm(self) -> None:
        """Run every batch bucket once, so no live request pays first-call
        costs (library handles, kernel build and load)."""
        rec = {"text": "warmup"}
        if not self.text_only:
            rec["image"] = "__warmup__.jpg"
        strict, self.strict_images = self.strict_images, False
        try:
            for b in self.batch_buckets:
                self.predict([dict(rec) for _ in range(b)])
        finally:
            self.strict_images = strict


PREPROC_NPZ = "preproc.npz"
PREPROC_JSON = "preproc.json"


def save_preproc(checkpoint_dir: str, vocab, graph, label_map, graph_cfg) -> None:
    """Persist the preprocessing state beside a checkpoint, in the JAX
    package's format."""
    os.makedirs(checkpoint_dir, exist_ok=True)
    np.savez_compressed(os.path.join(checkpoint_dir, PREPROC_NPZ),
                        keys=graph.keys, pmi=graph.pmi, vocab_size=graph.vocab_size)
    with open(os.path.join(checkpoint_dir, PREPROC_JSON), "w") as f:
        json.dump({
            "vocab": vocab, "label_map": label_map,
            "graph_cfg": {
                "text_min_count": graph_cfg.text_min_count,
                "window_size": graph_cfg.window_size,
                "ngram": graph_cfg.ngram,
                "min_cooccurrence": graph_cfg.min_cooccurrence,
                "max_len": graph_cfg.max_len,
            },
        }, f)


def load_preproc(checkpoint_dir: str):
    """(vocab, graph, label_map, graph_cfg) or None when absent."""
    npz_path = os.path.join(checkpoint_dir, PREPROC_NPZ)
    json_path = os.path.join(checkpoint_dir, PREPROC_JSON)
    if not (os.path.exists(npz_path) and os.path.exists(json_path)):
        return None
    z = np.load(npz_path)
    graph = PmiGraph(int(z["vocab_size"]), z["keys"], z["pmi"])
    with open(json_path) as f:
        meta = json.load(f)
    return (meta["vocab"], graph, meta["label_map"], TextGraphConfig(**meta["graph_cfg"]))
