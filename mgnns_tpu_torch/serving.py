"""Serving: predict on raw (text, image) posts with a model held on the card.

Port of the JAX package's ``mgnns_tpu/serving.py:Predictor``.  The
:class:`Predictor` owns the preprocessing state (vocab, PMI graph) and the
converted parameters, encodes each request on the host (tokenize, window
edge ids, image decode on a thread pool), pads it to the smallest batch
bucket that fits, and runs one batched eval forward on ``device``.

Usage::

    pred = Predictor.from_engine_artifacts(data_root, "checkpoint/mgnns_tpu")
    out = pred.predict([{"text": "what a wonderful day", "image": "a.jpg"}])
    out[0] -> {"label": "happy", "label_id": 4, "probs": {...}}

:meth:`Predictor.from_engine_artifacts` serves what the training CLI wrote
(the port's checkpoints and the preprocessing files beside them) or a
reference ``.pth[.tar]``; the constructor takes trees in memory, for example
from :mod:`mgnns_tpu_torch.convert`.  :class:`BatchingFrontend` coalesces
concurrent requests into device batches, in front of the HTTP server
(:mod:`mgnns_tpu_torch.cli.serve`).
"""

from __future__ import annotations

import collections
import json
import os
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from mgnns_tpu_torch.config import DataConfig, ModelConfig, TextGraphConfig
from mgnns_tpu_torch.data import images as I
from mgnns_tpu_torch.data.text import build_text_side, encode_texts
from mgnns_tpu_torch.graphs.pmi import PmiGraph
from mgnns_tpu_torch.graphs.vocab import make_word_to_id
from mgnns_tpu_torch.models.mgnns import DEAD_MODULES, mgnns_apply
from mgnns_tpu_torch.models.text_only import text_model_apply
from mgnns_tpu_torch.utils import resolve_device, tree_leaves, tree_paths, tree_to


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

    @staticmethod
    def _readback(probs: torch.Tensor) -> np.ndarray:
        """Wait for a chunk's device probs and copy them to the host."""
        return probs.cpu().numpy()

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
                out.extend(self._format(self._readback(pending[0])[: pending[1]]))
            pending = (probs, n)
        if pending is not None:
            t0 = time.perf_counter()
            probs = self._readback(pending[0])
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

    # ---------------------------------------------------------- constructors

    @classmethod
    def from_engine_artifacts(
        cls,
        data_root: str,
        checkpoint_dir: str,
        *,
        text_only: bool = False,
        pmi_phase: str = "train",
        graph_cfg: TextGraphConfig | None = None,
        model_overrides: dict | None = None,
        image_backend: str = "pil",
        image_root: str = ".",
        max_batch: int = 16,
        step: int | None = None,
        strict_images: bool = True,
        reference_ckpt: str | None = None,
        batch_buckets: list[int] | None = None,
        decode_threads: int | None = None,
        device="cuda",
    ) -> "Predictor":
        """A Predictor on ``device`` (which raises when it is CUDA and no
        card is present) from what the training CLI wrote.

        The vocabulary, PMI graph, label map and graph config come from the
        preprocessing files beside the checkpoints (:func:`load_preproc`),
        so serving uses the ids training saw; without them they are rebuilt
        from ``data_root``.  The weights come from the port's checkpoint at
        ``step`` (default: the latest) in ``checkpoint_dir``, or, with
        ``reference_ckpt``, from a reference ``.pth[.tar]`` (fusion model
        only; ``checkpoint_dir`` then only supplies the preprocessing
        files).  The fusion model's constants come from ``data_root``
        (:func:`mgnns_tpu_torch.data.dataset.load_constants`) and its config
        is ``ModelConfig`` with the vocabulary, labels and edges of the
        preprocessing and ``model_overrides``.

        The weights are checked leaf by leaf against a freshly built model:
        a missing or unknown leaf, or a leaf of another shape, raises
        ``ValueError``.  Dead modules are accepted when the weights carry
        them whole.
        """
        dev = resolve_device(device)
        if text_only and reference_ckpt:
            raise ValueError("reference_ckpt holds the fusion model; text_only cannot serve it")
        pre = load_preproc(checkpoint_dir)
        if pre is not None:
            vocab, graph, label_map, graph_cfg = pre
        else:
            graph_cfg = graph_cfg or TextGraphConfig()
            vocab, graph, _ = build_text_side(data_root, graph_cfg, [], pmi_phase=pmi_phase)
            with open(os.path.join(data_root, "label.json")) as f:
                label_map = json.load(f)
        if reference_ckpt:
            raw = None
        elif os.path.isdir(checkpoint_dir):
            from mgnns_tpu_torch.engine.checkpoint import Checkpointer

            raw = Checkpointer(checkpoint_dir, max_to_keep=0).restore(step, device=dev)
        else:
            raise FileNotFoundError(f"no checkpoint directory {checkpoint_dir!r}")
        common = dict(vocab=vocab, graph=graph, graph_cfg=graph_cfg, label_map=label_map,
                      image_backend=image_backend, image_root=image_root, max_batch=max_batch,
                      strict_images=strict_images, batch_buckets=batch_buckets,
                      decode_threads=decode_threads, device=dev)
        if text_only:
            from mgnns_tpu_torch.models.text_only import text_model_init

            template = text_model_init(len(vocab), len(label_map), graph.num_edges, device=dev)
            _check_tree(template, raw["params"], "checkpoint params")
            return cls(params=raw["params"], text_only=True, **common)

        from mgnns_tpu_torch.data.dataset import load_constants
        from mgnns_tpu_torch.models.mgnns import mgnns_init

        cfg = ModelConfig(num_labels=len(label_map), vocab_size=len(vocab),
                          edges_num=graph.num_edges, **(model_overrides or {}))
        data_cfg = DataConfig(
            data_root_path=data_root,
            object_inp_name=os.path.join(data_root, "glove/object_glove_word2vec.pkl"),
            place_inp_name=os.path.join(data_root, "glove/place_glove_word2vec.pkl"),
            label_glove_name=os.path.join(data_root, "tumblr_label_glove.pkl"),
            object_adj_file=os.path.join(data_root, "adj/tumblr_objects_adj.pkl"),
            place_adj_file=os.path.join(data_root, "adj/tumblr_resnet50_places_adj.pkl"),
        )
        consts_np = load_constants(data_cfg, object_t=cfg.object_t, place_t=cfg.place_t)
        if reference_ckpt:
            from mgnns_tpu_torch.models.import_reference import (
                import_reference_state_dict, load_torch_state_dict,
            )

            sd, _ = load_torch_state_dict(reference_ckpt)
            params, bstats = import_reference_state_dict(
                sd, num_layers=cfg.num_layers, bidirectional=cfg.bidirectional,
                stack_num=cfg.stack_num, device=dev)
            got_v = params["embedding"]["table"].shape[0]
            if got_v != len(vocab):
                raise ValueError(f"reference_ckpt vocab size {got_v} != serving vocab {len(vocab)}")
        else:
            params, bstats = raw["params"], raw["batch_stats"]
        tparams, tstats, consts = mgnns_init(
            cfg, num_edges=graph.num_edges, label_embedding=consts_np["label_embedding"],
            object_A=consts_np["object_A"], place_A=consts_np["place_A"],
            object_inp=consts_np["object_inp"], place_inp=consts_np["place_inp"],
            include_dead_modules=any(k in params for k in DEAD_MODULES), device=dev)
        _check_tree(tparams, params, "params")
        _check_tree(tstats, bstats, "batch_stats")
        del tparams, tstats
        return cls(params=params, batch_stats=bstats, consts=consts, cfg=cfg, **common)


def _check_tree(template, tree, what: str) -> None:
    """Raise unless ``tree`` has the leaves of ``template``, with their shapes."""
    want = dict(zip(tree_paths(template), (tuple(t.shape) for t in tree_leaves(template))))
    got = dict(zip(tree_paths(tree), (tuple(t.shape) for t in tree_leaves(tree))))
    if want.keys() != got.keys():
        raise ValueError(f"{what} do not match the model: missing {sorted(want.keys() - got)}, "
                         f"unknown {sorted(got.keys() - want)}")
    bad = [f"{p} {got[p]} (model {want[p]})" for p in want if want[p] != got[p]]
    if bad:
        raise ValueError(f"{what} do not match the model's shapes: {bad[:5]}")


class BatchingFrontend:
    """Bounded-queue micro-batching around a :class:`Predictor`, in two
    pipeline stages (``mgnns_tpu/serving.py:426-670``):

    - the encode thread coalesces queued requests into groups of up to the
      Predictor's ``max_batch`` records and runs their host preprocessing
      (``Predictor._encode_host``: tokenizing and image decode, numpy only)
      one group ahead of the card;
    - the device thread is the only thread that touches torch.  It calls
      ``Predictor._forward`` (H2D copy, eval forward, softmax; it enters
      ``torch.inference_mode``, which is per thread, on this thread) and
      defers each chunk's blocking readback until the next chunk's forward
      is queued, so the card runs chunk k+1 while chunk k is copied back,
      formatted and delivered; with nothing queued it finishes the chunk at
      once.  There is one device thread on purpose: the float32 conv pin
      (:func:`mgnns_tpu_torch.nn.resnet.ieee_float32_convs`) sets a
      process-wide cuDNN flag, which forwards on two threads would race on.

    Under load a group takes about the longest of host encode, H2D and the
    forward instead of their sum.  A full request queue raises :class:`Busy`
    at once (HTTP 503 upstream) instead of letting latency grow.  Request
    latencies are kept in a ring buffer for :meth:`stats`' p50/p99.
    """

    class Busy(RuntimeError):
        pass

    def __init__(self, predictor: Predictor, max_queue: int = 256):
        self.predictor = predictor
        self.max_queue = max_queue
        self._q: queue.Queue = queue.Queue(maxsize=max_queue)
        # encoded chunks awaiting the device; depth 2 = one chunk encoding
        # ahead while one waits, deeper only adds latency under overload
        self._encoded_q: queue.Queue = queue.Queue(maxsize=2)
        self._latencies: collections.deque = collections.deque(maxlen=1024)
        self._count = 0
        self._lock = threading.Lock()
        # encoded chunks handed to the device and not yet finished: the
        # encoder's coalescing signal (see _encode_loop)
        self._inflight = 0
        # wakes the coalescing encoder when a request arrives or an in-flight
        # chunk finishes (instead of polling the queue)
        self._wake = threading.Condition(self._lock)
        self._encoder = threading.Thread(target=self._encode_loop, daemon=True)
        self._worker = threading.Thread(target=self._device_loop, daemon=True)
        self._encoder.start()
        self._worker.start()

    def _item_done(self) -> None:
        with self._lock:
            self._inflight -= 1
            self._wake.notify_all()

    def submit(self, records: list[dict], timeout: float = 60.0) -> list[dict]:
        """Predict ``records`` in a shared device batch; raises :class:`Busy`
        when the request queue is full and ``TimeoutError`` after
        ``timeout`` seconds."""
        if not records:
            return []  # zero chunks would otherwise never set ``done``
        done = threading.Event()
        slot: dict = {}
        t0 = time.perf_counter()
        try:
            self._q.put((records, slot, done), block=False)
        except queue.Full:
            raise self.Busy(f"request queue full ({self.max_queue})") from None
        with self._lock:
            self._wake.notify_all()  # a coalescing encoder absorbs it now
        if not done.wait(timeout):
            slot["abandoned"] = True  # both stages drop it
            raise TimeoutError(f"prediction not ready within {timeout}s")
        with self._lock:
            self._latencies.append(time.perf_counter() - t0)
            self._count += 1
        if "error" in slot:
            raise slot["error"]
        return slot["out"]

    def _encode_loop(self) -> None:
        """Stage 1: coalesce requests into groups and host-encode them one
        group ahead of the device (numpy only, no torch)."""
        carry = None  # a request that did not fit the previous group
        while True:
            first = carry if carry is not None else self._q.get()
            carry = None
            # drop requests whose client already timed out: computing answers
            # nobody reads under overload keeps the queue saturated
            if first[1].get("abandoned"):
                continue
            group = [first]
            n = len(first[0])
            # coalesce what is already waiting, up to one device batch and
            # never past it: an overflowing group would chain extra forwards
            # that every coalesced client waits for.  While two chunks are in
            # flight (one on the device, one encoded ahead) shipping another
            # small group gains nothing, so keep absorbing arrivals instead of
            # slicing concurrent 1-record requests into 1-record forwards;
            # with the pipe hungry, ship at once
            while n < self.predictor.max_batch:
                try:
                    nxt = self._q.get_nowait()
                except queue.Empty:
                    with self._lock:
                        if self._inflight < 2:
                            break  # the device needs feeding: ship now
                        # until a request arrives or a chunk finishes
                        # (submit / _item_done notify); the timeout is a safety net
                        self._wake.wait(timeout=0.05)
                    continue
                if nxt[1].get("abandoned"):
                    continue
                if n + len(nxt[0]) > self.predictor.max_batch:
                    carry = nxt  # leads the next group instead
                    break
                group.append(nxt)
                n += len(nxt[0])
            all_records = [r for recs, _, _ in group for r in recs]
            # one request may exceed max_batch: it is encoded as several
            # chunks sharing one accumulator, delivered with the last chunk
            acc = {"probs": [], "need": 0, "failed": False}
            try:
                mb = self.predictor.max_batch
                chunks = [all_records[i: i + mb] for i in range(0, len(all_records), mb)]
                acc["need"] = len(chunks)
                for chunk in chunks:
                    np_batch, n_real = self.predictor._encode_host(chunk)
                    # count before handing over: the device thread can finish
                    # the chunk between put and a late increment, driving the
                    # counter negative and breaking the coalescing signal
                    with self._lock:
                        self._inflight += 1
                    try:
                        self._encoded_q.put((group, np_batch, n_real, acc))
                    except BaseException:
                        self._item_done()
                        raise
            except Exception as e:  # deliver the failure to every waiter
                acc["failed"] = True  # chunks already queued are dropped
                self._deliver_error(group, e)

    @staticmethod
    def _deliver_error(group, e: Exception) -> None:
        for _, slot, done in group:
            slot["error"] = e
            done.set()

    def _deliver(self, group, probs: np.ndarray) -> None:
        outs = self.predictor._format(probs)
        i = 0
        for recs, slot, done in group:
            slot["out"] = outs[i: i + len(recs)]
            i += len(recs)
            done.set()

    def _finalize(self, pending) -> None:
        """Block on one in-flight chunk's readback; deliver its group once
        the accumulator holds every chunk."""
        group, probs_dev, n_real, acc = pending
        try:
            if acc["failed"]:
                return
            try:
                acc["probs"].append(self.predictor._readback(probs_dev)[:n_real])
                if len(acc["probs"]) == acc["need"]:
                    self._deliver(group, np.concatenate(acc["probs"]))
            except Exception as e:
                acc["failed"] = True
                self._deliver_error(group, e)
        finally:
            self._item_done()

    def _device_loop(self) -> None:
        """Stage 2, the only thread that touches torch: queue chunk k+1's
        forward before blocking on chunk k's readback; finish at once when
        nothing else is queued."""
        pred = self.predictor
        pending = None  # (group, device probs, n_real, acc) in flight
        while True:
            if pending is not None:
                try:
                    item = self._encoded_q.get_nowait()
                except queue.Empty:
                    # pipe empty: finish the in-flight chunk now rather than
                    # holding its clients hostage to future traffic
                    self._finalize(pending)
                    pending = None
                    continue
            else:
                item = self._encoded_q.get()
            group, np_batch, n_real, acc = item
            if acc["failed"]:
                self._item_done()
                continue
            # the encoder runs ahead of the device: drop a chunk whose clients
            # all timed out while it waited
            if all(slot.get("abandoned") for _, slot, _ in group):
                self._item_done()
                continue
            try:
                probs_dev = pred._forward(np_batch)
            except Exception as e:
                acc["failed"] = True
                self._deliver_error(group, e)
                self._item_done()
                continue
            if pending is not None:
                self._finalize(pending)
            pending = (group, probs_dev, n_real, acc)

    def stats(self) -> dict:
        """Requests answered, backlog, and the p50/p99/max latency in ms of
        the last 1024 requests."""
        with self._lock:
            lat = list(self._latencies)
            count = self._count
            inflight = self._inflight
        # backlog = raw requests + encoded chunks on or waiting for the device
        out = {"requests": count, "queue_depth": self._q.qsize(), "inflight_chunks": inflight}
        if lat:
            ms = np.array(lat) * 1e3
            out["latency_ms"] = {"p50": round(float(np.percentile(ms, 50)), 2),
                                 "p99": round(float(np.percentile(ms, 99)), 2),
                                 "max": round(float(ms.max()), 2)}
        return out


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
