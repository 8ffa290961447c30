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

``Predictor(mesh=...)`` serves on a ``('data', 'model')`` mesh
(:func:`mgnns_tpu_torch.parallel.mesh.create_mesh`), the counterpart of
``mgnns_tpu/serving.py:106-136``: every rank builds the Predictor from the
same whole weights and calls :meth:`Predictor.predict` with the same
records (SPMD); the parameters split over ``'model'`` by the training
rules, each bucket splits over ``'data'``, and the answers are gathered so
that every rank returns the whole request.  Behind HTTP
(``cli.serve --mesh_data/--mesh_model``) only rank 0 takes requests: its
:class:`BatchingFrontend` hands each encoded chunk to the other ranks
through a :class:`MeshLink`, and they run it in the same order.

Each chunk's host work is :mod:`mgnns_tpu_torch.tracing` spans tagged with
the chunk's id (``chunk``, one sequence for the process):
``serving.encode_text`` and ``serving.decode_images`` (host encode),
``serving.dispatch`` (H2D copy and the forward's launches, the model's
``mgnns.*`` spans inside it) and ``serving.readback`` (the wait for the
probabilities and their copy); ``tracing.spans("serving.")`` reads them.
"""

from __future__ import annotations

import collections
import datetime
import itertools
import json
import logging
import os
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from mgnns_tpu_torch import tracing
from mgnns_tpu_torch.config import DataConfig, ModelConfig, TextGraphConfig
from mgnns_tpu_torch.data import images as I
from mgnns_tpu_torch.data.text import build_text_side, encode_texts
from mgnns_tpu_torch.graphs.pmi import PmiGraph
from mgnns_tpu_torch.graphs.vocab import make_word_to_id
from mgnns_tpu_torch.models.mgnns import DEAD_MODULES, mgnns_apply
from mgnns_tpu_torch.models.text_only import text_model_apply
from mgnns_tpu_torch.utils import resolve_device, tree_leaves, tree_paths, tree_to

# the id of each chunk that a Predictor or a frontend runs, for its spans
_chunk_ids = itertools.count()


def resolve_batch_buckets(requested: list[int] | None, max_batch: int,
                          dsize: int = 1) -> list[int]:
    """Batch-size bucket ladder: a request for n records runs the smallest
    batch >= n instead of always the full ``max_batch``.  Defaults to powers
    of 4 of the smallest size the mesh's data axis of ``dsize`` positions
    divides, below ``max_batch``; every bucket must divide by ``dsize``
    (``mgnns_tpu/serving.py:37-60``)."""
    if requested is None:
        requested = []
        b = max(1, dsize)
        while b < max_batch:
            requested.append(b)
            b *= 4
    buckets = sorted({int(b) for b in requested} | {max_batch})
    for b in buckets:
        if b > max_batch or b % max(1, dsize) != 0 or b < 1:
            raise ValueError(
                f"batch bucket {b} invalid (max_batch {max_batch}, "
                f"mesh data axis {dsize})")
    return buckets


def eval_probs(params: dict, batch_stats: dict | None, consts: dict | None, batch: dict, *,
               text_only: bool, ngram: int, cfg: ModelConfig | None,
               model=None) -> torch.Tensor:
    """The serving forward: the model's eval forward and a float32 softmax
    over the labels, [B, num_labels].  :class:`Predictor` runs it, and
    :mod:`mgnns_tpu_torch.export` exports it.  ``model``: the view of the
    model axis when ``params`` are this rank's shards."""
    if text_only:
        logits = text_model_apply(params, batch, ngram=ngram, model=model)
    else:
        logits = mgnns_apply(params, batch_stats, consts, batch, cfg=cfg, model=model)[0]
    return torch.softmax(logits.float(), dim=-1)


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
        forward_fn=None,
        image_size: int | None = None,
        device="cuda",
        mesh=None,
    ):
        """``params``: the text-only model's (``text_only=True``) or the
        fusion model's, e.g. from :mod:`mgnns_tpu_torch.convert`; the fusion
        model also takes its ``batch_stats``, ``consts`` and ``cfg``.
        ``forward_fn(params, batch_stats, batch) -> probs`` replaces the
        model's eval forward and softmax (:func:`eval_probs`), as the JAX
        Predictor's ``apply_fn`` does; an exported program
        (:func:`mgnns_tpu_torch.export.load_exported`) needs no ``consts`` or
        ``cfg``, only the ``image_size`` it was exported at.
        Everything is moved to ``device``, which raises when it is CUDA and
        no card is present.  ``mesh``: serve on its data and model axes
        (see the module's docstring); every rank builds the Predictor."""
        if forward_fn is None and not text_only and (
                batch_stats is None or consts is None or cfg is None):
            raise ValueError("the fusion model needs batch_stats, consts and cfg")
        if mesh is not None and forward_fn is not None:
            raise ValueError("a mesh needs the live model: an exported program is a "
                             "single-device program")
        if mesh is not None:
            from mgnns_tpu_torch.parallel.sharding import refuse_encoder

            refuse_encoder(params, "a mesh")
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
        self.forward_fn = forward_fn
        if image_size is None:
            image_size = cfg.image_size if cfg is not None else 0
        self.image_size = image_size
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
        self.data = self.shards = None
        if mesh is not None:
            from mgnns_tpu_torch.parallel.collectives import DataAxis, ModelAxis
            from mgnns_tpu_torch.parallel.sharding import (
                Shards, mgnns_param_rules, shard_tree, text_model_param_rules,
            )

            self.data = DataAxis.of(mesh, self.device)
            if max_batch % self.data.size:
                raise ValueError(f"max_batch {max_batch} must be a multiple of the mesh data "
                                 f"axis ({self.data.size})")
            model = ModelAxis.of(mesh, self.device)
            if model.size > 1:
                rules = text_model_param_rules() if text_only else mgnns_param_rules()
                self.params, placements = shard_tree(self.params, model, rules,
                                                     heads=None if cfg is None else cfg.n_head)
                self.shards = Shards(model, placements)
        dsize = 1 if self.data is None else self.data.size
        self.batch_buckets = resolve_batch_buckets(batch_buckets, max_batch, dsize)

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

        with tracing.span("serving.encode_text"):
            ids, lens, mask, eids = encode_texts(
                [r["text"] for r in records], self.w2i, self.graph, self.graph_cfg)
        batch = {"ids": padrow(ids), "lens": padrow(lens),
                 "mask": padrow(mask), "eids": padrow(eids)}
        if not self.text_only:
            with tracing.span("serving.decode_images"):
                batch["image"] = padrow(self._encode_images(records))
        return batch, n

    # ------------------------------------------------------------- predict

    @tracing.span("serving.dispatch")
    def _forward(self, batch_np: dict) -> torch.Tensor:
        """H2D copy + eval forward + softmax; returns device probs without
        waiting for them.  ``batch_np``: :meth:`_encode_host`'s numpy arrays,
        or tensors of the same shapes (on ``device`` they are not copied).
        On a mesh each data position runs its block of the bucket's rows,
        and the blocks are gathered (a collective)."""
        if self.data is not None and self.data.size > 1:
            rows = next(iter(batch_np.values())).shape[0] // self.data.size
            batch_np = {k: v[self.data.rank * rows:(self.data.rank + 1) * rows]
                        for k, v in batch_np.items()}
        batch = {k: torch.as_tensor(v, device=self.device) for k, v in batch_np.items()}
        with torch.inference_mode():
            if self.forward_fn is not None:
                probs = self.forward_fn(self.params, self.batch_stats, batch)
            else:
                probs = eval_probs(self.params, self.batch_stats, self.consts, batch,
                                   text_only=self.text_only, ngram=self.graph_cfg.ngram,
                                   cfg=self.cfg, model=self.shards)
            if self.data is not None and self.data.size > 1:
                from mgnns_tpu_torch.parallel.collectives import gather_cat

                probs = gather_cat(probs, self.data)
        return probs

    @staticmethod
    @tracing.span("serving.readback")
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
        pending = None  # (device probs, n, chunk id) of the chunk in flight
        for i in range(0, len(records), self.max_batch):
            chunk = next(_chunk_ids)
            with tracing.tags(chunk=chunk):
                batch, n = self._encode_host(records[i : i + self.max_batch])
                probs = self._forward(batch)
            if pending is not None:
                out.extend(self._format(self._finish(*pending)))
            pending = (probs, n, chunk)
        if pending is not None:
            out.extend(self._format(self._finish(*pending)))
        return out

    def _finish(self, probs: torch.Tensor, n: int, chunk: int) -> np.ndarray:
        """The first ``n`` rows of a chunk's probabilities, on the host."""
        with tracing.tags(chunk=chunk):
            return self._readback(probs)[:n]

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
        mesh=None,
    ) -> "Predictor":
        """A Predictor on ``device`` (which raises when it is CUDA and no
        card is present) from what the training CLI wrote; on ``mesh``
        every rank calls it and keeps its shards.

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
                      decode_threads=decode_threads, device=dev, mesh=mesh)
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


# closes the frontend's queues: queued behind every request, it stops each stage
_STOP = object()


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

    On a mesh, rank 0's frontend takes a ``link`` (:class:`MeshLink`): the
    device thread, the only thread of rank 0 that issues collectives, runs
    each chunk through ``link.forward``, which first hands it to the
    other ranks.  A chunk the frontend drops (its clients all gone, its
    group's encode failed) is dropped before that, so the other ranks never
    see it.  :meth:`close` finishes what is queued and, on a mesh, tells the
    other ranks to stop.
    """

    class Busy(RuntimeError):
        pass

    def __init__(self, predictor: Predictor, max_queue: int = 256,
                 link: "MeshLink | None" = None):
        self.predictor = predictor
        self.max_queue = max_queue
        self.link = link
        self._closed = False
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
        self._encoder = threading.Thread(target=self._encode_loop, name="encode", daemon=True)
        self._worker = threading.Thread(target=self._device_loop, name="device", daemon=True)
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
        if self._closed:
            raise RuntimeError("the frontend is closed")
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
            if first is _STOP:  # behind every request queued before close()
                self._encoded_q.put(_STOP)
                return
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
                if nxt is _STOP:
                    carry = nxt  # after this group
                    break
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
                    cid = next(_chunk_ids)
                    with tracing.tags(chunk=cid):
                        np_batch, n_real = self.predictor._encode_host(chunk)
                    # count before handing over: the device thread can finish
                    # the chunk between put and a late increment, driving the
                    # counter negative and breaking the coalescing signal
                    with self._lock:
                        self._inflight += 1
                    try:
                        self._encoded_q.put((group, np_batch, n_real, acc, cid))
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
        group, probs_dev, n_real, acc, cid = pending
        try:
            if acc["failed"]:
                return
            try:
                with tracing.tags(chunk=cid):
                    probs = self.predictor._readback(probs_dev)
                acc["probs"].append(probs[:n_real])
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
        pending = None  # (group, device probs, n_real, acc, chunk id) in flight
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
            if item is _STOP:
                if pending is not None:
                    self._finalize(pending)
                if self.link is not None:
                    self.link.stop()
                return
            group, np_batch, n_real, acc, cid = item
            if acc["failed"]:
                self._item_done()
                continue
            # the encoder runs ahead of the device: drop a chunk whose clients
            # all timed out while it waited
            if all(slot.get("abandoned") for _, slot, _ in group):
                self._item_done()
                continue
            try:
                with tracing.tags(chunk=cid):
                    probs_dev = (pred._forward(np_batch) if self.link is None
                                 else self.link.forward(np_batch, n_real))
            except Exception as e:
                acc["failed"] = True
                self._deliver_error(group, e)
                self._item_done()
                continue
            if pending is not None:
                self._finalize(pending)
            pending = (group, probs_dev, n_real, acc, cid)

    def close(self, timeout: float = 60.0) -> None:
        """Answer what is queued, then stop both threads (and, on a mesh,
        the other ranks: the device thread's last act is ``link.stop()``).
        Raises if they do not stop within ``timeout`` seconds; a second call
        waits as the first does."""
        with self._lock:
            first, self._closed = not self._closed, True
        if first:
            self._q.put(_STOP)
        for t in (self._encoder, self._worker):
            t.join(timeout)
            if t.is_alive():
                raise RuntimeError(f"the frontend's {t.name} thread did not stop in {timeout} s")

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


class MeshLink:
    """Rank 0's front end and the other ranks of a mesh, serving one chunk
    at a time.

    ``Predictor(mesh=...).predict`` is SPMD: every rank runs each chunk.
    Behind HTTP only rank 0 gets the requests, so its
    :class:`BatchingFrontend` runs each chunk through :meth:`forward`, which
    broadcasts it from rank 0 before running ``Predictor._forward``; every
    other rank sits in :meth:`follow`, which receives each chunk and runs the
    same ``_forward`` (its data block, the model axis's collectives, the
    gather), in the same order, and drops the probabilities.  Per chunk:

    1. a header of :data:`HEADER` int64s, ``(op, rows, n_real, has_image)``,
       over a CPU gloo group with a deadline of :data:`CONTROL_TIMEOUT`: a
       follower waits in it for as long as no request comes, which NCCL's
       watchdog (10 min) or gloo's default timeout (30 min) would end;
    2. the encoded arrays (``ids``, ``lens``, ``mask``, ``eids`` and the
       fusion model's ``image``) over the world group, the mesh's own (NCCL
       on the card): one collective per dtype into device tensors, which the
       follower feeds to ``_forward`` as they are.  Encoded arrays, not
       records, so that only rank 0 tokenizes or opens an image (the images
       may live on its node only), and every rank runs the same bits.

    :meth:`stop` sends the header that ends :meth:`follow`.  Every rank of
    the world constructs a link, in the same order (it makes a group).
    """

    FORWARD, STOP = 1, 0
    HEADER = 4
    CONTROL_TIMEOUT = datetime.timedelta(days=365)

    def __init__(self, predictor: Predictor):
        import torch.distributed as dist

        from mgnns_tpu_torch.parallel.collectives import world_axis

        self.predictor = predictor
        self.world = world_axis(predictor.device)
        self.control = dist.new_group(backend="gloo", timeout=self.CONTROL_TIMEOUT)
        self.chunks = 0          # chunks this rank ran through the link
        self.headers = 0         # headers sent (rank 0) or received
        self.payload_bytes: list[int] = []  # each chunk's arrays

    @property
    def leader(self) -> bool:
        return self.world.rank == 0

    def _spec(self, rows: int, has_image: bool) -> dict:
        """{field: (shape, dtype)} of a chunk of ``rows`` rows, as
        ``Predictor._encode_host`` makes it."""
        p = self.predictor
        L, W = p.graph_cfg.max_len, 2 * p.graph_cfg.ngram + 1
        spec = {"ids": ((rows, L), torch.int32), "lens": ((rows,), torch.int32),
                "mask": ((rows, L), torch.float32), "eids": ((rows, L, W), torch.int32)}
        if has_image:
            spec["image"] = ((rows, p.image_size, p.image_size, 3), torch.uint8)
        return spec

    def _header(self, *fields: int) -> list[int]:
        import torch.distributed as dist

        h = torch.zeros(self.HEADER, dtype=torch.int64)
        h[:len(fields)] = torch.tensor(fields, dtype=torch.int64)
        dist.broadcast(h, src=0, group=self.control)
        self.headers += 1
        return h.tolist()

    def _payload(self, tensors: dict) -> None:
        from mgnns_tpu_torch.parallel.collectives import broadcast_

        broadcast_(list(tensors.values()), self.world)
        self.chunks += 1
        self.payload_bytes.append(sum(t.numel() * t.element_size() for t in tensors.values()))

    def forward(self, batch_np: dict, n_real: int) -> torch.Tensor:
        """Rank 0: hand the chunk to every rank, then run it; the device
        probabilities.  A chunk that does not match the spec raises before
        anything is sent."""
        rows = len(batch_np["ids"])
        has_image = "image" in batch_np
        spec = self._spec(rows, has_image)
        if batch_np.keys() != spec.keys():
            raise ValueError(f"chunk fields {sorted(batch_np)}, the mesh's {sorted(spec)}")
        dev = self.predictor.device
        tensors = {k: torch.as_tensor(np.ascontiguousarray(batch_np[k]), device=dev)
                   for k in spec}
        bad = {k: (tuple(t.shape), t.dtype) for k, t in tensors.items()
               if (tuple(t.shape), t.dtype) != spec[k]}
        if bad:
            raise ValueError(f"chunk fields {bad} do not match the mesh's {spec}")
        self._header(self.FORWARD, rows, n_real, int(has_image))
        self._payload(tensors)
        return self.predictor._forward(tensors)

    def stop(self) -> None:
        """Rank 0: end every other rank's :meth:`follow`."""
        self._header(self.STOP)

    def follow(self) -> int:
        """Ranks > 0: run every chunk rank 0 sends until it says stop; the
        number of chunks run.  A forward that raises raised on rank 0 too
        (the same inputs): it is logged, and the loop goes on."""
        dev = self.predictor.device
        while True:
            op, rows, n_real, has_image = self._header()
            if op == self.STOP:
                return self.chunks
            tensors = {k: torch.empty(shape, dtype=dtype, device=dev)
                       for k, (shape, dtype) in self._spec(rows, bool(has_image)).items()}
            self._payload(tensors)
            try:
                self.predictor._forward(tensors)
            except Exception:
                logging.getLogger(__name__).exception(
                    "rank %d: the forward of a %d-row chunk (%d real) failed",
                    self.world.rank, rows, n_real)


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
