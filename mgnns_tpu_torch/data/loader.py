"""Host-streaming loader: threaded image decode, static-shape batches and a
background producer that moves each batch to the device.

Port of the streaming part of the JAX package's ``mgnns_tpu/data/loader.py:
DeviceLoader``, with its names and behaviour:

- text tensors are slices of the split's prebuilt arrays;
- every batch has the same shape: the last, short batch is padded by
  repeating its last sample, with ``weight`` 0 on the padding rows;
- shuffling draws from ``np.random.default_rng(seed + epoch)`` and each
  image's transform from a ``random.Random`` seeded off
  ``random.Random(seed + epoch + 1)``, so both packages see the same order
  and the same crops;
- a producer thread assembles batches (images decode on a thread pool) and
  copies them to the device through a bounded queue, overlapping host work
  with the steps; on CUDA the copies run on a side stream from pinned memory
  and the consumer's stream waits for each batch's copy;
- the per-batch [B] vectors ``weight``, ``label`` and ``sample_index`` stay
  host numpy, so epoch accounting never waits on the device;
- ``device_text`` / ``device_images`` keep the split's text tensors and
  labels, and its pixels as a flattened ``[N, H*W*3]`` table of the
  dataset's pixel dtype (uint8, or float32 normalized pixels), on the
  device, uploaded once per dataset and shared by every loader over it;
  batches then gather those rows on the device by sample index;
- when every input is in tables, :meth:`DeviceLoader.epoch_plan` describes
  an epoch as the tables plus ``[num_batches, B]`` index and weight
  matrices, which the engine runs as captured steps
  (:mod:`mgnns_tpu_torch.engine.graphs`);
- ``cache_device_batches`` keeps an unshuffled split's device batches from
  its first epoch and replays them, up to ``cache_budget_bytes``: past the
  budget the cache stops for good, so it stays a contiguous prefix and the
  rest streams.

Tables are built on the consumer's thread, and the plan path runs no
producer thread.

On a data axis (``plan=``, an :class:`~mgnns_tpu_torch.parallel.input.
InputPlan` of this rank, the counterpart of the JAX loader's ``mesh=``) the
loader serves this rank's rows of every global batch: ``batch_size`` is the
plan's ``Bd``, an epoch is the plan's ``num_batches`` on every rank (a rank
whose records run out runs all-padding batches), and each batch carries
``weight_total``, the global batch's weight sum.  The tables hold only this
rank's ``S`` rows, and :meth:`DeviceLoader.epoch_plan` indexes them with
position-local ids; the streaming path assembles this rank's rows on the
host and reads no table, as the JAX loader does under a mesh.  Record ids
of predictions are the dataset's plus ``record_offset``, the first record
of this host's slice.
"""

from __future__ import annotations

import queue
import random
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

import numpy as np
import torch

from mgnns_tpu_torch.utils import resolve_device

_HOST_KEYS = ("weight", "label", "sample_index", "weight_total")


class DeviceLoader:
    def __init__(
        self,
        dataset,
        batch_size: int,
        *,
        shuffle: bool = False,
        seed: int = 0,
        num_threads: int = 8,
        with_images: bool = True,
        num_batches: int | None = None,
        cache_device_batches: bool = False,
        cache_budget_bytes: int | None = None,
        device_images: bool = False,
        device_text: bool = False,
        device="cuda",
        plan=None,
    ):
        """``device`` raises when it is CUDA and no card is present.
        ``num_batches`` forces the epoch length: batches past the data's end
        are all padding (``weight`` 0).  ``device_images`` raises unless the
        dataset's pixels are deterministic per sample (eval transforms or
        the synthetic backend).  ``plan``: this rank's input plan (see the
        module's docstring); ``batch_size`` must be its ``Bd``."""
        self.ds = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.plan = plan
        self.record_offset = getattr(dataset, "record_offset", 0)
        if plan is not None and (batch_size != plan.Bd or num_batches is not None):
            raise ValueError(f"under a plan the batch size is its Bd ({plan.Bd}, got "
                             f"{batch_size}) and the epoch length its num_batches")
        natural = (plan.num_batches if plan is not None
                   else (len(dataset) + batch_size - 1) // batch_size)
        if num_batches is not None and num_batches < natural:
            raise ValueError(f"num_batches={num_batches} < {natural} batches of data")
        self.num_batches = num_batches if num_batches is not None else natural
        self.seed = seed
        self.epoch = 0
        self.num_threads = num_threads
        self.with_images = with_images
        self.device = resolve_device(device)
        if cache_device_batches and shuffle:
            raise ValueError("cache_device_batches requires shuffle=False")
        self.cache_device_batches = cache_device_batches
        self.cache_budget_bytes = cache_budget_bytes
        self._device_cache: list = []
        self._cache_bytes = 0
        self._cache_complete = False
        self._cache_stopped = False
        if device_images and not dataset.cacheable_images():
            raise ValueError("device_images requires deterministic per-sample pixels "
                             "(eval transforms or the synthetic backend)")
        self.device_images = device_images and with_images
        self.device_text = device_text
        # under a plan the tables feed only the epoch plan: batches stream whole
        self._stream_text = device_text and plan is None
        self._stream_images = self.device_images and plan is None

    def __len__(self) -> int:
        return self.num_batches

    def _all_padding_batch(self) -> dict:
        """A fully padded batch (an empty dataset slice): PAD-only documents
        of length 1, so the compute stays finite, with ``weight`` all 0."""
        B = self.batch_size
        t = self.ds.text
        L, W = t.ids.shape[1], t.eids.shape[2]
        lens = np.ones((B,), np.int32)
        batch = {
            "label": np.zeros((B,), np.int32),
            "weight": np.zeros((B,), np.float32),
            "sample_index": np.zeros((B,), np.int32),
        }
        if not self._stream_text:
            batch.update(ids=np.zeros((B, L), np.int32), lens=lens,
                         mask=(np.arange(L)[None, :] < lens[:, None]).astype(np.float32),
                         eids=np.zeros((B, L, W), np.int32))
        if self.with_images and not self._stream_images:
            s = self.ds.image_size
            batch["image"] = np.zeros((B, s, s, 3), np.uint8)
        return batch

    def _padded(self, idx: np.ndarray) -> np.ndarray:
        """A batch's sample indices, the last repeated up to the batch size."""
        pad = self.batch_size - len(idx)
        return np.concatenate([idx, np.repeat(idx[-1:], pad)]) if pad else idx

    def _assemble(self, idx: np.ndarray, pool: ThreadPoolExecutor | None, rng: random.Random,
                  n_valid: int | None = None) -> dict:
        """One host (numpy) batch of the samples ``idx``."""
        B = self.batch_size
        if len(idx) == 0:
            return self._all_padding_batch()
        n = len(idx) if n_valid is None else n_valid
        full_idx = self._padded(idx)
        t = self.ds.text
        batch = {
            "label": self.ds.labels[full_idx],
            "weight": (np.arange(B) < n).astype(np.float32),
            "sample_index": full_idx.astype(np.int32),
        }
        if not self._stream_text:
            batch.update(ids=t.ids[full_idx], lens=t.lens[full_idx], mask=t.mask[full_idx],
                         eids=t.eids[full_idx])
        if self.with_images and not self._stream_images:
            seeds = [random.Random(rng.getrandbits(32)) for _ in full_idx]
            if pool is not None:
                imgs = list(pool.map(self.ds.load_image, full_idx, seeds))
            else:
                imgs = [self.ds.load_image(i, r) for i, r in zip(full_idx, seeds)]
            batch["image"] = np.stack(imgs)
        return batch

    # ------------------------------------------------------- device tables

    def _tables(self) -> dict:
        """The dataset's device tables, shared by every loader over it."""
        return self.ds.__dict__.setdefault("_device_tables", {})

    def _table_rows(self) -> np.ndarray | None:
        """The dataset rows of the tables: this rank's under a plan, else
        None (every row)."""
        return None if self.plan is None else self.plan.rank_table_rows()

    def _table_key(self, kind: str) -> tuple:
        rows = self._table_rows()
        return (kind, str(self.device), None if rows is None else rows.tobytes())

    def _ensure_text_tables(self) -> dict:
        """``ids``, ``lens``, ``mask``, ``eids`` and ``label`` of the whole
        split (of this rank's rows under a plan) on the device, uploaded
        once."""
        key = self._table_key("text")
        cache = self._tables()
        if key not in cache:
            t = self.ds.text
            src = {"ids": t.ids, "lens": t.lens, "mask": t.mask, "eids": t.eids,
                   "label": self.ds.labels}
            rows = self._table_rows()
            if rows is not None:
                src = {k: v[rows] for k, v in src.items()}
            cache[key] = {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                          for k, v in src.items()}
        return cache[key]

    def _ensure_image_table(self, chunk_rows: int = 128) -> tuple[torch.Tensor, tuple]:
        """(the split's pixels, of this rank's rows under a plan, as an
        [N, H*W*3] device table of the dataset's pixel dtype (uint8 raw
        pixels, or float32 normalized ones), (H, W, 3)).  The pool decodes chunk k+1
        while chunk k is copied in, so the host holds about two chunks of
        pixels."""
        key = self._table_key("image")
        cache = self._tables()
        if key not in cache:
            rows = self._table_rows()
            rows = np.arange(len(self.ds)) if rows is None else rows
            N = len(rows)
            probe = self.ds.load_image(int(rows[0]))
            table = torch.empty((N, probe.size), dtype=torch.from_numpy(probe).dtype,
                                device=self.device)
            chunks = [rows[s:s + chunk_rows] for s in range(0, N, chunk_rows)]
            with ThreadPoolExecutor(self.num_threads) as pool:
                ahead = [pool.submit(self.ds.load_image, i) for i in chunks[0]]
                for k, rows in enumerate(chunks):
                    now = ahead
                    if k + 1 < len(chunks):
                        ahead = [pool.submit(self.ds.load_image, i) for i in chunks[k + 1]]
                    arr = np.stack([f.result() for f in now]).reshape(len(rows), -1)
                    start = k * chunk_rows
                    table[start:start + len(rows)].copy_(torch.from_numpy(arr))
            cache[key] = (table, tuple(probe.shape))
        return cache[key]

    def _gather_tables(self, batch: dict) -> dict:
        """Add the table-resident tensors of ``batch``'s samples, gathered
        on the device by ``sample_index``."""
        if not (self._stream_text or self._stream_images):
            return batch
        idx = torch.from_numpy(np.asarray(batch["sample_index"], np.int64)).to(self.device)
        out = dict(batch)
        if self._stream_text:
            tabs = self._ensure_text_tables()
            for k in ("ids", "lens", "mask", "eids"):
                out[k] = tabs[k].index_select(0, idx)
        if self._stream_images:
            table, row_shape = self._ensure_image_table()
            out["image"] = table.index_select(0, idx).view((len(idx),) + row_shape)
        return out

    def _plan_epoch(self) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """(idx, weight, rows, weight_total) of this epoch under a plan, this
        rank's ``[num_batches, Bd]`` columns (``parallel.input.
        epoch_index_plan``) and ``[num_batches]`` global sums.  Advances the
        epoch counter."""
        from mgnns_tpu_torch.parallel.input import epoch_index_plan

        plan = self.plan
        idx, wt, rows = (plan.rank_columns(a) for a in
                         epoch_index_plan(plan, self.epoch, self.seed, self.shuffle))
        self.epoch += 1
        return idx, wt, rows, plan.batch_weight_sums()

    def _epoch_chunks(self):
        """This epoch's batch index chunks [(indices, forced_n_valid)],
        advancing the epoch counter (shuffle order differs per epoch); under
        a plan, each chunk is this rank's padded rows of a global batch."""
        if self.plan is not None:
            _, wt, rows, _ = self._plan_epoch()
            return [(r if len(self.ds) else r[:0], int(w.sum())) for r, w in zip(rows, wt)]
        order = np.arange(len(self.ds))
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(order)
        self.epoch += 1
        chunks = [(order[i: i + self.batch_size], None)
                  for i in range(0, len(order), self.batch_size)]
        # forced epoch length: all-padding batches past the data's end
        chunks += [(order[-1:], 0)] * (self.num_batches - len(chunks))
        return chunks

    def rewind_epoch(self) -> None:
        """Un-consume one epoch, so the next iteration (or plan) replays its
        order."""
        self.epoch = max(0, self.epoch - 1)

    def epoch_plan(self) -> dict | None:
        """One epoch as device tables plus ``idx`` and ``weight``, host
        ``[num_batches, B]`` matrices of sample indices (int32, padding
        repeats a batch's last sample) and 0/1 weights, with ``labels`` of
        ``idx`` and the logical ``row_shapes`` of flattened tables.  None
        unless every input the batches need is in tables (``device_text``,
        and ``device_images`` when images are used).  Advances the epoch
        counter as an iteration does.  Under an input plan ``idx`` indexes
        this rank's table rows, and the plan also holds ``sample_index``
        (global record ids) and ``weight_total`` ``[num_batches]``."""
        if not (self.device_text and (self.device_images or not self.with_images)):
            return None
        if self.plan is not None:
            idx, wt, rows, totals = self._plan_epoch()
            out = {"tables": dict(self._ensure_text_tables()), "idx": idx, "weight": wt,
                   "labels": self.ds.labels[rows] if len(self.ds) else np.zeros_like(idx),
                   "row_shapes": {}, "sample_index": rows + self.record_offset,
                   "weight_total": totals}
            if self.device_images:
                out["tables"]["image"], out["row_shapes"]["image"] = self._ensure_image_table()
            return out
        chunks = self._epoch_chunks()
        B = self.batch_size
        idx = np.zeros((len(chunks), B), np.int32)
        wt = np.zeros((len(chunks), B), np.float32)
        for i, (chunk, n_valid) in enumerate(chunks):
            n = len(chunk) if n_valid is None else n_valid
            idx[i] = self._padded(chunk)
            wt[i] = np.arange(B) < n
        tables = dict(self._ensure_text_tables())
        row_shapes = {}
        if self.device_images:
            tables["image"], row_shapes["image"] = self._ensure_image_table()
        return {"tables": tables, "idx": idx, "weight": wt, "labels": self.ds.labels[idx],
                "row_shapes": row_shapes}

    def _place(self, item: dict, stream) -> tuple[dict, object]:
        """Copy a host batch's large arrays to the device (on ``stream`` from
        pinned memory when the device is CUDA); the [B] vectors stay host
        numpy.  Returns (batch, the copy's event or None)."""
        out = {k: item[k] for k in _HOST_KEYS if k in item}
        big = {k: v for k, v in item.items() if k not in out}
        if stream is None:
            out.update({k: torch.from_numpy(v).to(self.device) for k, v in big.items()})
            return out, None
        with torch.cuda.stream(stream):
            for k, v in big.items():
                out[k] = torch.from_numpy(v).pin_memory().to(self.device, non_blocking=True)
            event = torch.cuda.Event()
            event.record(stream)
        return out, event

    def _cache(self, batch: dict, nbytes: int) -> None:
        """Keep a (table-free) device batch of the first epoch until the byte
        budget is reached; the stop is a latch, so the cache stays a
        contiguous prefix of the epoch."""
        if not self.cache_device_batches or self._cache_complete or self._cache_stopped:
            return
        if (self.cache_budget_bytes is not None
                and self._cache_bytes + nbytes > self.cache_budget_bytes):
            self._cache_stopped = True
            return
        self._cache_bytes += nbytes
        self._device_cache.append(batch)

    def __iter__(self) -> Iterator[dict]:
        n_cached = len(self._device_cache)
        for batch in self._device_cache:
            # cached batches hold no table rows; gather them again
            yield self._gather_tables(batch)
        if n_cached and self._cache_complete:
            return
        rng = random.Random(self.seed + self.epoch + 1)
        totals = (self.plan.batch_weight_sums() if self.plan is not None
                  else np.zeros(0))[n_cached:]
        # caching requires shuffle=False, so the epoch's batches are the same
        # every epoch: stream what follows the cached prefix
        chunks = self._epoch_chunks()[n_cached:]
        q: queue.Queue = queue.Queue(maxsize=3)
        stop = threading.Event()
        stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None

        def put_or_stop(item) -> bool:
            # a put that gives up once the consumer has left the epoch
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            pool = (ThreadPoolExecutor(self.num_threads)
                    if self.with_images and not self._stream_images else None)
            try:
                for b, (chunk, n_valid) in enumerate(chunks):
                    if stop.is_set():
                        return
                    item = self._assemble(chunk, pool, rng, n_valid)
                    if self.plan is not None:
                        item["weight_total"] = np.float32(totals[b])
                    nbytes = sum(np.asarray(v).nbytes for v in item.values())
                    if not put_or_stop((*self._place(item, stream), nbytes)):
                        return
                put_or_stop(None)
            except BaseException as e:  # surface producer errors to the consumer
                put_or_stop(e)
            finally:
                if pool is not None:
                    pool.shutdown(wait=False, cancel_futures=True)

        thread = threading.Thread(target=produce, daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    if self.cache_device_batches:
                        self._cache_complete = len(self._device_cache) == self.num_batches
                    return
                if isinstance(item, BaseException):
                    raise item
                batch, event, nbytes = item
                if event is not None:
                    current = torch.cuda.current_stream(self.device)
                    current.wait_event(event)
                    for v in batch.values():
                        if isinstance(v, torch.Tensor):
                            v.record_stream(current)
                self._cache(batch, nbytes)
                yield self._gather_tables(batch)
        finally:
            stop.set()
            thread.join()
