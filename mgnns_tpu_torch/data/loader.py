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
  host numpy, so epoch accounting never waits on the device.

The JAX loader's device-resident tables, epoch plans (for fused whole-epoch
programs), eval-batch cache and mesh plans are not ported (``ROADMAP.md``).
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

_HOST_KEYS = ("weight", "label", "sample_index")


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
        device="cuda",
    ):
        """``device`` raises when it is CUDA and no card is present.
        ``num_batches`` forces the epoch length: batches past the data's end
        are all padding (``weight`` 0)."""
        self.ds = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        natural = (len(dataset) + batch_size - 1) // batch_size
        if num_batches is not None and num_batches < natural:
            raise ValueError(f"num_batches={num_batches} < {natural} batches of data")
        self.num_batches = num_batches if num_batches is not None else natural
        self.seed = seed
        self.epoch = 0
        self.num_threads = num_threads
        self.with_images = with_images
        self.device = resolve_device(device)

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
            "ids": np.zeros((B, L), np.int32),
            "lens": lens,
            "mask": (np.arange(L)[None, :] < lens[:, None]).astype(np.float32),
            "eids": np.zeros((B, L, W), np.int32),
        }
        if self.with_images:
            s = self.ds.image_size
            batch["image"] = np.zeros((B, s, s, 3), np.uint8)
        return batch

    def _assemble(self, idx: np.ndarray, pool: ThreadPoolExecutor | None, rng: random.Random,
                  n_valid: int | None = None) -> dict:
        """One host (numpy) batch of the samples ``idx``."""
        B = self.batch_size
        if len(idx) == 0:
            return self._all_padding_batch()
        n = len(idx) if n_valid is None else n_valid
        pad = B - len(idx)
        full_idx = np.concatenate([idx, np.repeat(idx[-1:], pad)]) if pad else idx
        t = self.ds.text
        batch = {
            "label": self.ds.labels[full_idx],
            "weight": (np.arange(B) < n).astype(np.float32),
            "sample_index": full_idx.astype(np.int32),
            "ids": t.ids[full_idx],
            "lens": t.lens[full_idx],
            "mask": t.mask[full_idx],
            "eids": t.eids[full_idx],
        }
        if self.with_images:
            seeds = [random.Random(rng.getrandbits(32)) for _ in full_idx]
            if pool is not None:
                imgs = list(pool.map(self.ds.load_image, full_idx, seeds))
            else:
                imgs = [self.ds.load_image(i, r) for i, r in zip(full_idx, seeds)]
            batch["image"] = np.stack(imgs)
        return batch

    def _epoch_chunks(self):
        """This epoch's batch index chunks [(indices, forced_n_valid)],
        advancing the epoch counter (shuffle order differs per epoch)."""
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
        """Un-consume one epoch, so the next iteration replays its order."""
        self.epoch = max(0, self.epoch - 1)

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

    def __iter__(self) -> Iterator[dict]:
        rng = random.Random(self.seed + self.epoch + 1)
        chunks = self._epoch_chunks()
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
            pool = ThreadPoolExecutor(self.num_threads) if self.with_images else None
            try:
                for chunk, n_valid in chunks:
                    if stop.is_set():
                        return
                    if not put_or_stop(self._place(self._assemble(chunk, pool, rng, n_valid), stream)):
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
                    return
                if isinstance(item, BaseException):
                    raise item
                batch, event = item
                if event is not None:
                    current = torch.cuda.current_stream(self.device)
                    current.wait_event(event)
                    for v in batch.values():
                        if isinstance(v, torch.Tensor):
                            v.record_stream(current)
                yield batch
        finally:
            stop.set()
            thread.join()
