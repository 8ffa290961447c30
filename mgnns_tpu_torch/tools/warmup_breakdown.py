"""Where the live eval path's warm-up goes, phase by phase.

The counterpart of the JAX package's ``tools/warmup_breakdown.py``, with its
phases and keys.  Over the split of
:func:`~mgnns_tpu_torch.tools._bench_util.flagship_data` (the seeded
synthetic corpus's 10,000 records at 448 px unless ``WB_SAMPLES`` cuts it)
it measures, in order:

- ``setup_seconds``: the data (vocabulary, PMI graph, dataset) and the
  model's weights on the device;
- ``decode_seconds``: the host synthesis (or decode) of every record's
  pixels on 8 threads, as the loader's pool does, then ``upload_seconds``
  for the ``[N, H*W*3]`` pixel table's ``.to(device)`` up to a readback,
  with ``upload_mb`` and ``upload_mb_per_s``; or, with ``WB_PIPELINED=1``,
  ``table_build_seconds`` and ``table_build_mb_per_s`` of the loader's own
  chunked build (``DeviceLoader._ensure_image_table``, which synthesizes
  chunk k+1 while chunk k is copied in);
- ``text_table_upload_seconds``: the text tables;
- ``first_epoch_seconds``: the first eval epoch with the tables resident
  (``Engine(eval_only=True)``: the eval step's capture and its replays), with
  ``capture_seconds`` in the place of the JAX tool's ``compile_seconds``;
- ``epoch_seconds``, ``samples_per_sec`` and ``fused`` of the steady epoch,
  and ``time_to_first_result_seconds``, the first epoch's end from the
  process's start;
- ``h2d_probe_mb_per_s``: the best of 3 pageable 256 MB copies to the
  device, run last so that it cannot delay the first result.

``MGNNS_COLD=1`` is the counterpart of a cold XLA cache: before first use
the tool points :data:`mgnns_tpu_torch.kernels.build.BUILD_DIR` at a fresh
temporary directory, so the first epoch pays the ``nvcc`` build of K1 and
K2 and the set-up the host compiler's build of the native preprocessing
(run the tool as its own process: a library loaded before is not built
again).  Settings: ``WB_BATCH`` (128), ``WB_SAMPLES`` (0: the whole split),
``WB_PIPELINED``, ``MGNNS_COLD``, ``MGNNS_DATA``.  Run on a card::

    python -m mgnns_tpu_torch.tools.warmup_breakdown [--platform cpu]

It prints one JSON line and writes it to
``results/torch/warmup_breakdown_{cold|warm|pipelined}.json``.
"""

from __future__ import annotations

import time

_T_PROCESS_START = time.time()

import os  # noqa: E402
import shutil  # noqa: E402
import tempfile  # noqa: E402
from concurrent.futures import ThreadPoolExecutor  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from mgnns_tpu_torch.tools import _bench_util as U  # noqa: E402

PROBE_MB = 256


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def h2d_probe(dev: torch.device, probe_mb: int) -> float:
    """MB/s of the best of 3 pageable ``probe_mb`` MB copies to ``dev``,
    each up to a readback (later copies skip one-time staging set-up)."""
    probe = torch.from_numpy(np.random.default_rng(0).integers(0, 255, (probe_mb << 20,),
                                                               np.uint8))
    rates = []
    for _ in range(3):
        t0 = time.perf_counter()
        on_dev = probe.to(dev)
        _sync(dev)
        int(on_dev[:8].sum())
        rates.append(probe_mb / (time.perf_counter() - t0))
        del on_dev
    return max(rates)


def main(argv=None, *, data=None, t_start: float = _T_PROCESS_START) -> dict:
    """Run the breakdown and return its result.  ``data``: a
    :func:`~mgnns_tpu_torch.tools._bench_util.flagship_data` (default: made
    here, inside ``setup_seconds``).  ``t_start``: the clock of
    ``time_to_first_result_seconds`` (default: this module's import)."""
    from mgnns_tpu_torch.kernels import build

    dev = U.tool_device(argv, __doc__.split("\n\n")[0])
    cold = os.environ.get("MGNNS_COLD") == "1"
    if not cold:
        return _breakdown(dev, data, t_start, cold)
    warm_dir = build.BUILD_DIR
    build.BUILD_DIR = tempfile.mkdtemp(prefix="mgnns_cold_build_")
    try:
        return _breakdown(dev, data, t_start, cold)
    finally:
        shutil.rmtree(build.BUILD_DIR, ignore_errors=True)
        build.BUILD_DIR = warm_dir


def _breakdown(dev: torch.device, data, t_start: float, cold: bool) -> dict:
    from mgnns_tpu_torch.kernels import edge_max

    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(dev)
    B = int(os.environ.get("WB_BATCH", "128"))
    n_records = int(os.environ.get("WB_SAMPLES", "0")) or None
    pipelined = os.environ.get("WB_PIPELINED") == "1"

    t0 = time.perf_counter()
    if data is None:
        data = U.flagship_data(n_records=n_records)
    live = U.live_eval(data, bn_mode="batch", device=dev)
    _sync(dev)
    setup_s = time.perf_counter() - t0
    ds, eng, loader = data.ds, live.engine, live.loader(B)
    N = len(ds)
    out: dict = {"device": U.device_info(dev), "data": data.name,
                 "cache_mode": "cold" if cold else "warm", "n_samples": N, "batch": B,
                 "setup_seconds": setup_s}

    if pipelined:
        # the loader's own path: synthesis of chunk k+1 beside chunk k's copy
        t0 = time.perf_counter()
        table, _ = loader._ensure_image_table()
        _sync(dev)
        int(table[N - 1, :8].sum())
        build_s = time.perf_counter() - t0
        mb = table.numel() * table.element_size() / (1 << 20)
        out.update(table_build_seconds=build_s, table_build_mb_per_s=mb / build_s)
    else:
        t0 = time.perf_counter()
        with ThreadPoolExecutor(8) as pool:
            arr = np.stack(list(pool.map(ds.load_image, range(N))))
        decode_s = time.perf_counter() - t0
        row_shape = arr.shape[1:]
        arr2d = arr.reshape(N, -1)
        mb = arr2d.nbytes / (1 << 20)
        t0 = time.perf_counter()
        table = torch.from_numpy(arr2d).to(dev)
        _sync(dev)
        int(table[0, :8].sum())
        upload_s = time.perf_counter() - t0
        del arr, arr2d
        loader._tables()[loader._table_key("image")] = (table, row_shape)  # the loader's copy
        out.update(decode_seconds=decode_s, upload_seconds=upload_s,
                   upload_mb_per_s=mb / upload_s)
    out["upload_mb"] = mb

    t0 = time.perf_counter()
    loader._ensure_text_tables()
    _sync(dev)
    out["text_table_upload_seconds"] = time.perf_counter() - t0

    # eval epochs with the tables resident: the capture, then the steady epoch
    edge_max.launches = 0
    t0 = time.perf_counter()
    ev0 = eng.eval_epoch(loader)
    out["first_epoch_seconds"] = time.perf_counter() - t0
    out["time_to_first_result_seconds"] = time.time() - t_start
    out["capture_seconds"] = ev0.get("capture_seconds", 0.0)
    ev = eng.eval_epoch(loader)
    out.update(epoch_seconds=ev["epoch_seconds"], samples_per_sec=ev["samples_per_sec"],
               fused=bool(ev.get("fused")))
    # last, so that its 768 MB of copies cannot delay the first result
    out["h2d_probe_mb_per_s"] = h2d_probe(dev, PROBE_MB)
    if on_card:
        # the wrapper counts K1's eager warm-up and capture calls; replays
        # launch it once each and are not counted
        out["launches"] = {"k1": edge_max.launches}
        out["peak_memory_bytes"] = torch.cuda.max_memory_allocated(dev)
    tag = "pipelined" if pipelined else ("cold" if cold else "warm")
    U.write_result(f"warmup_breakdown_{tag}", out)
    return out


if __name__ == "__main__":
    main()
