"""One eval over a whole split from device tables: the 6 GB pixel-table case.

The counterpart of the JAX package's ``tools/full_split_fused_eval.py``.  It
runs the fusion model's eval (bf16 trunks, ``bn_mode="batch"`` as in the JAX
tool; an eval reads the running statistics either way) over the whole split of
:func:`~mgnns_tpu_torch.tools._bench_util.flagship_data`: by default the
seeded synthetic corpus's 10,000 records at 448 px, whose pixel table is
10,000 x 448*448*3 uint8 = 6.02 GB on the card (the real val split has
10,035 records; that run waits for TumEmo data in the repository).  This is
the scale the benchmark's cells (1,024 and 2,048 records) never reach.

The split's pixels and text live in device tables (``DeviceLoader(
device_images=True, device_text=True)``), and ``Engine(eval_only=True)``
runs each epoch as its captured eval step replayed over the epoch plan, K1
inside.  The first epoch builds the tables and captures the step; the second
is the steady epoch.  ``warmup_seconds_incl_table_upload_and_compile`` keeps
the JAX tool's name: here it counts the table build plus the capture (there
is no compile).

Settings: ``FSE_BATCH`` (128), ``MGNNS_DATA``.  Run on a card::

    python -m mgnns_tpu_torch.tools.full_split_fused_eval [--platform cpu]

It prints one JSON line and writes it to
``results/torch/full_split_fused_eval.json``.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from mgnns_tpu_torch.tools import _bench_util as U


def main(argv=None, *, data=None) -> dict:
    """Run the eval and return its result.  ``data``: a
    :func:`~mgnns_tpu_torch.tools._bench_util.flagship_data` (default: the
    whole split, made here)."""
    from mgnns_tpu_torch.kernels import edge_max

    dev = U.tool_device(argv, __doc__.split("\n\n")[0])
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(dev)
    B = int(os.environ.get("FSE_BATCH", "128"))
    data = data if data is not None else U.flagship_data()
    live = U.live_eval(data, bn_mode="batch", device=dev)
    eng, loader = live.engine, live.loader(B)
    edge_max.launches = 0
    t0 = time.perf_counter()
    ev0 = eng.eval_epoch(loader)  # table build and upload, capture
    warm_s = time.perf_counter() - t0
    ev = eng.eval_epoch(loader)
    table, _ = loader._ensure_image_table()
    out = {
        "device": U.device_info(dev),
        "data": data.name,
        "n_samples": int(np.asarray(ev["confusion"]).sum()),
        "batch": B,
        "fused": bool(ev.get("fused")),
        "samples_per_sec": ev["samples_per_sec"],
        "epoch_seconds": ev["epoch_seconds"],
        "warmup_seconds_incl_table_upload_and_compile": warm_s,
        "first_epoch_fused": bool(ev0.get("fused")),
        "capture_seconds": ev0.get("capture_seconds"),
        "pixel_table_bytes": table.numel() * table.element_size(),
    }
    if on_card:
        # the wrapper counts K1's eager warm-up and capture calls; replays
        # launch it once each and are not counted
        out["launches"] = {"k1": edge_max.launches}
        out["peak_memory_bytes"] = torch.cuda.max_memory_allocated(dev)
    U.write_result("full_split_fused_eval", out)
    return out


if __name__ == "__main__":
    main()
