"""The eval headline's share of the card's peak at B = 32..512.

The counterpart of the JAX package's ``tools/eval_batch_ladder.py``.  The
program is the fusion model's captured eval step (bf16 trunks, frozen
BatchNorm) replayed over an epoch plan of the split's device tables, one loader per rung.  Each
rung is timed with :func:`~mgnns_tpu_torch.tools._bench_util.timed` (slope
timing over whole epochs, after a first epoch that captures the step), its
``seconds`` are one batch's, and its FLOPs are
:func:`~mgnns_tpu_torch.tools.roofline.forward_flops`' closed form.  Each
rung reports ``seconds``, ``samples_per_sec``, ``tflops`` and
``pct_of_peak`` of :func:`~mgnns_tpu_torch.tools._bench_util.
measured_bf16_peak`, then the best rung; on the CPU no card was measured,
so the last two are null.  A rung that runs out of device memory records
its ``torch.cuda.OutOfMemoryError`` and the ladder goes on.

Settings: ``EVAL_LADDER`` (``32,64,128,256,512``; the split is the largest
rung's records of :func:`~mgnns_tpu_torch.tools._bench_util.flagship_data`),
``MGNNS_DATA``.  Run on a card::

    python -m mgnns_tpu_torch.tools.eval_batch_ladder [--platform cpu]

It prints a line per rung and, last, one JSON line, which it writes to
``results/torch/eval_batch_ladder.json``.
"""

from __future__ import annotations

import gc
import os

import torch

from mgnns_tpu_torch.tools import _bench_util as U
from mgnns_tpu_torch.tools import roofline

ITERS = 10  # epochs timed per rung


def main(argv=None, *, data=None) -> dict:
    """Run the ladder and return its result.  ``data``: a
    :func:`~mgnns_tpu_torch.tools._bench_util.flagship_data` (default: the
    largest rung's records, made here)."""
    from mgnns_tpu_torch.kernels import edge_max

    dev = U.tool_device(argv, __doc__.split("\n\n")[0])
    on_card = dev.type == "cuda"
    peak = U.measured_bf16_peak(device=dev) if on_card else None
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    ladder = [int(b) for b in os.environ.get("EVAL_LADDER", "32,64,128,256,512").split(",")]
    data = data if data is not None else U.flagship_data(n_records=max(ladder))
    live = U.live_eval(data, bn_mode="frozen", unroll_trunks=True, device=dev)
    model, eng, L = live.model, live.engine, data.graph_cfg.max_len
    edge_max.launches = 0
    rungs = []
    for B in ladder:
        loader = live.loader(B)
        try:
            epoch_s = U.timed(eng.eval_epoch, (loader,), ITERS, readback=lambda o: o["loss"])
        except torch.cuda.OutOfMemoryError as e:
            rungs.append({"batch": B, "error": f"{type(e).__name__}: {e}"[:200]})
            eng._graphs.clear()
            gc.collect()
            if on_card:
                torch.cuda.empty_cache()
            print(f"[ladder] B={B}: {rungs[-1]}", flush=True)
            continue
        dt = epoch_s / len(loader)
        tf = roofline.forward_flops(model.cfg, B, L) / dt / 1e12 if on_card else None
        rungs.append({"batch": B, "seconds": dt, "samples_per_sec": B / dt, "tflops": tf,
                      "pct_of_peak": 100 * tf / peak if on_card else None})
        print(f"[ladder] B={B}: {rungs[-1]}", flush=True)

    ok = [r for r in rungs if "seconds" in r]
    out = {"device": U.device_info(dev), "data": data.name, "samples": len(data.ds),
           "peak_bf16_matmul_tflops": peak, "rungs": rungs,
           "best": max(ok, key=lambda r: r["tflops" if on_card else "samples_per_sec"])
           if ok else None}
    if on_card:
        # the wrapper counts K1's eager warm-up and capture calls; replays
        # launch it once each and are not counted
        out["launches"] = {"k1": edge_max.launches}
        out["peak_memory_bytes"] = torch.cuda.max_memory_allocated(dev)
    U.write_result("eval_batch_ladder", out)
    return out


if __name__ == "__main__":
    main()
