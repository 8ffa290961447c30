"""End-to-end benchmark of the port: MGNNS samples/s on one card.

The counterpart of the JAX package's ``bench.py``, with its environment
names and its metric names, so that one reader reads both.  It prints ONE
JSON line: ``{"metric", "value", "unit", "vs_baseline", ...}``.  Run it as
``python bench_torch.py`` from the repository root.

Modes (``MGNNS_BENCH_MODE``):

- ``full`` (default), ``mgnns_eval_samples_per_sec_per_chip``: the fusion
  model's eval over the split.  ``value`` is the live pipeline: the split's
  pixels and text in device tables (``DeviceLoader(device_images=True,
  device_text=True)``) through ``Engine.eval_epoch``, whose eval step is
  captured once and replayed over the epoch plan; its warm-up epoch (table
  upload, capture) is ``warm_start_seconds``.  Diagnostics:
  ``value_device_cached`` (the eager forward over device-cached batches),
  ``value_live_streaming`` (pixels in a table, text streamed per batch) and
  ``value_live_per_batch_upload`` (every batch's pixels copied in);
- ``text``, ``text_channel_eval_samples_per_sec_per_chip``: the text-only
  model's eval over device-cached batches;
- ``train``, ``mgnns_train_samples_per_sec_per_chip``: a second shuffled
  ``Engine.train_epoch`` from device tables (captured steps; the first
  epoch uploads the tables and captures), with ``value_step_microbench``
  (5 ``train_step``s on one batch) beside it.

Settings: ``MGNNS_BENCH_BATCH`` (128 / 64 / 16 by mode), ``_SAMPLES``
(512), ``_BN`` (``frozen`` in train mode, else ``batch``), ``_REMAT``
(``none``), ``_FREEZE_TRUNKS`` (``1`` freezes them), ``_UNROLL`` and
``_STEM_S2D`` (``ModelConfig`` fields with no effect on the maths here),
``MGNNS_BENCH_TRACE=1`` (adds ``"trace"``: one more epoch of the
headline path profiled, its device busy ms, launches, idle share, and K1
and K2 per forward or step), and ``MGNNS_DATA`` (:func:`~mgnns_tpu_torch.
tools._bench_util.flagship_data`; the seeded synthetic corpus by default).  It runs on
``cuda:0`` and raises where there is no card, unless given ``--platform
cpu`` or ``MGNNS_BENCH_PLATFORM=cpu``.

Beside the JAX bench's keys each line carries ``device`` (the card's name and
power limit), ``data``, ``flops_per_sample`` (the closed-form count of
:mod:`mgnns_tpu_torch.tools.roofline`), ``peak_tflops`` (the card's
measured bf16 peak, once per process) and ``mfu`` (``flops_per_sample *
value / peak``); on the CPU the last two are null, since no card was
measured.  ``vs_baseline`` divides the full mode's ``value`` by
``bench_baseline.json``'s ``reference_cpu_samples_per_sec``, a torch-CPU
number of the reference's two trunks.
"""

from __future__ import annotations

import time

_T_PROCESS_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from mgnns_tpu_torch.kernels import edge_max  # noqa: E402
from mgnns_tpu_torch.tools import _bench_util as U  # noqa: E402
from mgnns_tpu_torch.tools import roofline  # noqa: E402
from mgnns_tpu_torch.utils import resolve_device, tree_leaves  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
METRICS = {"full": "mgnns_eval_samples_per_sec_per_chip",
           "text": "text_channel_eval_samples_per_sec_per_chip",
           "train": "mgnns_train_samples_per_sec_per_chip"}
BATCH = {"full": 128, "text": 64, "train": 16}
EVAL_KEYS = ("ids", "lens", "mask", "eids", "image")
# kernel-name fragments of K1 and K2 in the profiler's device events
K1_KERNEL, K2_KERNEL = "edge_max_fwd_kernel", "edge_max_bwd_kernel"


def settings(env=os.environ) -> dict:
    """The run's settings from the environment (``bench.py``'s names)."""
    mode = env.get("MGNNS_BENCH_MODE", "full")
    if mode not in METRICS:
        raise ValueError(f"MGNNS_BENCH_MODE={mode!r}: one of {sorted(METRICS)}")
    return {"mode": mode,
            "batch_size": int(env.get("MGNNS_BENCH_BATCH", BATCH[mode])),
            "n_samples": int(env.get("MGNNS_BENCH_SAMPLES", "512")),
            "platform": env.get("MGNNS_BENCH_PLATFORM", "cuda"),
            "trace": env.get("MGNNS_BENCH_TRACE") == "1",
            "model": {"bn_mode": env.get("MGNNS_BENCH_BN", "frozen" if mode == "train"
                                         else "batch"),
                      "remat_policy": env.get("MGNNS_BENCH_REMAT", "none"),
                      "freeze_trunks": env.get("MGNNS_BENCH_FREEZE_TRUNKS") == "1",
                      "unroll_trunks": (mode == "train"
                                        and env.get("MGNNS_BENCH_UNROLL", "1") == "1"),
                      "stem_s2d": env.get("MGNNS_BENCH_STEM_S2D", "0") == "1"}}


def eval_logits(model, batch: dict) -> torch.Tensor:
    """The fusion model's eval logits: the program of the eval diagnostics."""
    with torch.inference_mode():
        return model.apply_fn(model.params, model.bstats, {k: batch[k] for k in EVAL_KEYS},
                              train=False, generator=None)[0]


def text_logits(params: dict, batch: dict, ngram: int) -> torch.Tensor:
    """The text-only model's eval logits: the text mode's program."""
    from mgnns_tpu_torch.models.text_only import text_model_apply

    with torch.inference_mode():
        return text_model_apply(params, {k: batch[k] for k in ("ids", "lens", "eids")},
                                ngram=ngram)


def _epoch(loader, forward) -> tuple[int, np.ndarray, float]:
    """(samples, the valid rows' predictions, seconds) of one eval pass,
    ended by a real readback of the predictions."""
    t0 = time.perf_counter()
    n, preds = 0, []
    for batch in loader:
        p = forward(batch).argmax(-1)
        keep = torch.from_numpy(np.asarray(batch["weight"]) > 0)
        preds.append(p[keep.to(p.device)])
        n += int(keep.sum())
    host = torch.cat(preds).cpu().numpy()
    return n, host, time.perf_counter() - t0


def _baseline() -> float | None:
    path = os.path.join(ROOT, "bench_baseline.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)["reference_cpu_samples_per_sec"]


def run(mode: str = "full", *, platform: str = "cuda", batch_size: int | None = None,
        n_samples: int = 512, data=None, model_overrides: dict | None = None,
        peak_tflops: float | None = None, trace: bool = False,
        t_start: float = _T_PROCESS_START) -> dict:
    """Run one mode, print its JSON line and return it.

    ``data``: a :func:`~mgnns_tpu_torch.tools._bench_util.flagship_data`
    (default: made here, ``n_samples`` records).  ``model_overrides``: ``ModelConfig``
    fields over the flagship model's (the fusion modes; default the mode's
    settings with no environment).  ``peak_tflops``: the
    card's measured bf16 peak, measured here when not given.  ``trace``: also
    profile one more epoch of the headline path and add its device events
    (busy ms, launches, K1 and K2 per forward or step) under ``"trace"``.
    ``t_start``: the clock of ``time_to_first_result_seconds``."""
    dev = resolve_device("cuda:0" if platform == "cuda" else platform)
    B = batch_size or BATCH[mode]
    on_card = dev.type == "cuda"
    if on_card:
        if peak_tflops is None:
            peak_tflops = U.measured_bf16_peak(device=dev)
        torch.cuda.init()  # the peak statistics exist once CUDA is set up
        torch.cuda.reset_peak_memory_stats(dev)
    elif trace:
        raise ValueError("trace reads the card's kernel events: it needs platform='cuda'")
    else:
        peak_tflops = None  # no card was measured
    if data is None:
        data = U.flagship_data(n_records=n_samples)
    edge_max.launches = edge_max.bwd_launches = 0
    out = {"metric": METRICS[mode], "unit": "samples/s"}
    run_mode = {"full": _full, "text": _text, "train": _train}[mode]
    if model_overrides is None:
        model_overrides = settings({"MGNNS_BENCH_MODE": mode})["model"]
    flops, extra, counts = run_mode(data, B, dev, model_overrides, t_start, trace)
    value = extra.pop("value")
    out["value"] = round(value, 2)
    out["vs_baseline"] = None
    if mode == "full":
        base = _baseline()
        out["vs_baseline"] = round(value / base, 2) if base else None
    out.update(extra)
    out.update(device=U.device_info(dev), data=data.name, batch_size=B,
               samples=len(data.ds), flops_per_sample=flops / B, peak_tflops=peak_tflops,
               mfu=None if peak_tflops is None else flops / B * value / (peak_tflops * 1e12))
    if on_card:
        out["launches"] = {"k1": edge_max.launches, "k2": edge_max.bwd_launches, **counts}
        out["peak_memory_bytes"] = torch.cuda.max_memory_allocated(dev)
    print(json.dumps(out), flush=True)
    return out


def _traced(run_fn, per: int) -> dict:
    """The profiled epoch's device busy ms, its own wall ms (profiler on),
    the device's idle share of that wall, launches, and K1 and K2 per
    forward or step."""
    ev = U.device_events(run_fn, {"k1": K1_KERNEL, "k2": K2_KERNEL})
    return {"busy_ms": ev["busy_ms"], "wall_ms": ev["wall_ms"],
            "idle_share": 1 - ev["busy_ms"] / ev["wall_ms"], "launches": ev["launches"],
            "per": per, "k1_per": ev["k1"] / per, "k2_per": ev["k2"] / per}


def _text(data, B, dev, model_kw, t_start, trace):
    from mgnns_tpu_torch.data.loader import DeviceLoader
    from mgnns_tpu_torch.models.text_only import text_model_init

    ds = data.ds
    params = text_model_init(len(data.vocab), ds.num_classes, data.graph.num_edges, seed=0,
                             device=dev)
    loader = DeviceLoader(ds, B, shuffle=False, with_images=False, cache_device_batches=True,
                          device=dev)
    forward = lambda b: text_logits(params, b, data.graph_cfg.ngram)  # noqa: E731
    _epoch(loader, forward)  # warm-up: encode, upload, library handles
    before = edge_max.launches
    n, _, dt = _epoch(loader, forward)
    extra = {"value": n / dt,
             "notes": ("flops_per_sample and mfu count the head's product alone: the text "
                       "GCN's windowed max (K1) and readout are no products, so mfu cannot "
                       "move with the text channel's time; read value and the trace's "
                       "idle_share")}
    counts = {"timed_forwards": len(loader), "k1_timed": edge_max.launches - before}
    if trace:
        extra["trace"] = _traced(lambda: _epoch(loader, forward), len(loader))
    return roofline.text_forward_flops(ds.num_classes, B), extra, counts


def _full(data, B, dev, model_kw, t_start, trace):
    from mgnns_tpu_torch.data.loader import DeviceLoader

    ds = data.ds
    live = U.live_eval(data, device=dev, **model_kw)
    model, eng = live.model, live.engine
    forward = lambda b: eval_logits(model, b)  # noqa: E731

    # diagnostic: the eager forward over device-cached batches (the ceiling)
    cached = DeviceLoader(ds, B, shuffle=False, num_threads=8, cache_device_batches=True,
                          device=dev)
    _epoch(cached, forward)  # warm-up: decode, upload, library handles
    before = edge_max.launches
    n, preds_cached, dt = _epoch(cached, forward)
    sps_cached = n / dt
    counts = {"timed_forwards": len(cached), "k1_timed": edge_max.launches - before}

    # the headline: tables and the captured eval step replayed over the plan
    live_loader = live.loader(B)
    t0 = time.perf_counter()
    eng.eval_epoch(live_loader)  # warm-up: table upload, capture
    warm_s = time.perf_counter() - t0
    t_first = time.time() - t_start
    live = eng.eval_epoch(live_loader, collect_preds=True)

    # diagnostics: pixels in a table with text streamed per batch, then every
    # batch's pixels copied in
    stream = DeviceLoader(ds, B, shuffle=False, num_threads=8, device_images=True, device=dev)
    _epoch(stream, forward)  # warm-up
    n_s, _, dt_s = _epoch(stream, forward)
    upload = DeviceLoader(ds, B, shuffle=False, num_threads=8, device=dev)
    n_u, _, dt_u = _epoch(upload, forward)
    extra = {
        "value": live["samples_per_sec"],
        "live_pipeline_fused": bool(live.get("fused")),
        "value_device_cached": round(sps_cached, 2),
        "value_live_streaming": round(n_s / dt_s, 2),
        "value_live_per_batch_upload": round(n_u / dt_u, 2),
        "warm_start_seconds": round(warm_s, 1),
        "time_to_first_result_seconds": round(t_first, 1),
        # the captured eval step against the eager forward, sample for sample
        "live_preds_differ_from_cached": int((live["preds"] != preds_cached).sum()),
        "notes": ("time_to_first_result_seconds counts from process start: the bf16 peak's "
                  "measurement, the kernels' build at first use, data and model set-up, the "
                  "eager diagnostic's epochs, the table upload and the eval step's capture "
                  "fall inside it"),
        "config": {**{k: getattr(model.cfg, k) for k in ("bn_mode", "remat_policy",
                                                         "freeze_trunks", "compute_dtype")},
                   "batch_size": B}}
    if trace:
        extra["trace"] = _traced(lambda: eng.eval_epoch(live_loader), len(live_loader))
    return roofline.forward_flops(model.cfg, B, data.graph_cfg.max_len), extra, counts


def _train(data, B, dev, model_kw, t_start, trace):
    from mgnns_tpu_torch.data.loader import DeviceLoader
    from mgnns_tpu_torch.engine.metrics import confusion_init
    from mgnns_tpu_torch.engine.train import Engine

    ds = data.ds
    model = U.flagship_model(data, device=dev, **model_kw)
    cfg = model.cfg
    eng = Engine(model.apply_fn, model.params, model.bstats, num_classes=ds.num_classes,
                 steps_per_epoch=1, freeze_trunks=cfg.freeze_trunks, device=dev)
    loader = DeviceLoader(ds, B, shuffle=True, num_threads=8, device_images=True,
                          device_text=True, device=dev)
    eng.train_epoch(loader)  # warm-up: table upload, capture
    out = eng.train_epoch(loader)

    # diagnostic: 5 eager steps on one batch
    it = iter(DeviceLoader(ds, B, shuffle=False, num_threads=8, device=dev))
    batch = next(it)
    it.close()
    readback = lambda: float(tree_leaves(eng.params)[0].sum())  # noqa: E731
    eng.train_step(batch, confusion_init(ds.num_classes, dev))
    readback()
    before = (edge_max.launches, edge_max.bwd_launches)
    t0 = time.perf_counter()
    steps = 5
    for _ in range(steps):
        eng.train_step(batch, confusion_init(ds.num_classes, dev))
    readback()
    sps_step = B * steps / (time.perf_counter() - t0)
    extra = {"value": out["samples_per_sec"], "epoch_fused": bool(out.get("fused")),
             "value_step_microbench": round(sps_step, 2),
             "config": {**{k: getattr(cfg, k) for k in ("bn_mode", "unroll_trunks",
                                                        "freeze_trunks", "remat_policy",
                                                        "compute_dtype")},
                        "batch_size": B}}
    counts = {"timed_steps": steps, "k1_timed": edge_max.launches - before[0],
              "k2_timed": edge_max.bwd_launches - before[1]}
    if trace:
        extra["trace"] = _traced(lambda: eng.train_epoch(loader), len(loader))
    return roofline.train_step_flops(cfg, B, data.graph_cfg.max_len), extra, counts


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="MGNNS benchmark of the PyTorch/CUDA port")
    p.add_argument("--platform", choices=["cuda", "cpu"], default=None,
                   help="default MGNNS_BENCH_PLATFORM, else cuda (raises without a card)")
    args = p.parse_args(argv)
    s = settings()
    run(s["mode"], platform=args.platform or s["platform"], batch_size=s["batch_size"],
        n_samples=s["n_samples"], model_overrides=s["model"], trace=s["trace"])
    return 0
