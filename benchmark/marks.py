"""Shared reading of the program's stage marks and spans, for the
per-stage metrics' readers (``metrics/<stage>_ms.*``, ``image_mfu.*``,
``epoch_edge_ms.*``, ``capture_s.*``).

The program's tracing (``mgnns_tpu_torch/tracing.py``) launches a mark
kernel ``mgnns_mark_<id>`` at the begin and at the end of each stage of a
captured step, and ``<stage>.bwd`` where the backward reaches a stage's
output; its spans are profiler ranges on the host (``engine.epoch``,
``graphs.replay``, ``graphs.readback``) and entries of a ring in the
process, which holds the unprofiled window's epochs and the set-up's
``graphs.capture`` too.  A program without that module, or a trace
without marks, gives None.

A stage's device time is read from the profiler's device timeline, idle
gaps included: from its begin mark's start to its end mark's end, and from
its ``.bwd`` mark's start to the next mark's start (the backward of a stage
runs from the gradient reaching its output up to the next stage's).
"""

from __future__ import annotations

from benchmark import flops as F

TEXT_GCN, LSTM, FUSION = ("mgnns.text_gcn",), ("mgnns.lstm",), ("mgnns.fusion",)
IMAGE = ("mgnns.object_channel", "mgnns.place_channel")
OPTIMIZER = ("engine.optimizer",)
STEP = "engine.forward"  # the stage every captured step opens with


def _tracing():
    try:
        from mgnns_tpu_torch import tracing
    except ImportError:
        return None
    return tracing


def marks(trace) -> list[tuple[str, float, float]]:
    """(mark, start_us, end_us) of the trace's mark kernels, in device order."""
    tracing = _tracing()
    if trace is None or tracing is None:
        return []
    found = [(tracing.mark_of(name), s, e) for name, s, e in trace.device
             if name.startswith("mgnns_mark_")]
    return sorted((m for m in found if m[0] is not None), key=lambda m: m[1])


def stage_ms(ctx: dict, stages: tuple[str, ...]) -> float | None:
    """Device milliseconds per traced step of ``stages`` together, forward
    and backward."""
    found = marks(ctx["trace"])
    steps = sum(1 for m, _, _ in found if m == f"{STEP}.begin")
    if not steps:
        return None
    total_us, seen, open_ = 0.0, False, {}
    for i, (mark, s, e) in enumerate(found):
        stage, edge = mark.rsplit(".", 1)
        if stage not in stages:
            continue
        if edge == "begin":
            open_[stage] = s
        elif edge == "end" and stage in open_:
            total_us += e - open_.pop(stage)
            seen = True
        elif edge == "bwd" and i + 1 < len(found):
            total_us += found[i + 1][1] - s
            seen = True
    return total_us / 1e3 / steps if seen else None


def image_mfu(ctx: dict, grads: bool) -> float | None:
    """100 x the closed-form FLOPs of both trunks' convolutions for a step
    (forward, and backward with ``grads``) over the image stage's device
    seconds per step x the published peak of the cell's precision."""
    ms = stage_ms(ctx, IMAGE)
    B = ctx["counters"].get("batch")
    if not ms or not B:
        return None
    cfg = ctx["config"]
    flops = sum(sum(F.trunk_flops(depth, cfg["image_size"], B, grads))
                for depth in cfg["trunks"].values())
    return 100.0 * flops / (ms / 1e3 * F.PEAK_FLOPS[ctx["params"]["compute_dtype"]])


def _window_epochs(window_s: float | None) -> tuple[list, list]:
    """The ring's ``engine.epoch`` spans and those of the window, which ran
    last, back to back, and began ``window_s`` before the last one ended."""
    tracing = _tracing()
    if tracing is None or not window_s:
        return [], []
    epochs = tracing.spans("engine.epoch")
    if not epochs:
        return [], []
    start_ns = max(s.end_ns for s in epochs) - window_s * 1e9
    return epochs, [s for s in epochs if s.end_ns > start_ns]


def host_edge_ms(ctx: dict) -> float | None:
    """Host milliseconds per window epoch from ``engine.epoch``'s start to
    its first ``graphs.replay`` (the plan and its load), from the ring: the
    window's epochs run unprofiled."""
    tracing = _tracing()
    _, window = _window_epochs(ctx["counters"].get("window_s"))
    if not window:
        return None
    replays = tracing.spans("graphs.replay")
    edges = []
    for ep in window:
        first = min((r.start_ns for r in replays if r.thread == ep.thread
                     and ep.start_ns <= r.start_ns <= ep.end_ns), default=None)
        if first is not None:
            edges.append(first - ep.start_ns)
    return sum(edges) / len(edges) / 1e6 if edges else None


def device_edge_ms(trace) -> float | None:
    """Device-idle milliseconds per traced epoch around its replays: from
    the first replay's launch to the first device event after it, plus
    from the replays' last kernel to the end of ``graphs.readback`` (host
    spans and device events on the profiler's clock)."""
    if trace is None:
        return None
    host = {name: sorted((s, e) for n, s, e in trace.host if n == name)
            for name in ("engine.epoch", "graphs.replay", "graphs.readback")}
    device = sorted((s, e, name) for name, s, e in trace.device)
    edges = []
    for e0, e1 in host["engine.epoch"]:
        replays = [r for r in host["graphs.replay"] if e0 <= r[0] and r[1] <= e1]
        readback = [r for r in host["graphs.readback"] if e0 <= r[0] and r[1] <= e1]
        if not replays or not readback:
            continue
        first = next((s for s, _, _ in device if s >= replays[0][0]), None)
        last = max((e for s, e, name in device
                    if s >= replays[0][0] and e <= readback[-1][1] and "Memcpy" not in name),
                   default=None)
        if first is None or last is None:
            continue
        edges.append((first - replays[0][0]) + (readback[-1][1] - last))
    return sum(edges) / len(edges) / 1e3 if edges else None


def epoch_edge_ms(ctx: dict) -> float | None:
    """Device-idle milliseconds per epoch inside ``engine.epoch`` and
    outside its replays: the host's plan and load before the first replay,
    read from the window's unprofiled epochs (:func:`host_edge_ms`; the
    profiler slows that host work several times), plus the device's wait
    for the first replay and its tail after the last, read from the traced
    epoch (:func:`device_edge_ms`)."""
    host, device = host_edge_ms(ctx), device_edge_ms(ctx["trace"])
    return None if host is None or device is None else host + device


def capture_s(ctx: dict) -> float | None:
    """Seconds of the run's ``graphs.capture`` spans that ended before the
    window, leaving out the capture of a traced run's short split (a plan
    of ``trace_batches`` steps), which an unprofiled set-up never makes."""
    tracing = _tracing()
    epochs, window = _window_epochs(ctx["counters"].get("window_s"))
    if not window:
        return None
    start_ns = min(s.start_ns for s in window)
    traced = ctx["params"].get("trace_batches")
    before = [s.end_ns - s.start_ns for s in tracing.spans("graphs.capture")
              if s.end_ns <= start_ns and s.attrs.get("shape", (None,))[0] != traced]
    return sum(before) / 1e9 if before else None
