"""The port's tracing (``mgnns_tpu_torch/tracing.py``) on the CPU: the span
ring, the stage marks a captured step would launch (capturing forced on and
the launcher recorded), and the benchmark's readers of marks and spans on a
synthetic trace.  The marks on the card: ``tests/test_torch_cuda_capture.py``.
"""

from __future__ import annotations

import re
import sys
import threading

import pytest
import torch

from benchmark import flops as F
from benchmark import harness as H
from benchmark.trace import Trace
from mgnns_tpu_torch import tracing
from mgnns_tpu_torch.utils import tree_leaves
from test_torch_cuda import _fusion_plan_engine

CPU = torch.device("cpu")
MODEL = ("mgnns.text_gcn", "mgnns.lstm", "mgnns.object_channel", "mgnns.place_channel",
         "mgnns.fusion")
FORWARD = (["engine.forward.begin"]
           + [f"{s}.{edge}" for s in MODEL for edge in ("begin", "end")]
           + ["engine.forward.end"])
TRAIN_STEP = (FORWARD + ["engine.backward.begin"]
              + [f"{s}.bwd" for s in reversed(MODEL)]
              + ["engine.backward.end", "engine.optimizer.begin", "engine.optimizer.end"])


@pytest.fixture
def ring():
    tracing.reset()
    yield
    tracing.reset()


@pytest.fixture
def launched(monkeypatch):
    """Capturing forced on, and the marks launched recorded by name."""
    seen: list[str] = []
    monkeypatch.setattr(tracing, "_capturing", lambda: True)
    monkeypatch.setattr(tracing, "_launch", seen.append)
    return seen


def test_spans_nest_with_their_parents(ring):
    with tracing.span("outer", k=1):
        with tracing.span("inner"):
            pass
        with tracing.span("other.inner", j=2):
            pass
    inner, other, outer = tracing.spans()
    assert (inner.name, inner.parent, inner.attrs) == ("inner", "outer", {})
    assert (other.parent, other.attrs) == ("outer", {"j": 2})
    assert (outer.name, outer.parent, outer.attrs) == ("outer", None, {"k": 1})
    assert outer.start_ns <= inner.start_ns <= inner.end_ns <= other.start_ns <= outer.end_ns
    assert inner.thread == outer.thread == threading.get_ident()
    assert [s.name for s in tracing.spans("other.")] == ["other.inner"]
    tracing.reset()
    assert tracing.spans() == []


def test_a_span_is_a_profiler_range(ring):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("traced.outer"):
            with tracing.stage("engine.forward"):
                torch.ones(3).sum()
    names = {e.name for e in prof.events()}
    assert {"traced.outer", "engine.forward"} <= names


def test_the_ring_keeps_the_newest_spans(ring):
    for i in range(tracing.RING_SIZE + 10):
        with tracing.span("n", i=i):
            pass
    kept = tracing.spans()
    assert len(kept) == tracing.RING_SIZE
    assert [kept[0].attrs["i"], kept[-1].attrs["i"]] == [10, tracing.RING_SIZE + 9]


def test_spans_from_many_threads(ring):
    """Threads' spans nest on their own threads, and none is lost."""
    threads_n, per = 16, 200
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(t):
            for i in range(per):
                with tracing.span("t.outer", t=t, i=i):
                    with tracing.span("t.inner", t=t, i=i):
                        pass

        threads = [threading.Thread(target=work, args=(t,)) for t in range(threads_n)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(interval)
    got = tracing.spans("t.")
    assert len(got) == 2 * threads_n * per
    assert all(s.parent == ("t.outer" if s.name == "t.inner" else None) for s in got)
    by = {(s.name, s.attrs["t"], s.attrs["i"]): s for s in got}
    assert len(by) == len(got)
    for t in range(threads_n):
        for i in range(per):
            outer, inner = by["t.outer", t, i], by["t.inner", t, i]
            assert outer.thread == inner.thread
            assert outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns


def test_tags_and_the_decorator(ring):
    @tracing.span("deco", kind="call")
    def nest(n):
        if n:
            nest(n - 1)

    with tracing.tags(chunk=3):
        nest(1)
        with tracing.tags(chunk=4, extra=True):
            with tracing.span("tagged", own=1):
                pass
        with tracing.span("back"):
            pass
    with tracing.span("untagged"):
        pass
    inner, outer, tagged, back, untagged = tracing.spans()
    assert (inner.parent, outer.parent) == ("deco", None)
    assert inner.attrs == outer.attrs == {"chunk": 3, "kind": "call"}
    assert tagged.attrs == {"chunk": 4, "extra": True, "own": 1}
    assert back.attrs == {"chunk": 3} and untagged.attrs == {}


def test_marks_of_a_captured_train_and_eval_step(ring, launched):
    """The marks a captured step launches, in order: each model stage
    inside the engine's forward, the stages' ``.bwd`` marks in the
    backward, latest stage first, then the optimizer; the eval step's
    forward alone.  Ranges: the plan's load, each step's stages, the
    readback, inside one ``engine.epoch``."""
    eng, loader, _ = _fusion_plan_engine(CPU, 0.0, nb=2)
    eng.train_epoch(loader)
    assert launched == TRAIN_STEP * 2
    launched.clear()
    eng.eval_epoch(loader)
    assert launched == FORWARD * 2
    epochs = tracing.spans("engine.epoch")
    assert [s.attrs for s in epochs] == [{"train": True}, {"train": False}]
    names = [(s.name, s.parent) for s in tracing.spans()]
    assert names.count(("graphs.plan_load", "engine.epoch")) == 2
    assert names.count(("graphs.readback", "engine.epoch")) == 2
    assert names.count(("mgnns.lstm", "engine.forward")) == 4


def test_eager_steps_launch_no_marks(ring, monkeypatch):
    """Not capturing (the CPU, the loop path, serving): no mark, and no
    grad-mark node in the autograd graph."""
    seen = []
    monkeypatch.setattr(tracing, "_launch", seen.append)
    eng, loader, batches = _fusion_plan_engine(CPU, 0.0, nb=1)
    eng.train_epoch(loader)
    x = torch.ones(2, requires_grad=True)
    assert tracing.grad_mark(x, "mgnns.fusion") is x
    assert seen == [] and tracing.spans("mgnns.fusion")


def _train(marks: bool, monkeypatch):
    """(loss and gradients of the first batch, step losses, parameters after
    the epoch) of the small fusion model with dropout, marks forced on or
    off."""
    monkeypatch.setattr(tracing, "_capturing", lambda: marks)
    monkeypatch.setattr(tracing, "_launch", lambda name: None)
    eng, loader, batches = _fusion_plan_engine(CPU, 0.3, nb=2)
    loss, grads, _, _ = eng._loss_and_grads(eng._to_device(batches[0]))
    out = eng.train_epoch(loader)
    return [loss] + [g for g in grads if g is not None], out["step_losses"], \
        tree_leaves(eng.params) + tree_leaves(eng.batch_stats)


def test_marks_change_no_number(monkeypatch):
    """Loss, gradients, step losses and updated parameters bit-equal with
    marks forced on and off: the grad mark passes the gradient through."""
    on = _train(True, monkeypatch)
    off = _train(False, monkeypatch)
    assert len(on[0]) == len(off[0]) > 20
    assert all(torch.equal(a, b) for a, b in zip(on[0], off[0]))
    assert on[1] == off[1]
    assert all(torch.equal(a, b) for a, b in zip(on[2], off[2]))


def test_grad_mark_passes_tuples_and_missing_gradients(launched):
    a = torch.randn(3, requires_grad=True)
    b = torch.randn(2, requires_grad=True)
    ma, mb = tracing.grad_mark((a, b), "mgnns.object_channel")
    (ma * 3).sum().backward()  # no gradient reaches mb
    assert torch.equal(a.grad, torch.full((3,), 3.0)) and b.grad is None
    assert launched == ["mgnns.object_channel.bwd"]


def test_mark_kernels_are_named_by_id():
    """Every mark has a kernel ``mgnns_mark_<id>`` in ``csrc/mark.cu``,
    whose name holds neither of K1's and K2's names' fragments."""
    import os

    from mgnns_tpu_torch.kernels import build

    with open(os.path.join(build.CSRC_DIR, "mark.cu")) as f:
        src = f.read()
    ids = [int(i) for i in re.findall(r"X\((\d+)\)", src.split("#define MGNNS_MARK_KERNEL")[0])]
    assert ids == list(range(len(ids))) and len(ids) >= len(tracing.MARKS)
    assert "mark" in build.SOURCES
    for i, name in enumerate(tracing.MARKS):
        kernel = f"mgnns_mark_{i}"
        assert tracing.mark_of(kernel) == name
        assert "edge_max" not in kernel
    assert tracing.mark_of("void edge_max_fwd_kernel<4, true>(float const*)") is None
    assert tracing.mark_of(f"mgnns_mark_{len(tracing.MARKS)}") is None
    assert set(tracing.GRAD_MARKED) <= set(tracing.STAGES)


# ------------------------------------------------------------------ readers

def _kernel(mark: str) -> str:
    return f"mgnns_mark_{tracing.MARKS.index(mark)}"


def _synthetic_train_trace():
    """Two train steps on a device timeline (us): each stage's marks 1 us
    long around its work, the backward's ``.bwd`` marks, a gather before
    the forward and a copy after; host spans of the epoch around them."""
    device, host = [], []
    t = 1000.0
    widths = {"mgnns.text_gcn": 10, "mgnns.lstm": 20, "mgnns.object_channel": 30,
              "mgnns.place_channel": 40, "mgnns.fusion": 50}
    bwd = {"mgnns.fusion": 5, "mgnns.place_channel": 6, "mgnns.object_channel": 7,
           "mgnns.lstm": 8, "mgnns.text_gcn": 9}
    for step in range(2):
        host.append(("graphs.replay", 500.0 + step * 10, 505.0 + step * 10))
        device.append(("index_select", t, t + 4))  # the step's gather
        t += 5
        for mark in TRAIN_STEP:
            device.append((_kernel(mark), t, t + 1))
            t += 1
            stage, edge = mark.rsplit(".", 1)
            if edge == "begin" and stage in widths:
                device.append(("conv", t, t + widths[stage] - 2))
                t += widths[stage] - 2
            elif edge == "bwd":
                device.append(("conv_bwd", t, t + bwd[stage] - 1))
                t += bwd[stage] - 1
            elif mark == "engine.optimizer.begin":
                device.append(("adam", t, t + 98))
                t += 98
        device.append(("add", t, t + 2))
        t += 3
    device.append(("Memcpy DtoH (Device -> Pageable)", t + 10, t + 12))
    host.append(("graphs.readback", t - 100, t + 20))
    host.append(("engine.epoch", 300.0, t + 30))
    return Trace(device=device, host=host, window_s=0.01), widths, bwd, t


def _ctx(trace, cell="train-b16"):
    config = H.config_of("mgnns-tumemo.train-b16")
    params = H.load_json("workloads", f"mgnns-tumemo.{cell}")
    return {"config": config, "params": params, "trace": trace,
            "counters": {"batch": params["batch"], "window_s": 2.0}}


def _read(name: str, ctx: dict):
    return H.load_code("metrics", name).read(ctx)


def test_stage_readers_on_a_synthetic_trace():
    trace, widths, bwd, _ = _synthetic_train_trace()
    ctx = _ctx(trace, "train-b16")
    # a stage: its begin mark's start to its end mark's end, and its .bwd
    # mark's start to the next mark's start; per step
    assert _read("text_gcn_ms.train", ctx) == pytest.approx((10 + 9) / 1e3)
    assert _read("lstm_ms.train", ctx) == pytest.approx((20 + 8) / 1e3)
    assert _read("image_ms.train", ctx) == pytest.approx((30 + 40 + 7 + 6) / 1e3)
    assert _read("fusion_ms.train", ctx) == pytest.approx((50 + 5) / 1e3)
    assert _read("optimizer_ms.train", ctx) == pytest.approx(100 / 1e3)
    cfg = ctx["config"]
    flops = sum(sum(F.trunk_flops(d, cfg["image_size"], 16, True))
                for d in cfg["trunks"].values())
    assert _read("image_mfu.train", ctx) == pytest.approx(
        100 * flops / (83e-6 * F.PEAK_FLOPS["bfloat16"]))
    ectx = _ctx(trace, "eval-b128")
    assert _read("image_ms.eval", ectx) == pytest.approx((30 + 40 + 7 + 6) / 1e3)
    eflops = sum(F.trunk_flops(d, cfg["image_size"], 128, False)[0]
                 for d in cfg["trunks"].values())
    ectx["counters"]["batch"] = 128
    assert _read("image_mfu.eval", ectx) == pytest.approx(
        100 * eflops / (83e-6 * F.PEAK_FLOPS["bfloat16"]))


def _fake_ring(monkeypatch, fake):
    monkeypatch.setattr(tracing, "spans",
                        lambda prefix="": [x for x in fake if x.name.startswith(prefix)])


def test_epoch_edge_reader_on_a_synthetic_trace(monkeypatch):
    """The host's plan and load from the window's epochs in the ring (3 and
    5 ms to their first replay on their own thread; the set-up epoch before
    the window left out), plus the traced epoch's device edges: from its
    first replay's launch (500) to the first kernel (1000), and from the
    last kernel (t - 1) to the readback's end (t + 20); the copy after the
    replays is no kernel of theirs."""
    trace, _, _, t = _synthetic_train_trace()
    S, s, ms = tracing.Span, 10 ** 9, 10 ** 6
    _fake_ring(monkeypatch, [
        S("graphs.replay", None, s // 2, s // 2 + 1, 1, {}),
        S("engine.epoch", None, 0, s, 1, {"train": True}),
        S("graphs.replay", None, 8 * s + 3 * ms, 8 * s + 3 * ms + 1, 1, {}),
        S("graphs.replay", None, 8 * s + 4 * ms, 8 * s + 4 * ms + 1, 1, {}),
        S("engine.epoch", None, 8 * s, 9 * s, 1, {"train": True}),
        S("graphs.replay", None, 9 * s + 1 * ms, 9 * s + 1 * ms + 1, 2, {}),
        S("graphs.replay", None, 9 * s + 5 * ms, 9 * s + 5 * ms + 1, 1, {}),
        S("engine.epoch", None, 9 * s, 10 * s, 1, {"train": True})])
    want = 4.0 + ((1000 - 500) + (t + 20 - (t - 1))) / 1e3
    assert _read("epoch_edge_ms.train", _ctx(trace)) == pytest.approx(want)
    assert _read("epoch_edge_ms.eval", _ctx(trace)) == pytest.approx(want)
    _fake_ring(monkeypatch, [])  # no window epochs in the ring
    assert _read("epoch_edge_ms.train", _ctx(trace)) is None


def test_capture_reader_on_a_span_list(monkeypatch):
    """Captures that ended before the window, which began ``window_s``
    before the last epoch ended; one after it is left out, and so is the
    capture of a traced run's short split (``trace_batches`` steps)."""
    S = tracing.Span
    s = 10 ** 9
    fake = [S("graphs.capture", None, 0, 3 * s, 1, {"train": True, "shape": (64, 16)}),
            S("engine.epoch", None, 1 * s, 4 * s, 1, {"train": True}),
            S("graphs.capture", None, 4 * s, 5 * s // 2 + 3 * s, 1, {"train": True}),
            S("graphs.capture", None, 6 * s, 7 * s, 1, {"train": True, "shape": (4, 16)}),
            S("engine.epoch", None, 8 * s, 9 * s, 1, {"train": True}),
            S("engine.epoch", None, 9 * s, 10 * s, 1, {"train": True}),
            S("graphs.capture", None, 10 * s, 11 * s, 1, {"train": False})]
    _fake_ring(monkeypatch, fake)
    ctx = _ctx(None)
    assert ctx["params"]["trace_batches"] == 4
    assert _read("capture_s.train", ctx) == pytest.approx(4.5)  # the window began at 8 s
    eval_ctx = _ctx(None, "eval-b128")  # a split of 2 steps is traced there
    assert _read("capture_s.eval", eval_ctx) == pytest.approx(5.5)
    ctx["counters"]["window_s"] = 7.5  # began at 2.5 s: no capture ended before
    assert _read("capture_s.train", ctx) is None


@pytest.mark.parametrize("name", ["text_gcn_ms.train", "lstm_ms.train", "image_ms.train",
                                  "fusion_ms.train", "optimizer_ms.train", "image_mfu.train",
                                  "epoch_edge_ms.train", "text_gcn_ms.eval", "lstm_ms.eval",
                                  "image_ms.eval", "fusion_ms.eval", "image_mfu.eval",
                                  "epoch_edge_ms.eval"])
def test_readers_find_nothing_without_marks_or_spans(name):
    """A program with no marks or spans (the parent of this tracing, or an
    eager run): every reader gives None."""
    plain = Trace(device=[("conv", 0.0, 5.0), ("index_select", 6.0, 7.0)],
                  host=[("cudaGraphLaunch", 0.0, 1.0)], window_s=0.01)
    assert _read(name, _ctx(plain)) is None
    assert _read(name, _ctx(None)) is None
