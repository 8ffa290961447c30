"""The port's tracing: host spans in a ring, profiler ranges, and device
marks inside captured work.

- :func:`span` (``with tracing.span(name, **attrs):``, or as a decorator)
  opens a ``torch.profiler.record_function`` range of ``name``, so inside a
  profiler trace the span lies on the profiler's clock beside the device
  events, and at its exit appends a :class:`Span` to a bounded ring in this
  process: its name, the name of the span open around it on the same thread
  (``parent``), its ``time.perf_counter_ns`` bounds, the thread and
  ``attrs``, under a lock, and keeps its length in ``seconds``.
  :func:`spans` reads the ring, :func:`reset` clears it.  :func:`tags` adds attributes to every span its block opens on
  its thread (the serving path tags each chunk's spans with its id).
- :func:`stage` is a span that, while the current CUDA stream is capturing a
  graph, also launches a mark kernel on it at entry (``<name>.begin``) and
  at exit (``<name>.end``).  A range is recorded once, when the graph is
  captured, and never in a replay; the marks are kernels of the graph, so
  every replay puts both in the device trace.  Eager work (serving, the CPU,
  the loop path) launches no marks: there the profiler ties kernels to
  ranges.
- :func:`grad_mark` is the identity on a stage's output.  While capturing,
  and where the output needs a gradient, its backward launches
  ``<name>.bwd`` when the output's gradient is complete, and passes the
  gradient through as it is.  Autograd runs a node's inputs' backward after
  it, later stages' nodes first, so the backward of a stage runs from its
  ``.bwd`` mark up to the next mark on the device: that interval is the
  stage's backward.

Mark ``i`` (:data:`MARKS`) is the kernel ``mgnns_mark_<i>`` of
``kernels/csrc/mark.cu``; :func:`mark_of` reads a kernel name back.
"""

from __future__ import annotations

import collections
import contextlib
import re
import threading
import time
from typing import NamedTuple

import torch
from torch.profiler import record_function

# the stages that launch marks, and those whose output carries a grad mark
STAGES = ("engine.forward", "engine.backward", "engine.all_reduce", "engine.optimizer",
          "mgnns.text_gcn", "mgnns.lstm", "mgnns.object_channel", "mgnns.place_channel",
          "mgnns.fusion")
GRAD_MARKED = ("mgnns.text_gcn", "mgnns.lstm", "mgnns.object_channel", "mgnns.place_channel",
               "mgnns.fusion")
# the MoE text encoder's stages (nn/moe.py), after the others so that their
# marks keep their ids
ENCODER_STAGES = ("encoder.attention", "encoder.routing", "encoder.experts", "encoder.mlp")
MARKS = (tuple(f"{s}.{edge}" for s in STAGES for edge in ("begin", "end"))
         + tuple(f"{s}.bwd" for s in GRAD_MARKED)
         + tuple(f"{s}.{edge}" for s in ENCODER_STAGES for edge in ("begin", "end", "bwd")))
_MARK_IDS = {name: i for i, name in enumerate(MARKS)}
_MARK_KERNEL = re.compile(r"mgnns_mark_(\d+)$")

RING_SIZE = 1 << 15


class Span(NamedTuple):
    name: str
    parent: str | None  # the span open around it on its thread
    start_ns: int       # time.perf_counter_ns
    end_ns: int
    thread: int         # threading.get_ident()
    attrs: dict


_ring: collections.deque = collections.deque(maxlen=RING_SIZE)
_lock = threading.Lock()
_local = threading.local()


def _thread_state() -> tuple[list, dict]:
    """This thread's stack of open span names and its tags."""
    try:
        return _local.stack, _local.tags
    except AttributeError:
        _local.stack, _local.tags = [], {}
        return _local.stack, _local.tags


class span(contextlib.ContextDecorator):
    """A profiler range of ``name`` and, at its exit, a :class:`Span` in
    the ring; after the exit ``seconds`` is its length.  As a decorator
    each call opens a span of its own."""

    def __init__(self, name: str, **attrs):
        self.name = name
        self.attrs = attrs

    def _recreate_cm(self):
        return type(self)(self.name, **self.attrs)

    def __enter__(self):
        self._stack, tags = _thread_state()
        self._attrs = {**tags, **self.attrs} if tags else self.attrs
        self._parent = self._stack[-1] if self._stack else None
        self._stack.append(self.name)
        self._range = record_function(self.name)
        self._range.__enter__()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        self._range.__exit__(*exc)
        self._stack.pop()
        self.seconds = (t1 - self._t0) / 1e9
        rec = Span(self.name, self._parent, self._t0, t1, threading.get_ident(), self._attrs)
        with _lock:
            _ring.append(rec)
        return False


class stage(span):
    """A span that launches ``<name>.begin`` / ``<name>.end`` marks while
    the current CUDA stream is capturing; ``name`` is one of :data:`STAGES`."""

    def __enter__(self):
        super().__enter__()
        self._marks = _capturing()
        if self._marks:
            _launch(f"{self.name}.begin")
        return self

    def __exit__(self, *exc):
        if self._marks and exc[0] is None:
            _launch(f"{self.name}.end")
        return super().__exit__(*exc)


class _GradMark(torch.autograd.Function):
    @staticmethod
    def forward(ctx, name, *xs):
        ctx.name = name
        ctx.set_materialize_grads(False)
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        if _capturing():
            _launch(f"{ctx.name}.bwd")
        return (None, *grads)


def grad_mark(x, name: str):
    """``x`` (a tensor or a tuple of tensors) as it is; while capturing, and
    where it needs a gradient, through an identity whose backward launches
    ``<name>.bwd``."""
    xs = (x,) if isinstance(x, torch.Tensor) else tuple(x)
    if not (torch.is_grad_enabled() and any(t.requires_grad for t in xs) and _capturing()):
        return x
    out = _GradMark.apply(name, *xs)
    return out[0] if isinstance(x, torch.Tensor) else out


@contextlib.contextmanager
def tags(**attrs):
    """Adds ``attrs`` to every span that this thread opens in the block."""
    _, current = _thread_state()
    saved = dict(current)
    current.update(attrs)
    try:
        yield
    finally:
        current.clear()
        current.update(saved)


def spans(prefix: str = "") -> list[Span]:
    """The ring's spans whose name starts with ``prefix``, oldest first."""
    with _lock:
        return [s for s in _ring if s.name.startswith(prefix)]


def reset() -> None:
    with _lock:
        _ring.clear()


def mark_of(kernel: str) -> str | None:
    """The mark that the kernel named ``kernel`` launches, None for any
    other kernel."""
    m = _MARK_KERNEL.match(kernel)
    return MARKS[int(m.group(1))] if m and int(m.group(1)) < len(MARKS) else None


def _capturing() -> bool:
    """Whether the current CUDA stream is capturing a graph (never before
    CUDA is initialized, which this does not do)."""
    return torch.cuda.is_initialized() and torch.cuda.is_current_stream_capturing()


def _launch(mark: str) -> None:
    from mgnns_tpu_torch.kernels import mark as K

    K.launch(_MARK_IDS[mark])
