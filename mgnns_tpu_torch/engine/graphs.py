"""Train and eval epochs over an epoch plan, as one captured step replayed
per batch.

The counterpart of the JAX engine's fused whole-epoch programs
(``mgnns_tpu/engine/train.py:_build_fused``): there a ``lax.scan`` runs the
epoch over a loader's device tables; here a CUDA graph of one whole step
(gather, forward, loss, backward, the guarded optimizer and the confusion
update) is replayed once per batch, with no Python between its ~29k
launches.  The plan's ``[nb, B]`` index and weight matrices are copied into
static device buffers at each epoch, and the step reads row ``i`` of them
through a device step counter, which it increments.

- Capture runs a few eager warm-up steps on a side stream first (they build
  the kernels' library, the BLAS handles and every dropout site's
  generator).  A train step's warm-up runs with the update held
  (``Engine._train_core(hold=True)``: the nan-guard's flag false), so the
  parameters, the optimizer state and the BN statistics keep their values
  without a copy (a MoE text encoder's are tens of GB); the plan's buffers
  are copied before and written back after them: the first replay is the
  epoch's first step.
- Dropout: the engine's :class:`~mgnns_tpu_torch.nn.core.SiteGenerators`
  are registered with each train graph, and re-seeded on the host before
  each replay with the seeds the loop path uses, so a replay draws the loop
  path's masks.
- Under gradient accumulation a train step is one of two graphs,
  accumulate-only and accumulate-and-apply; the optimizer's host
  ``mini_step`` picks the one to replay.
- Graphs are cached per (train or eval, the plan's tables, its shape, the
  accumulation phase).  A graph reads the engine's state tensors at fixed
  addresses, so the cache is dropped when the engine's tensors are not the
  ones it was captured with (``Engine.restore`` and ``load_model_state``
  rebind them).
- All graphs of an engine share one memory pool: they never run at once.
  The warm-up steps allocate from it too, so they reuse what the graphs
  hold between replays.
- What the libraries chose at capture stays in the graph: cuDNN's
  algorithms (``torch.backends.cudnn.deterministic`` included) and the
  conv precision pin.
- A capture error raises; nothing falls back to eager steps.  On an engine
  whose device is the CPU the same step runs eagerly over the plan, which
  is how the CPU tests hold this path to the loop path and to the JAX
  package.
- On a mesh the backend of the data axis decides.  NCCL's collectives (the
  BatchNorm statistics, the gradient bucket) are captured inside the graph:
  the process group and its communicator exist before capture
  (:func:`mgnns_tpu_torch.parallel.multihost.initialize` runs a warm-up
  collective), and the warm-up steps run them on the capture stream.  gloo
  cannot be captured, so under gloo the plan path runs the same step
  eagerly on the card, as on the CPU.  A plan's ``weight_total`` (the
  global weight sum of each batch) is a static buffer beside ``weight``.
  A model axis's collectives (``parallel/collectives.py``) are plain
  all-reduces in the step's forward and backward, captured the same way.

The JAX engine's segment ladder and memory guard, which split an epoch
program that XLA could not compile, have no counterpart: one captured step
has no whole-epoch program to split.

Tracing (:mod:`mgnns_tpu_torch.tracing`): an epoch's host work is spans,
``graphs.plan_load`` (the plan's buffers), ``graphs.replay`` (``step``, the
plan row), ``graphs.readback`` (the losses, predictions and confusion
matrix), inside the engine's ``engine.epoch``; ``graphs.capture`` (``train``,
``shape``, the plan's ``[nb, B]``) spans the warm-up steps and the capture.
The step's own ranges (``engine.*``, ``mgnns.*``) are recorded at the
capture only, never in a replay; its stage marks are kernels of the graph,
so every replay shows them in the device trace.
"""

from __future__ import annotations

import contextlib
import gc
import time

import numpy as np
import torch

from mgnns_tpu_torch import tracing
from mgnns_tpu_torch.engine import metrics as M
from mgnns_tpu_torch.nn.core import derive_seed

WARMUP_STEPS = 2


@contextlib.contextmanager
def _allocating_from(pool, device: torch.device):
    """The current stream's allocations, from every thread (the backward's
    too), taken from the graphs' ``pool``: an eager warm-up then reuses the
    memory the engine's graphs hold between their replays, instead of
    needing as much again beside them (a MoE text encoder's step does not
    fit twice beside its parameters and Adam state)."""
    index = torch.cuda._utils._get_device_index(device, optional=True)
    torch._C._cuda_beginAllocateToPool(index, pool.id)
    try:
        yield
    finally:
        torch._C._cuda_endAllocateToPool(index, pool.id)
        torch._C._cuda_releasePool(index, pool.id)


class _PlanSteps:
    """Static buffers of one plan's tables and shape, and its graphs."""

    def __init__(self, plan: dict, num_classes: int, device: torch.device, train: bool,
                 state: list[torch.Tensor]):
        nb, B = plan["idx"].shape
        self.tables = dict(plan["tables"])
        self.row_shapes = {k: tuple(v) for k, v in (plan.get("row_shapes") or {}).items()}
        self.idx = torch.zeros((nb, B), dtype=torch.int64, device=device)
        self.weight = torch.zeros((nb, B), dtype=torch.float32, device=device)
        self.weight_total = (torch.zeros(nb, dtype=torch.float32, device=device)
                             if "weight_total" in plan else None)
        self.losses = torch.zeros(nb, dtype=torch.float32, device=device)
        self.preds = None if train else torch.zeros((nb, B), dtype=torch.int64, device=device)
        self.row = torch.zeros(1, dtype=torch.int64, device=device)
        self.cm = M.confusion_init(num_classes, device)
        self.graphs: dict = {}
        self.state = state  # the engine's tensors the graphs read and write
        self.train = train

    def buffers(self) -> list[torch.Tensor]:
        return [t for t in (self.losses, self.preds, self.row, self.cm) if t is not None]

    def load(self, plan: dict) -> None:
        self.idx.copy_(torch.from_numpy(np.asarray(plan["idx"])))
        self.weight.copy_(torch.from_numpy(np.asarray(plan["weight"])))
        if self.weight_total is not None:
            self.weight_total.copy_(torch.from_numpy(np.asarray(plan["weight_total"], np.float32)))
        self.row.zero_()
        self.cm.zero_()

    def batch(self) -> dict:
        """Row ``row`` of the plan, gathered from the tables on the device."""
        idx = self.idx.index_select(0, self.row)[0]
        out = {}
        for k, table in self.tables.items():
            rows = table.index_select(0, idx)
            if k in self.row_shapes:
                rows = rows.view((idx.shape[0],) + self.row_shapes[k])
            out[k] = rows
        out["weight"] = self.weight.index_select(0, self.row)[0]
        if self.weight_total is not None:
            out["weight_total"] = self.weight_total.index_select(0, self.row)[0]
        return out


class StepGraphs:
    """The plan path of one :class:`~mgnns_tpu_torch.engine.train.Engine`."""

    def __init__(self, engine):
        self.engine = engine
        self._plans: dict = {}
        self._pool = None
        self._stream = None

    def clear(self) -> None:
        """Drop every graph and buffer (the engine's tensors were rebound)."""
        self._plans.clear()

    def _steps(self, plan: dict, train: bool) -> _PlanSteps:
        eng = self.engine
        state = eng._state_tensors()
        if any(len(s.state) != len(state) or any(a is not b for a, b in zip(s.state, state))
               for s in self._plans.values()):
            self.clear()
        tables = tuple(sorted((k, t.data_ptr(), tuple(t.shape), str(t.dtype))
                              for k, t in plan["tables"].items()))
        key = (train, tables, tuple(plan["idx"].shape))
        if key not in self._plans:
            self._plans[key] = _PlanSteps(plan, eng.num_classes, eng.device, train, state)
        steps = self._plans[key]
        with tracing.span("graphs.plan_load"):
            steps.load(plan)
        return steps

    def _capture(self, steps: _PlanSteps, body, warm_up, generators) -> torch.cuda.CUDAGraph:
        """Run ``warm_up`` (``body`` leaving the engine's state as it is) on
        a side stream with the plan's buffers put back after, then capture
        ``body``."""
        dev = self.engine.device
        keep = steps.buffers()
        saved = [t.clone() for t in keep]
        if self._stream is None:
            self._stream = torch.cuda.Stream(dev)
            with torch.cuda.device(dev):
                self._pool = torch.cuda.MemPool()  # alive as long as the engine
        side = self._stream
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side), _allocating_from(self._pool, dev):
            for _ in range(WARMUP_STEPS):
                steps.row.zero_()  # any row of the plan will do
                warm_up()
        torch.cuda.current_stream(dev).wait_stream(side)
        for t, v in zip(keep, saved):
            t.copy_(v)
        del saved
        graph = torch.cuda.CUDAGraph()
        for gen in generators():
            # a plain Generator over the same state: the graph takes no subclass
            graph.register_generator_state(gen.graphsafe_get_state())
        # a dropped engine is a reference cycle (it and its StepGraphs) that
        # holds CUDA graphs; the collector freeing one during a capture runs
        # the graph's reset, which the capturing stream does not permit, and
        # the capture is invalidated (fault 3.6).  Collect before, not during.
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self._pool.id, stream=side,
                                  capture_error_mode="thread_local"):
                body()
        finally:
            if collecting:
                gc.enable()
        return graph

    def _run(self, steps: _PlanSteps, body_for, phase_of, generators, before_step,
             after_step) -> float:
        """Run the plan's ``nb`` steps, capturing each phase's graph on first
        use; returns the seconds spent capturing."""
        capture_s = 0.0
        axis = self.engine.axis
        capture = self.engine.device.type == "cuda" and (axis is None or axis.capturable)
        for i in range(steps.idx.shape[0]):
            phase = phase_of()
            if capture:
                graph = steps.graphs.get(phase)
                if graph is None:
                    with tracing.span("graphs.capture", train=steps.train,
                                      shape=tuple(steps.idx.shape)) as timed:
                        graph = steps.graphs[phase] = self._capture(
                            steps, body_for(phase), body_for(phase, hold=True), generators)
                    capture_s += timed.seconds
                before_step()
                with tracing.span("graphs.replay", step=i):
                    graph.replay()
            else:
                before_step()
                body_for(phase)()
            after_step()
        return capture_s

    def train(self, plan: dict) -> dict:
        """One train epoch over ``plan``: per-step losses (host float32),
        the confusion matrix, ``capture_seconds`` and ``seconds`` (the epoch
        without capture, up to the losses' readback)."""
        eng = self.engine
        opt, state = eng.opt, eng.opt_state
        steps = self._steps(plan, train=True)

        def body_for(apply_now: bool, hold: bool = False):
            def body():
                loss = eng._train_core(steps.batch(), steps.cm, apply_now, hold)
                steps.losses.index_copy_(0, steps.row, loss.view(1))
                steps.row.add_(1)
            return body

        def before_step():
            eng._gens.reseed(derive_seed(eng.seed, eng.step))

        def after_step():
            opt.advance(state)
            eng.step += 1

        t0 = time.perf_counter()
        capture_s = self._run(steps, body_for, lambda: opt.applies_now(state),
                              eng._gens.generators, before_step, after_step)
        with tracing.span("graphs.readback"):
            losses = steps.losses.cpu().numpy()  # waits for every step
            cm = steps.cm.cpu().numpy()
        return {"losses": losses, "cm": cm, "capture_seconds": capture_s,
                "seconds": time.perf_counter() - t0 - capture_s}

    def eval(self, plan: dict) -> dict:
        """One eval epoch over ``plan``: per-batch losses and predictions
        (host), the confusion matrix and the times, as :meth:`train`."""
        eng = self.engine
        steps = self._steps(plan, train=False)

        def body_for(_, hold=False):  # an eval step changes no state of the engine
            def body():
                loss, preds = eng._eval_core(steps.batch(), steps.cm)
                steps.losses.index_copy_(0, steps.row, loss.view(1))
                steps.preds.index_copy_(0, steps.row, preds.view(1, -1))
                steps.row.add_(1)
            return body

        t0 = time.perf_counter()
        capture_s = self._run(steps, body_for, lambda: None, list, lambda: None, lambda: None)
        with tracing.span("graphs.readback"):
            losses = steps.losses.cpu().numpy()
            cm = steps.cm.cpu().numpy()
            preds = steps.preds.cpu().numpy()
        return {"losses": losses, "preds": preds, "cm": cm,
                "capture_seconds": capture_s, "seconds": time.perf_counter() - t0 - capture_s}
