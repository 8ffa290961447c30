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
  generator).  They would train, so the parameters, the optimizer state, the
  BN statistics and the plan's buffers are copied before and written back
  after them: the first replay is the epoch's first step.
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

The JAX engine's segment ladder and memory guard, which split an epoch
program that XLA could not compile, have no counterpart: one captured step
has no whole-epoch program to split.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from mgnns_tpu_torch.engine import metrics as M
from mgnns_tpu_torch.nn.core import derive_seed

WARMUP_STEPS = 2


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
        steps.load(plan)
        return steps

    def _capture(self, steps: _PlanSteps, body, generators) -> torch.cuda.CUDAGraph:
        """Warm ``body`` up on a side stream with the state put back after,
        then capture it."""
        dev = self.engine.device
        keep = steps.state + steps.buffers()
        saved = [t.clone() for t in keep]
        if self._stream is None:
            self._stream = torch.cuda.Stream(dev)
            self._pool = torch.cuda.graph_pool_handle()
        side = self._stream
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(WARMUP_STEPS):
                steps.row.zero_()  # any row of the plan will do
                body()
        torch.cuda.current_stream(dev).wait_stream(side)
        for t, v in zip(keep, saved):
            t.copy_(v)
        del saved
        graph = torch.cuda.CUDAGraph()
        for gen in generators():
            # a plain Generator over the same state: the graph takes no subclass
            graph.register_generator_state(gen.graphsafe_get_state())
        with torch.cuda.graph(graph, pool=self._pool, stream=side,
                              capture_error_mode="thread_local"):
            body()
        return graph

    def _run(self, steps: _PlanSteps, body_for, phase_of, generators, before_step,
             after_step) -> float:
        """Run the plan's ``nb`` steps, capturing each phase's graph on first
        use; returns the seconds spent capturing."""
        capture_s = 0.0
        axis = self.engine.axis
        capture = self.engine.device.type == "cuda" and (axis is None or axis.capturable)
        for _ in range(steps.idx.shape[0]):
            phase = phase_of()
            if capture:
                graph = steps.graphs.get(phase)
                if graph is None:
                    tc = time.perf_counter()
                    graph = steps.graphs[phase] = self._capture(steps, body_for(phase), generators)
                    capture_s += time.perf_counter() - tc
                before_step()
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

        def body_for(apply_now: bool):
            def body():
                loss = eng._train_core(steps.batch(), steps.cm, apply_now)
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
        losses = steps.losses.cpu().numpy()  # waits for every step
        return {"losses": losses, "cm": steps.cm.cpu().numpy(), "capture_seconds": capture_s,
                "seconds": time.perf_counter() - t0 - capture_s}

    def eval(self, plan: dict) -> dict:
        """One eval epoch over ``plan``: per-batch losses and predictions
        (host), the confusion matrix and the times, as :meth:`train`."""
        eng = self.engine
        steps = self._steps(plan, train=False)

        def body_for(_):
            def body():
                loss, preds = eng._eval_core(steps.batch(), steps.cm)
                steps.losses.index_copy_(0, steps.row, loss.view(1))
                steps.preds.index_copy_(0, steps.row, preds.view(1, -1))
                steps.row.add_(1)
            return body

        t0 = time.perf_counter()
        capture_s = self._run(steps, body_for, lambda: None, list, lambda: None, lambda: None)
        losses = steps.losses.cpu().numpy()
        cm = steps.cm.cpu().numpy()
        return {"losses": losses, "preds": steps.preds.cpu().numpy(), "cm": cm,
                "capture_seconds": capture_s, "seconds": time.perf_counter() - t0 - capture_s}
