"""A captured step on the card survives Python's collector freeing another
engine's CUDA graphs (fault 3.6).  Like ``tests/test_torch_cuda.py``, whose
fixtures it uses, it imports neither JAX nor the JAX package: on a machine
with an NVIDIA GPU run ``python -m pytest --noconftest
tests/test_torch_cuda_capture.py``.  Without a card it skips."""

import numpy as np
import pytest
import torch

from test_torch_cuda import _fusion_plan_engine, cuda_device  # noqa: F401


@pytest.mark.cuda
def test_capture_survives_collecting_a_dropped_engine(cuda_device, monkeypatch):
    """Fault 3.6: an engine that captured its steps and was dropped is a
    reference cycle holding CUDA graphs.  Here the collector is off while
    it is dropped and runs inside the next engine's capture (from the
    forward, only while the stream captures): the capture must still
    succeed, because the engine collects before it captures."""
    import gc

    first, loader, _ = _fusion_plan_engine(cuda_device, 0.0)
    first.train_epoch(loader)  # captures
    collecting = gc.isenabled()
    gc.disable()
    try:
        del first
        second, loader, _ = _fusion_plan_engine(cuda_device, 0.0)
        apply_fn = second.apply_fn
        collected = []

        def collect_while_capturing(*a, **kw):
            if torch.cuda.is_current_stream_capturing():
                collected.append(gc.collect())
            return apply_fn(*a, **kw)

        monkeypatch.setattr(second, "apply_fn", collect_while_capturing)
        out = second.train_epoch(loader)
    finally:
        if collecting:
            gc.enable()
    assert collected and out["fused"] and np.isfinite(out["step_losses"]).all()


@pytest.mark.cuda
def test_each_replay_shows_every_mark_once_in_order(cuda_device, monkeypatch):
    """Under the profiler, one replay of the captured train step and one of
    the eval step put each of their stage marks on the device once, in the
    order the step runs its stages (``tests/test_torch_tracing.py`` holds
    the same order on the CPU, capturing forced on); the K1 and K2 readers'
    name fragments find their one launch each, and no mark."""
    from benchmark.trace import MARGIN_S, Traced
    from mgnns_tpu_torch import tracing
    from test_torch_tracing import FORWARD, TRAIN_STEP

    launched: list[str] = []
    launch = tracing._launch

    def counted(name: str) -> None:
        launched.append(name)
        launch(name)

    monkeypatch.setattr(tracing, "_launch", counted)
    eng, loader, _ = _fusion_plan_engine(cuda_device, 0.0, nb=1)
    runs = ((lambda: eng.train_epoch(loader), TRAIN_STEP, 1),
            (lambda: eng.eval_epoch(loader), FORWARD, 0))
    for run, want, _ in runs:
        launched.clear()
        run()  # captures: the marks launch once, in the capture, not in its warm-up
        assert launched == want
    launched.clear()
    for run, want, k2 in runs:
        with Traced(MARGIN_S) as traced:
            run()
        trace = traced.trace
        found = [(s, tracing.mark_of(name)) for name, s, _ in trace.device
                 if name.startswith("mgnns_mark_")]
        assert [m for _, m in sorted(found)] == want
        assert len(trace.named("edge_max_fwd_kernel")) == 1
        assert len(trace.named("edge_max_bwd_kernel")) == k2
        assert [h[0] for h in trace.host].count("graphs.replay") == 1
    assert launched == []  # a replay launches its marks without Python
