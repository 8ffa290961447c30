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
