"""A captured step on the card survives Python's collector freeing another
engine's CUDA graphs (fault 3.6), shows its stage marks and kernels in
order, and replays the BiLSTM's kernels bit for bit.  Like ``tests/test_torch_cuda.py``, whose
fixtures it uses, it imports neither JAX nor the JAX package: on a machine
with an NVIDIA GPU run ``python -m pytest --noconftest
tests/test_torch_cuda_capture.py``.  Without a card it skips."""

import numpy as np
import pytest
import torch

from test_torch_cuda import _fusion_plan_engine, cuda_device, lstm_case, lstm_step  # noqa: F401


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
        # the BiLSTM's kernels, one a layer, inside its stage: the forward's
        # between its marks, the backward's from its .bwd mark to the next
        at = {m: s for s, m in found}
        fwd = trace.named("mgnns_lstm_fwd_kernel")
        bwd = trace.named("mgnns_lstm_bwd_kernel")
        assert len(fwd) == 2 and len(bwd) == 2 * k2
        assert all(at["mgnns.lstm.begin"] < s < at["mgnns.lstm.end"] for _, s, _ in fwd)
        assert all(at["mgnns.lstm.bwd"] < s < at["mgnns.text_gcn.bwd"] for _, s, _ in bwd)
        assert [h[0] for h in trace.host].count("graphs.replay") == 1
    assert launched == []  # a replay launches its marks without Python


@pytest.mark.cuda
def test_captured_lstm_replays_bit_equal(cuda_device):
    """The BiLSTM's forward and backward at the train cell's shape (B=16,
    L=100, H=150) captured in one CUDA graph: the capture holds one forward
    and one backward kernel a layer, and two replays give the memory bank,
    the final states and every gradient bit-equal to each other and to an
    eager call (no atomics, sums in a fixed order)."""
    from mgnns_tpu_torch.kernels import lstm as lstm_kernel
    from test_torch_cuda import _lstm_on

    args = _lstm_on(cuda_device, torch.float32, *lstm_case((16, 100, 150, 300), seed=5))
    eager = [t.clone() for t in lstm_step(*args)]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        lstm_step(*args)  # warm-up off the capture stream
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = (lstm_kernel.launches, lstm_kernel.bwd_launches)
    with torch.cuda.graph(graph):
        static = lstm_step(*args)
    assert (lstm_kernel.launches, lstm_kernel.bwd_launches) == (before[0] + 2, before[1] + 2)
    replays = []
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        replays.append([t.clone() for t in static])
    for a, b, c in zip(eager, *replays):
        assert torch.equal(a, b) and torch.equal(b, c)
