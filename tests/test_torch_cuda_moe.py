"""The MoE text encoder on the card: the grouped products against a loop
over the experts, the routing and dispatch captured in a CUDA graph (a
capture refuses any wait for the host), and a whole captured encoder step
replaying bit for bit what an eager step computes.  Imports neither JAX nor
the JAX package: on a machine with an NVIDIA GPU run ``python -m pytest
--noconftest tests/test_torch_cuda_moe.py``.  Without a card it skips."""

import dataclasses

import pytest
import torch

from test_torch_cuda import cuda_device  # noqa: F401

SMALL = {"hidden_size": 256, "num_layers": 3, "num_heads": 4, "kv_lora_rank": 64,
         "qk_nope_head_dim": 32, "qk_rope_head_dim": 16, "v_head_dim": 32,
         "intermediate_size": 512, "moe_intermediate_size": 128, "n_routed_experts": 16,
         "num_experts_per_tok": 4, "experts_held": (2, 3, 5, 7, 11), "vocab_rows": 1000}


def _captured(fn):
    """(graph, fn's outputs in the graph's memory), after a warm-up on a
    side stream."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    return graph, out


@pytest.mark.cuda
def test_grouped_products_match_the_loop_over_experts(cuda_device):
    """bf16 at Moonlight's expert widths, groups of 0 to 304 rows (padded
    to 8) and unused rows after the last: the output, the input's and the
    weights' gradients against each group's own products."""
    from mgnns_tpu_torch.kernels import grouped_mm as K

    g = torch.Generator(device=cuda_device).manual_seed(0)
    G, D, N, R = 8, 2048, 2 * 1408, 1400
    ends = [152, 152, 456, 600, 776, 904, 1016, 1200]
    offs = torch.tensor(ends, dtype=torch.int32, device=cuda_device)
    x = torch.randn(R, D, generator=g, device=cuda_device).to(torch.bfloat16).requires_grad_()
    w = (0.02 * torch.randn(G, D, N, generator=g, device=cuda_device)).to(
        torch.bfloat16).requires_grad_()
    dy = torch.randn(R, N, generator=g, device=cuda_device).to(torch.bfloat16)
    before = (K.launches, K.wgrad_launches)
    y = torch.ops.mgnns.grouped_mm(x, w, offs)
    dx, dw = torch.autograd.grad(y, (x, w), dy)
    assert (K.launches, K.wgrad_launches) == (before[0] + 2, before[1] + 1)
    lo = 0
    for e, hi in enumerate(ends):
        rows = slice(lo, hi)
        assert torch.equal(y[rows], x[rows] @ w[e])
        torch.testing.assert_close(dx[rows], dy[rows] @ w[e].T, rtol=1.6e-2, atol=1e-3)
        torch.testing.assert_close(dw[e].float(), (x[rows].float().T @ dy[rows].float()),
                                   rtol=1.6e-2, atol=0.1)
        lo = hi


@pytest.mark.cuda
def test_routing_and_dispatch_capture_with_no_host_sync(cuda_device):
    """The router, the top-k, the sort, the counts and offsets and the
    dispatch's places at the cell's shape, captured: a capture fails on any
    copy to the host or wait for it.  Replays give the eager results."""
    from mgnns_tpu_torch.config import MoeEncoderConfig
    from mgnns_tpu_torch.nn import moe

    enc = MoeEncoderConfig()
    counts = moe.token_counts(enc, cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(1)
    p = {"w": 0.02 * torch.randn(2048, 64, generator=g, device=cuda_device),
         "bias": 0.02 * torch.randn(64, generator=g, device=cuda_device)}
    n = torch.randn(1600, 2048, generator=g, device=cuda_device)

    local_of = moe.local_map(enc.experts_held, enc.n_routed_experts, cuda_device)

    def routing():
        chosen, w = moe.route(p, n, enc)
        disp = moe.Dispatch(chosen, local_of, 8, 8)
        moe._count(counts[:, 0], disp)
        return chosen, w, disp.pos, disp.src, disp.offs, disp.counts

    eager = [t.clone() for t in routing()]
    graph, static = _captured(routing)
    counts.zero_()
    for _ in range(2):
        graph.replay()
    torch.cuda.synchronize()
    for a, b in zip(eager, static):
        assert torch.equal(a, b)
    assert torch.equal(counts[0, 0], 2 * eager[-1]) and int(counts[0, 1:].sum()) == 0
    assert torch.equal(counts[1, 0], eager[-1])
    assert int(eager[-1].sum()) == int((eager[2] < 1600 * 6 + 8 * 7).sum())


@pytest.mark.cuda
def test_captured_encoder_step_is_bit_equal_to_eager(cuda_device):
    """A whole encoder step in bf16 (forward, backward into every leaf) at a
    small width with 5 of 16 experts held, captured: two replays give the
    output and every gradient bit-equal to each other and to an eager step
    (gathers with fixed sums, no atomic adds)."""
    from mgnns_tpu_torch.config import MoeEncoderConfig
    from mgnns_tpu_torch.nn import moe
    from mgnns_tpu_torch.utils import tree_leaves, tree_paths, tree_unflatten

    enc = MoeEncoderConfig(**SMALL)
    g = torch.Generator(device=cuda_device).manual_seed(2)
    params = moe.encoder_init(g, enc, 300)
    ids = torch.randint(0, enc.vocab_rows, (4, 48), generator=g, device=cuda_device)
    probe = torch.randn(4, 48, 300, generator=g, device=cuda_device)

    def step():
        # fresh leaves each step, as the engine takes them
        leaves = [t.detach().requires_grad_() for t in tree_leaves(params)]
        tree = tree_unflatten(params, leaves)
        trained = [t for path, t in zip(tree_paths(params), leaves)
                   if not path.endswith("router/bias")]
        out = moe.encoder_apply(tree, ids, enc, torch.bfloat16)
        return (out, *torch.autograd.grad((out * probe).sum(), trained))

    eager = [t.clone() for t in step()]
    graph, static = _captured(step)
    replays = []
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        replays.append([t.clone() for t in static])
    for a, b, c in zip(eager, *replays):
        assert torch.equal(a, b) and torch.equal(b, c)
    assert dataclasses.asdict(enc)["experts_held"] == (2, 3, 5, 7, 11)


def _encoder_small_fusion(device):
    """``test_torch_cuda._small_fusion``'s model with a small MoE text
    encoder (bf16 products, 5 of 16 experts held) in place of the BiLSTM."""
    import numpy as np

    from mgnns_tpu_torch.config import ModelConfig, MoeEncoderConfig
    from mgnns_tpu_torch.models.mgnns import mgnns_init
    from mgnns_tpu_torch.utils import tree_to

    r = np.random.default_rng(0)
    cfg = ModelConfig(vocab_size=50, edges_num=30, image_size=64, object_num_classes=4,
                      place_num_classes=5, compute_dtype="bfloat16",
                      text_encoder=MoeEncoderConfig(**dict(SMALL, vocab_rows=64)))
    params, stats, consts = mgnns_init(
        cfg, num_edges=30, label_embedding=r.standard_normal((7, 300)), object_A=np.eye(4),
        place_A=np.eye(5), object_inp=r.standard_normal((4, 300)),
        place_inp=r.standard_normal((5, 300)), device="cpu")
    return (cfg, *(tree_to(t, device) for t in (params, stats, consts)), None)


@pytest.mark.cuda
def test_captured_engine_epochs_with_the_encoder_equal_eager_steps(cuda_device, monkeypatch):
    """The fusion model with the encoder through ``Engine``: three train
    steps as replays over a plan against the same steps on the loop path,
    then a captured eval epoch against eager eval steps: losses, every
    parameter and the predictions alike (the capture's warm-ups hold the
    update, so the replays start from the same state)."""
    import numpy as np

    import test_torch_cuda as T
    from mgnns_tpu_torch.engine.metrics import confusion_init

    monkeypatch.setattr(T, "_small_fusion", _encoder_small_fusion)
    torch.backends.cudnn.deterministic, before = True, torch.backends.cudnn.deterministic
    try:
        graph_eng, loader, batches = T._fusion_plan_engine(cuda_device, 0.0)
        loop_eng, _, _ = T._fusion_plan_engine(cuda_device, 0.0)
        got = graph_eng.train_epoch(loader)
        cm = confusion_init(7, cuda_device)
        want = np.array([float(loop_eng.train_step(b, cm)) for b in batches], np.float32)
        assert got["fused"] and got["capture_seconds"] > 0
        np.testing.assert_allclose(got["step_losses"], want, rtol=1e-6)
        err, leaf = T._worst_leaf(graph_eng.params, loop_eng.params)
        assert err <= 1e-6, (err, leaf)
        ev = graph_eng.eval_epoch(loader, collect_preds=True)
        cm = confusion_init(7, cuda_device)
        preds = np.concatenate([loop_eng.eval_step(b, cm)[1].cpu().numpy() for b in batches])
        keep = loader.plan["weight"].reshape(-1).astype(bool)
        assert ev["fused"] and np.array_equal(ev["preds"], preds[keep])
    finally:
        torch.backends.cudnn.deterministic = before
