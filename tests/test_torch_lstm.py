"""The BiLSTM's operators on the CPU (``mgnns_tpu_torch/kernels/lstm.py``):
the plain reverse recurrence, the CPU form of the backward operator, against
``torch.autograd`` through the plain step loop in float64; the operators'
registrations under ``torch.library.opcheck``; the launch plan the CUDA
kernels take; and the wrapper's refusals.  ``tests/test_torch_modules.py``
holds ``lstm_apply`` to the JAX package, ``tests/test_torch_cuda.py`` the
kernels to the plain versions on the card."""

import pytest
import torch

from mgnns_tpu_torch.kernels import lstm as lstm_kernel
from mgnns_tpu_torch.nn import lstm

B, L, D, H = 4, 7, 5, 3

# lens with an empty document, a one-token one and a full one, and a batch
# whose documents all run to L
LENS = {"mixed": [0, 1, L, 4], "full": [L, L, L, L]}
# which outputs the loss reads: the memory bank and the final states, the
# bank alone, the final states alone, the cell states alone
UPSTREAM = {"all": ("out", "h", "c"), "out": ("out",), "states": ("h", "c"), "cells": ("c",)}


def _params(bidirectional: bool, seed: int = 0) -> dict:
    g = torch.Generator().manual_seed(seed)
    params = lstm.lstm_init(g, D, H, 2, bidirectional)
    return {"layers": [[{k: v.double().requires_grad_() for k, v in p.items()} for p in layer]
                       for layer in params["layers"]]}


def _loop_apply(params: dict, x: torch.Tensor, lens: torch.Tensor):
    """``lstm_apply`` through the plain step loop itself, every direction's
    projection on its own: what autograd differentiates as the reference."""
    step_valid = lstm._step_valid(x, lens)
    out, hs, cs = x, [], []
    for dir_params in params["layers"]:
        feats = []
        for d, p in enumerate(dir_params):
            o, h, c, _, _ = lstm._run_direction(out @ p["w_ih"] + p["b_ih"], p["w_hh"], p["b_hh"],
                                                step_valid, reverse=(d == 1))
            feats.append(o)
            hs.append(h)
            cs.append(c)
        out = torch.cat(feats, dim=-1)
    return out, (torch.stack(hs), torch.stack(cs))


@pytest.mark.parametrize("bidirectional", [True, False], ids=["bi", "uni"])
@pytest.mark.parametrize("upstream", list(UPSTREAM))
@pytest.mark.parametrize("lens_case", list(LENS))
def test_plain_backward_equals_autograd_through_the_loop(bidirectional, upstream, lens_case):
    """Two layers in float64: the memory bank and final states of the
    operator path equal the loop's, and every input and weight gradient
    through the operator (the plain reverse recurrence, then the GEMMs of
    its autograd formula) equals autograd through the loop."""
    params = _params(bidirectional)
    g = torch.Generator().manual_seed(1)
    x = torch.randn(B, L, D, generator=g, dtype=torch.float64, requires_grad=True)
    lens = torch.tensor(LENS[lens_case], dtype=torch.int32)
    dirs = 2 if bidirectional else 1
    weights = {"out": torch.randn(B, L, dirs * H, generator=g, dtype=torch.float64),
               "h": torch.randn(2 * dirs, B, H, generator=g, dtype=torch.float64),
               "c": torch.randn(2 * dirs, B, H, generator=g, dtype=torch.float64)}
    leaves = [x] + [p[k] for layer in params["layers"] for p in layer
                    for k in ("w_ih", "w_hh", "b_ih", "b_hh")]

    def grads(apply):
        out, (h, c) = apply(params, x, lens)
        loss = sum((t * weights[k]).sum() for k, t in zip(("out", "h", "c"), (out, h, c))
                   if k in UPSTREAM[upstream])
        return (out, h, c), torch.autograd.grad(loss, leaves)

    (out, h, c), got = grads(lstm.lstm_apply)
    (out_w, h_w, c_w), want = grads(_loop_apply)
    for a, b in ((out, out_w), (h, h_w), (c, c_w)):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-12)


def _layer_inputs(dirs: int, save_grad: bool = False):
    g = torch.Generator().manual_seed(dirs)
    xw = torch.randn(dirs, B, L, 4 * H, generator=g)
    w_hh = torch.randn(dirs, H, 4 * H, generator=g) * 0.5
    b_hh = torch.randn(dirs, 4 * H, generator=g) * 0.5
    if save_grad:
        xw, w_hh, b_hh = (t.requires_grad_() for t in (xw, w_hh, b_hh))
    return xw, w_hh, b_hh, torch.tensor(LENS["mixed"], dtype=torch.int32)


@pytest.mark.parametrize("dirs", [1, 2])
@pytest.mark.parametrize("op", ["forward", "forward_saving", "backward"])
def test_opcheck(op, dirs):
    """``torch.library.opcheck`` on the CPU: schema, fake registration and
    (with inputs that require grad) the autograd formula of each operator."""
    xw, w_hh, b_hh, lens = _layer_inputs(dirs, save_grad=(op == "forward_saving"))
    if op != "backward":
        torch.library.opcheck(torch.ops.mgnns.lstm_forward.default,
                              (xw, w_hh, b_hh, lens, op == "forward_saving"))
        return
    _, _, _, gates, cells = torch.ops.mgnns.lstm_forward(xw, w_hh, b_hh, lens, True)
    g = torch.Generator().manual_seed(3)
    up = (torch.randn(B, L, dirs * H, generator=g), torch.randn(dirs, B, H, generator=g), None)
    torch.library.opcheck(torch.ops.mgnns.lstm_backward.default,
                          (gates, cells, w_hh, lens, *up))


def test_saves_only_under_grad():
    """The forward keeps gates and cells for the backward only when a
    gradient is wanted; held steps save 0."""
    xw, w_hh, b_hh, lens = _layer_inputs(2)
    *_, gates, cells = torch.ops.mgnns.lstm_forward(xw, w_hh, b_hh, lens, False)
    assert gates.numel() == cells.numel() == 0
    *_, gates, cells = torch.ops.mgnns.lstm_forward(xw, w_hh, b_hh, lens, True)
    assert gates.shape == (2, B, L, 4 * H) and cells.shape == (B, L, 2 * H)
    held = torch.arange(L)[None, :] >= lens[:, None].long()
    assert not gates[:, held].any() and not cells[held].any() and cells[~held].all()


@pytest.mark.parametrize("H_,B_,want", [
    (150, 16, (6, 4, 16, 416)),     # train: 2 directions x 4 tiles x 6 = 48 CTAs
    (150, 128, (6, 16, 4, 416)),    # eval: 2 x 8 x 6 = 96 CTAs
    (150, 1, (6, 4, 16, 416)),
    (37, 16, (2, 4, 16, 320)),      # the last CTA of a cluster owns 18 units, not 19
    (200, 64, (8, 16, 4, 416)),
    (1, 3, (1, 4, 32, 32)),
])
def test_plan(H_, B_, want):
    """The launch follows from H and B: a CTA owns at most 25 units, the
    clusters fit three quarters of the H100's 132 SMs where a tile allows,
    the block covers every (unit, 4-row group) with its lanes, and shared
    memory fits a block's 227 KB."""
    p = lstm_kernel.plan(H_, B_, 2, 132)
    units = -(-H_ // p.cluster)
    assert (p.cluster, p.rows, p.ks, p.threads) == want
    assert units <= 25 and p.cluster <= 8 and p.threads % 32 == 0 and p.threads <= 512
    assert p.threads >= units * p.rows // 4 * p.ks and 4 <= p.ks <= 32
    assert p.smem_fwd < p.smem_bwd <= 232448


def _bad(case: str):
    xw, w_hh, b_hh, lens = _layer_inputs(2)
    if case == "shape":
        return xw[..., :-4].contiguous(), w_hh, b_hh, lens
    if case == "lens":
        return xw, w_hh, b_hh, lens[:-1]
    if case == "dtype":
        return xw.double(), w_hh, b_hh, lens
    if case == "float_lens":
        return xw, w_hh, b_hh, lens.float()
    if case == "strided":
        return xw.transpose(1, 2).contiguous().transpose(1, 2), w_hh, b_hh, lens
    if case == "empty":
        return xw[:, :0], w_hh, b_hh, lens[:0]
    raise AssertionError(case)


@pytest.mark.parametrize("case", ["shape", "lens", "dtype", "float_lens", "strided", "empty"])
def test_layer_refuses(case):
    with pytest.raises((ValueError, TypeError)):
        lstm_kernel.lstm_layer(*_bad(case))


def test_plan_refuses_a_width_the_kernels_do_not_take():
    with pytest.raises(ValueError, match="H <= 200"):
        lstm_kernel.plan(201, 16, 2, 132)  # a cluster of 9
