"""K1 and K2: windowed edge-weighted max aggregation for the text GCN and
its backward.

``out[b, j] = max_{o in [-g, g], 0 <= j+o < len_b} emb[b, j+o] * w[b, j, g+o]``
for ``j < len_b``; padded rows are ``-inf``.

The CUDA kernels (``csrc/edge_max.cu``) replace the Pallas TPU kernels of the
JAX package's ``mgnns_tpu/kernels/edge_max.py``: K1 its ``_kernel``, K2 its
``_bwd_kernel``.  Both are bound by bytes: K1 moves about
``2*B*L*D*4 + B*L*W*4`` bytes (3.9 MB at B=16, L=100, D=300, g=4), K2 about
``4*B*L*D*4 + 2*B*L*W*4`` (7.8 MB), a few microseconds of HBM time, so at
the model's sizes the launch dominates.

Both are ``torch.library`` custom operators, so ``torch.export`` records
them as graph nodes (``mgnns::edge_max_forward``, ``mgnns::edge_max_backward``)
and an exported program launches K1 when it runs on the card.  Each has a CUDA
kernel registration (K1 / K2 through :func:`_launch` / :func:`_launch_bwd`),
a CPU registration (:func:`window_max_aggregate_plain` /
:func:`window_max_aggregate_backward_plain`) and a fake one that gives the
output shapes; any other device raises.  The forward's autograd formula calls
the backward operator on the residuals ``(emb, w, lens)``, the JAX custom
VJP's.  :func:`window_max_aggregate` checks its inputs and calls the forward
operator.  K2 follows ``jnp.maximum``'s VJP, which differs from autograd
through ``torch.maximum`` for a NaN message (``==`` is false, so a NaN gets
nothing); K2 is therefore held against the explicit plain backward, not
against autograd of the plain forward.
"""

from __future__ import annotations

import ctypes
import functools

import torch

# kernel launches since each counter was last reset; the chip smoke test
# zeroes them before driving a path and reads them after
launches = 0       # K1
bwd_launches = 0   # K2

_MAX_NGRAM = 16  # kMaxWindow = 33 in csrc/edge_max.cu


def window_max_aggregate_plain(
    emb: torch.Tensor,   # [B, L, D] token embeddings
    w: torch.Tensor,     # [B, L, W] edge weights (dst-major window)
    lens: torch.Tensor,  # [B]
    ngram: int,
) -> torch.Tensor:
    """The plain version of K1, line for line the JAX package's
    ``nn/text_gcn.py:window_max_aggregate``."""
    B, L, D = emb.shape
    pos = torch.arange(L, device=emb.device)
    valid_j = pos[None, :] < lens[:, None]  # [B, L]
    neg = torch.tensor(float("-inf"), dtype=emb.dtype, device=emb.device)
    m = torch.full((B, L, D), float("-inf"), dtype=emb.dtype, device=emb.device)
    for k, o in enumerate(range(-ngram, ngram + 1)):
        s_pos = torch.clamp(pos + o, 0, L - 1)
        src = emb[:, s_pos, :]
        valid = (pos + o >= 0) & (pos + o < lens[:, None]) & valid_j  # [B, L]
        msg = src * w[:, :, k][:, :, None]
        m = torch.maximum(m, torch.where(valid[:, :, None], msg, neg))
    return m


def window_max_aggregate_backward_plain(
    emb: torch.Tensor,   # [B, L, D]
    w: torch.Tensor,     # [B, L, W]
    lens: torch.Tensor,  # [B]
    g: torch.Tensor,     # [B, L, D] gradient of the output
    ngram: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version of K2, line for line the JAX package's
    ``kernels/edge_max.py:_bwd_kernel``: recompute the forward max chain,
    then walk it backwards with ``jnp.maximum``'s VJP (a strict winner gets
    the gradient, an exact tie splits it 0.5/0.5, the ``-inf`` start absorbs
    nothing).  Shifted rows come from clamped indices and the validity mask,
    as in the forward, and ``d_emb`` adds its terms with k descending.
    Returns ``(d_emb [B, L, D], d_w [B, L, W])``; invalid slots get 0."""
    B, L, D = emb.shape
    pos = torch.arange(L, device=emb.device)
    valid_j = pos[None, :] < lens[:, None]
    neg = torch.tensor(float("-inf"), dtype=emb.dtype, device=emb.device)
    offsets = list(range(-ngram, ngram + 1))

    accs = [torch.full((B, L, D), float("-inf"), dtype=emb.dtype, device=emb.device)]
    msgs, valids, srcs = [], [], []
    for k, o in enumerate(offsets):
        src = emb[:, torch.clamp(pos + o, 0, L - 1), :]
        valid = (pos + o >= 0) & (pos + o < lens[:, None]) & valid_j
        msg = torch.where(valid[:, :, None], src * w[:, :, k][:, :, None], neg)
        accs.append(torch.maximum(accs[-1], msg))
        msgs.append(msg)
        valids.append(valid)
        srcs.append(src)

    g_acc = g
    d_emb = torch.zeros_like(emb)
    d_w = torch.zeros_like(w)
    zero = torch.zeros((), dtype=emb.dtype, device=emb.device)
    for k in range(len(offsets) - 1, -1, -1):
        prev, msg, out = accs[k], msgs[k], accs[k + 1]
        msg_hits = (msg == out).to(emb.dtype)
        prev_hits = (prev == out).to(emb.dtype)
        d_msg = g_acc * msg_hits / (1.0 + prev_hits)
        g_acc = g_acc * prev_hits / (1.0 + msg_hits)
        valid = valids[k]
        d_msg = torch.where(valid[:, :, None], d_msg, zero)
        d_w[:, :, k] = torch.where(valid, (d_msg * srcs[k]).sum(dim=2), zero)
        d_src = d_msg * w[:, :, k][:, :, None]
        # the inverse shift: source row s takes d_src of the row j = s - o
        o = offsets[k]
        j_pos = torch.clamp(pos - o, 0, L - 1)
        from_j = (pos - o >= 0) & (pos - o < L) & valid[:, j_pos]
        d_emb = d_emb + torch.where(from_j[:, :, None], d_src[:, j_pos, :], zero)
    return d_emb, d_w


def _check(emb: torch.Tensor, w: torch.Tensor, lens: torch.Tensor, ngram: int) -> None:
    if emb.dim() != 3 or w.dim() != 3 or lens.dim() != 1:
        raise ValueError(f"expected emb [B, L, D], w [B, L, W], lens [B]; got "
                         f"{tuple(emb.shape)}, {tuple(w.shape)}, {tuple(lens.shape)}")
    B, L, _ = emb.shape
    if tuple(w.shape) != (B, L, 2 * ngram + 1) or lens.shape[0] != B:
        raise ValueError(f"w {tuple(w.shape)} / lens {tuple(lens.shape)} do not "
                         f"match emb {tuple(emb.shape)} with ngram={ngram}")
    if emb.dtype != torch.float32 or w.dtype != torch.float32:
        raise TypeError(f"edge_max takes float32 emb and w, got {emb.dtype}, {w.dtype}")
    if lens.dtype != torch.int32:
        raise TypeError(f"edge_max takes int32 lens, got {lens.dtype}")
    if not (emb.is_contiguous() and w.is_contiguous() and lens.is_contiguous()):
        raise ValueError("edge_max takes contiguous emb, w and lens")
    if not (emb.device == w.device == lens.device):
        raise ValueError(f"edge_max inputs on different devices: "
                         f"{emb.device}, {w.device}, {lens.device}")
    if emb.device.type not in ("cuda", "cpu"):
        raise ValueError(f"edge_max runs on cuda or cpu tensors, got {emb.device}")
    if emb.device.type == "cuda" and not 0 <= ngram <= _MAX_NGRAM:
        raise ValueError(f"the CUDA edge_max kernels take 0 <= ngram <= {_MAX_NGRAM}, got {ngram}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _launch(emb: torch.Tensor, w: torch.Tensor, lens: torch.Tensor, ngram: int) -> torch.Tensor:
    global launches
    out = torch.empty_like(emb)
    B, L, D = emb.shape
    if out.numel() == 0:
        return out
    vec = 4 if D % 4 == 0 and emb.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0 else 1
    err = _library().mgnns_edge_max_forward(
        emb.data_ptr(), w.data_ptr(), lens.data_ptr(), out.data_ptr(),
        B, L, D, ngram, vec, emb.device.index, _stream(emb))
    if err != 0:
        raise RuntimeError(f"edge_max kernel launch failed: CUDA error {err}")
    launches += 1
    return out


def _launch_bwd(emb: torch.Tensor, w: torch.Tensor, lens: torch.Tensor, g: torch.Tensor,
                ngram: int) -> tuple[torch.Tensor, torch.Tensor]:
    global bwd_launches
    d_emb = torch.empty_like(emb)
    d_w = torch.empty_like(w)
    B, L, D = emb.shape
    if B == 0 or L == 0:
        return d_emb, d_w
    err = _library().mgnns_edge_max_backward(
        emb.data_ptr(), w.data_ptr(), g.data_ptr(), lens.data_ptr(),
        d_emb.data_ptr(), d_w.data_ptr(), B, L, D, ngram, emb.device.index, _stream(emb))
    if err != 0:
        raise RuntimeError(f"edge_max backward kernel launch failed: CUDA error {err}")
    bwd_launches += 1
    return d_emb, d_w


@functools.cache
def _library() -> ctypes.CDLL:
    from mgnns_tpu_torch.kernels import build

    lib = build.load("edge_max")
    fwd = lib.mgnns_edge_max_forward
    fwd.restype = ctypes.c_int
    fwd.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    bwd = lib.mgnns_edge_max_backward
    bwd.restype = ctypes.c_int
    bwd.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    return lib


@torch.library.custom_op(
    "mgnns::edge_max_forward", mutates_args=(), device_types="cpu",
    schema="(Tensor emb, Tensor w, Tensor lens, int ngram) -> Tensor")
def edge_max_forward(emb: torch.Tensor, w: torch.Tensor, lens: torch.Tensor,
                     ngram: int) -> torch.Tensor:
    """K1 as an operator; this registration is the CPU one, the plain version."""
    return window_max_aggregate_plain(emb, w, lens, ngram)


@edge_max_forward.register_kernel("cuda")
def _edge_max_forward_cuda(emb, w, lens, ngram):
    return _launch(emb, w, lens, ngram)


@edge_max_forward.register_fake
def _edge_max_forward_fake(emb, w, lens, ngram):
    return torch.empty_like(emb)


@torch.library.custom_op(
    "mgnns::edge_max_backward", mutates_args=(), device_types="cpu",
    schema="(Tensor emb, Tensor w, Tensor lens, Tensor g, int ngram) -> (Tensor, Tensor)")
def edge_max_backward(emb: torch.Tensor, w: torch.Tensor, lens: torch.Tensor, g: torch.Tensor,
                      ngram: int) -> tuple[torch.Tensor, torch.Tensor]:
    """K2 as an operator; this registration is the CPU one, the plain backward."""
    return window_max_aggregate_backward_plain(emb, w, lens, g, ngram)


@edge_max_backward.register_kernel("cuda")
def _edge_max_backward_cuda(emb, w, lens, g, ngram):
    return _launch_bwd(emb, w, lens, g, ngram)


@edge_max_backward.register_fake
def _edge_max_backward_fake(emb, w, lens, g, ngram):
    return torch.empty_like(emb), torch.empty_like(w)


def _backward(emb, w, lens, g, ngram):
    """K2 (the backward operator) on a checked, contiguous gradient."""
    if g.dtype != torch.float32 or g.shape != emb.shape or g.device != emb.device:
        raise ValueError(f"edge_max backward takes a float32 gradient of shape "
                         f"{tuple(emb.shape)} on {emb.device}, got {g.dtype} "
                         f"{tuple(g.shape)} on {g.device}")
    g = g.contiguous()  # the scatter-max backward hands over a strided view
    return torch.ops.mgnns.edge_max_backward(emb, w, lens, g, ngram)


def _setup_context(ctx, inputs, output):
    emb, w, lens, ngram = inputs
    ctx.ngram = ngram
    ctx.save_for_backward(emb, w, lens)


def _autograd_backward(ctx, g):
    emb, w, lens = ctx.saved_tensors
    d_emb, d_w = _backward(emb, w, lens, g, ctx.ngram)
    return d_emb, d_w, None, None


edge_max_forward.register_autograd(_autograd_backward, setup_context=_setup_context)


def window_max_aggregate(emb: torch.Tensor, w: torch.Tensor, lens: torch.Tensor,
                         ngram: int) -> torch.Tensor:
    """K1 (and, under autograd, K2) on the device the inputs lie on: the CUDA
    kernels for CUDA tensors, the plain versions for CPU tensors.  emb f32
    [B, L, D], w f32 [B, L, 2g+1], lens int32 [B] with values in [0, L], all
    contiguous."""
    _check(emb, w, lens, ngram)
    return torch.ops.mgnns.edge_max_forward(emb, w, lens, ngram)
