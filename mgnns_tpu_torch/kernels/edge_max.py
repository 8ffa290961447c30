"""K1: windowed edge-weighted max aggregation for the text GCN.

``out[b, j] = max_{o in [-g, g], 0 <= j+o < len_b} emb[b, j+o] * w[b, j, g+o]``
for ``j < len_b``; padded rows are ``-inf``.

The CUDA kernel (``csrc/edge_max.cu``) replaces the Pallas TPU kernel
``mgnns_tpu/kernels/edge_max.py:_kernel`` of the JAX package.  Its bound is
bytes: about ``2*B*L*D*4 + B*L*W*4`` (3.9 MB at B=16, L=100, D=300, g=4),
a few microseconds of HBM time, so at serving sizes the launch dominates.

:func:`window_max_aggregate` launches the kernel for CUDA tensors and runs
:func:`window_max_aggregate_plain` for CPU tensors; any other device, dtype
or layout raises.  The backward (K2 in the JAX package) is not ported yet,
so inputs that require grad raise.
"""

from __future__ import annotations

import ctypes
import functools

import torch

# kernel launches since the counter was last reset; the chip smoke test
# zeroes it before driving the serving path and reads it after
launches = 0

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
    if emb.requires_grad or w.requires_grad:
        raise NotImplementedError(
            "edge_max has no backward yet: K2 (mgnns_tpu/kernels/edge_max.py:"
            "_bwd_kernel) is queued for the training slice")


def _launch(emb: torch.Tensor, w: torch.Tensor, lens: torch.Tensor, ngram: int) -> torch.Tensor:
    global launches
    if not 0 <= ngram <= _MAX_NGRAM:
        raise ValueError(f"the CUDA edge_max kernel takes 0 <= ngram <= {_MAX_NGRAM}, got {ngram}")
    out = torch.empty_like(emb)
    B, L, D = emb.shape
    if out.numel() == 0:
        return out
    vec = 4 if D % 4 == 0 and emb.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0 else 1
    err = _library().mgnns_edge_max_forward(
        emb.data_ptr(), w.data_ptr(), lens.data_ptr(), out.data_ptr(),
        B, L, D, ngram, vec, emb.device.index,
        torch.cuda.current_stream(emb.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"edge_max kernel launch failed: CUDA error {err}")
    launches += 1
    return out


@functools.cache
def _library() -> ctypes.CDLL:
    from mgnns_tpu_torch.kernels import build

    lib = build.load("edge_max")
    fn = lib.mgnns_edge_max_forward
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    return lib


def window_max_aggregate(emb: torch.Tensor, w: torch.Tensor, lens: torch.Tensor,
                         ngram: int) -> torch.Tensor:
    """K1 on the device the inputs lie on: the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors.  emb f32 [B, L, D], w f32 [B, L, 2g+1],
    lens int32 [B] with values in [0, L], all contiguous."""
    _check(emb, w, lens, ngram)
    if emb.device.type == "cuda":
        return _launch(emb, w, lens, ngram)
    if emb.device.type == "cpu":
        return window_max_aggregate_plain(emb, w, lens, ngram)
    raise ValueError(f"edge_max runs on cuda or cpu tensors, got {emb.device}")
