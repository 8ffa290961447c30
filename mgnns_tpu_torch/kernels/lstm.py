"""The BiLSTM's recurrence as two persistent CUDA kernels, one layer and
every direction a launch: ``mgnns_lstm_fwd_kernel`` runs the L steps of the
forward, ``mgnns_lstm_bwd_kernel`` the reverse-time gradient chain
(``csrc/lstm.cu``, which says how).

Everything that is not recurrent stays a large call over the whole
sequence: :func:`mgnns_tpu_torch.nn.lstm.lstm_apply` projects the input with
one GEMM a direction (``xw = x @ w_ih + b_ih``), and the backward formula
here turns the kernel's ``dgates`` into ``dW_hh`` and ``db_hh`` with one
batched GEMM and a sum; autograd through the projections gives ``dx``,
``dW_ih`` and ``db_ih``.

Both kernels are ``torch.library`` custom operators, as K1 and K2 are
(:mod:`mgnns_tpu_torch.kernels.edge_max`): ``mgnns::lstm_forward`` and
``mgnns::lstm_backward``, each with a CUDA registration that launches its
kernel (or raises), a CPU registration that is the plain version
(``nn/lstm.py``: the step loop, and the plain reverse recurrence) and a fake
one, so an exported program holds one node a layer.  The forward's autograd
formula calls the backward operator.  The launch plan (cluster size, batch
tile, lanes a unit) follows from ``H`` and ``B`` alone (:func:`plan`).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch
from torch.utils.flop_counter import register_flop_formula

from mgnns_tpu_torch.nn import lstm as plain

# kernel launches since each counter was last reset (Python calls; a graph
# replay runs none of them)
launches = 0       # mgnns_lstm_fwd_kernel
bwd_launches = 0   # mgnns_lstm_bwd_kernel

_MAX_UNITS = 25     # hidden units a CTA owns at most: H = 150 takes a cluster of 6
_MAX_CLUSTER = 8    # the portable cluster size
_MAX_THREADS = 512  # kMaxThreads in csrc/lstm.cu
_ROW_TILES = (4, 8, 16)


@dataclasses.dataclass(frozen=True)
class Plan:
    cluster: int   # CTAs of a cluster; each owns ceil(H / cluster) units
    rows: int      # batch rows of a cluster's tile
    ks: int        # lanes that split a unit's sum over k
    threads: int   # a CTA's threads
    smem_fwd: int  # dynamic shared memory of a forward CTA, bytes
    smem_bwd: int  # and of a backward CTA


def plan(H: int, B: int, dirs: int, sm_count: int) -> Plan:
    """The launch of one layer: the smallest cluster whose CTAs own at most
    25 units, then the smallest batch tile whose clusters (one a tile and
    direction) fit in three quarters of the SMs (clusters are placed inside
    one GPC each, so the whole card is never theirs), then as many lanes a
    unit as 512 threads allow, 4 to 32.  B=16 at H=150 gives 48 CTAs of 416
    threads (tiles of 4 rows), B=128 gives 96 CTAs (tiles of 16)."""
    cluster = -(-H // _MAX_UNITS)
    if cluster > _MAX_CLUSTER:
        raise ValueError(f"the LSTM kernels take H <= {_MAX_UNITS * _MAX_CLUSTER}, got H={H}")
    units = -(-H // cluster)
    rows = next((r for r in _ROW_TILES if cluster * -(-B // r) * dirs <= sm_count * 3 // 4),
                _ROW_TILES[-1])
    groups = units * rows // 4
    ks = 32
    while ks > 4 and groups * ks > _MAX_THREADS:
        ks //= 2
    threads = -(-groups * ks // 32) * 32
    # the CTA's slice of w_hh (a float4 a unit and k, rows of an odd number
    # of units) and two buffers of the vector a step multiplies (rows padded
    # as fwd_stride and bwd_stride in csrc/lstm.cu)
    weights = 16 * H * (units | 1)
    fwd_stride = rows + 4 if rows % 8 == 0 else rows
    return Plan(cluster, rows, ks, threads, weights + 8 * H * fwd_stride,
                weights + 8 * H * (4 * rows + 4))


def _check(xw: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor, lens: torch.Tensor) -> None:
    if xw.dim() != 4 or w_hh.dim() != 3 or b_hh.dim() != 2 or lens.dim() != 1:
        raise ValueError(f"expected xw [dirs, B, L, 4H], w_hh [dirs, H, 4H], b_hh [dirs, 4H], "
                         f"lens [B]; got {tuple(xw.shape)}, {tuple(w_hh.shape)}, "
                         f"{tuple(b_hh.shape)}, {tuple(lens.shape)}")
    dirs, H, G = w_hh.shape
    _, B, L, _ = xw.shape
    if (dirs not in (1, 2) or H < 1 or G != 4 * H or tuple(xw.shape) != (dirs, B, L, G)
            or tuple(b_hh.shape) != (dirs, G) or lens.shape[0] != B):
        raise ValueError(f"xw {tuple(xw.shape)}, b_hh {tuple(b_hh.shape)}, lens "
                         f"{tuple(lens.shape)} do not match w_hh {tuple(w_hh.shape)}")
    if B < 1 or L < 1:
        raise ValueError(f"the LSTM takes B >= 1 and L >= 1, got B={B}, L={L}")
    if not (xw.device == w_hh.device == b_hh.device == lens.device):
        raise ValueError(f"LSTM inputs on different devices: {xw.device}, {w_hh.device}, "
                         f"{b_hh.device}, {lens.device}")
    if not (xw.is_contiguous() and w_hh.is_contiguous() and b_hh.is_contiguous()
            and lens.is_contiguous()):
        raise ValueError("the LSTM takes contiguous xw, w_hh, b_hh and lens")
    if not (xw.dtype == w_hh.dtype == b_hh.dtype) or not xw.is_floating_point():
        raise TypeError(f"the LSTM takes one floating type, got {xw.dtype}, {w_hh.dtype}, "
                        f"{b_hh.dtype}")
    if xw.device.type == "cuda":
        if xw.dtype != torch.float32 or lens.dtype != torch.int32:
            raise TypeError(f"the LSTM kernels take float32 inputs and int32 lens, got "
                            f"{xw.dtype}, {lens.dtype}")
        plan(H, B, dirs, 1)  # raises on an H the kernels do not take
    elif xw.device.type == "cpu":
        if lens.dtype.is_floating_point or lens.dtype == torch.bool:
            raise TypeError(f"lens must be integers, got {lens.dtype}")
    else:
        raise ValueError(f"the LSTM runs on cuda or cpu tensors, got {xw.device}")


@functools.cache
def _sm_count(device: int) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _outputs(xw: torch.Tensor, w_hh: torch.Tensor, save: bool):
    """Uninitialised (out, h_n, c_n, gates, cells); gates and cells empty
    unless ``save``."""
    dirs, B, L, G = xw.shape
    H = G // 4
    return (xw.new_empty(B, L, dirs * H), xw.new_empty(dirs, B, H), xw.new_empty(dirs, B, H),
            torch.empty_like(xw) if save else xw.new_empty(0),
            xw.new_empty(B, L, dirs * H) if save else xw.new_empty(0))


def _launch(xw, w_hh, b_hh, lens, save):
    global launches
    outs = _outputs(xw, w_hh, save)
    dirs, B, L, G = xw.shape
    H = G // 4
    p = plan(H, B, dirs, _sm_count(xw.device.index))
    err = _library().mgnns_lstm_forward(
        xw.data_ptr(), w_hh.data_ptr(), b_hh.data_ptr(), lens.data_ptr(),
        *(t.data_ptr() for t in outs), B, L, H, dirs,  # empty gates and cells: null
        p.cluster, p.rows, p.ks, p.threads, p.smem_fwd, xw.device.index, _stream(xw))
    if err != 0:
        raise RuntimeError(f"LSTM forward kernel launch failed: CUDA error {err}")
    launches += 1
    return outs


def _check_backward(gates, cells, w_hh, lens, g_out, g_hn, g_cn) -> None:
    """The backward kernel's inputs: the forward's saves and contiguous
    float32 gradients of its outputs' shapes, on one card."""
    dirs, H, G = w_hh.shape
    B, L, _ = cells.shape
    want = {"gates": (dirs, B, L, G), "cells": (B, L, dirs * H), "g_out": (B, L, dirs * H),
            "g_hn": (dirs, B, H), "g_cn": (dirs, B, H)}
    for name, t in (("gates", gates), ("cells", cells), ("g_out", g_out), ("g_hn", g_hn),
                    ("g_cn", g_cn)):
        if t is not None and (tuple(t.shape) != want[name] or t.dtype != torch.float32
                              or not t.is_contiguous() or t.device != w_hh.device):
            raise ValueError(f"LSTM backward: {name} must be contiguous float32 {want[name]} on "
                             f"{w_hh.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if tuple(lens.shape) != (B,) or lens.dtype != torch.int32 or lens.device != w_hh.device:
        raise ValueError(f"LSTM backward: lens must be int32 ({B},) on {w_hh.device}")


def _launch_bwd(gates, cells, w_hh, lens, g_out, g_hn, g_cn):
    global bwd_launches
    _check_backward(gates, cells, w_hh, lens, g_out, g_hn, g_cn)
    B, L, _ = cells.shape
    dirs, H, _ = w_hh.shape
    dgates = torch.empty_like(gates)
    p = plan(H, B, dirs, _sm_count(gates.device.index))
    err = _library().mgnns_lstm_backward(
        gates.data_ptr(), cells.data_ptr(), w_hh.data_ptr(), lens.data_ptr(),
        _ptr(g_out), _ptr(g_hn), _ptr(g_cn), dgates.data_ptr(), B, L, H, dirs,
        p.cluster, p.rows, p.ks, p.threads, p.smem_bwd, gates.device.index, _stream(gates))
    if err != 0:
        raise RuntimeError(f"LSTM backward kernel launch failed: CUDA error {err}")
    bwd_launches += 1
    return dgates


@functools.cache
def _library() -> ctypes.CDLL:
    from mgnns_tpu_torch.kernels import build

    lib = build.load("lstm")
    fwd = lib.mgnns_lstm_forward
    fwd.restype = ctypes.c_int
    fwd.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
    bwd = lib.mgnns_lstm_backward
    bwd.restype = ctypes.c_int
    bwd.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
    return lib


@torch.library.custom_op(
    "mgnns::lstm_forward", mutates_args=(), device_types="cpu",
    schema="(Tensor xw, Tensor w_hh, Tensor b_hh, Tensor lens, bool save) "
           "-> (Tensor, Tensor, Tensor, Tensor, Tensor)")
def lstm_forward(xw: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor, lens: torch.Tensor,
                 save: bool):
    """One layer's recurrence, every direction, as an operator: (out, h_n,
    c_n, gates, cells).  This registration is the CPU one, the plain
    version."""
    return plain.lstm_layer_plain(xw, w_hh, b_hh, lens, save)


@lstm_forward.register_kernel("cuda")
def _lstm_forward_cuda(xw, w_hh, b_hh, lens, save):
    return _launch(xw, w_hh, b_hh, lens, save)


@lstm_forward.register_fake
def _lstm_forward_fake(xw, w_hh, b_hh, lens, save):
    return _outputs(xw, w_hh, save)


@torch.library.custom_op(
    "mgnns::lstm_backward", mutates_args=(), device_types="cpu",
    schema="(Tensor gates, Tensor cells, Tensor w_hh, Tensor lens, Tensor? g_out, "
           "Tensor? g_hn, Tensor? g_cn) -> Tensor")
def lstm_backward(gates: torch.Tensor, cells: torch.Tensor, w_hh: torch.Tensor,
                  lens: torch.Tensor, g_out: torch.Tensor | None, g_hn: torch.Tensor | None,
                  g_cn: torch.Tensor | None) -> torch.Tensor:
    """The gradient of the gates' pre-activations, ``dgates [dirs, B, L,
    4H]``, as an operator.  This registration is the CPU one, the plain
    reverse recurrence."""
    return plain.lstm_layer_backward_plain(gates, cells, w_hh, lens, g_out, g_hn, g_cn)


@lstm_backward.register_kernel("cuda")
def _lstm_backward_cuda(gates, cells, w_hh, lens, g_out, g_hn, g_cn):
    return _launch_bwd(gates, cells, w_hh, lens, g_out, g_hn, g_cn)


@lstm_backward.register_fake
def _lstm_backward_fake(gates, cells, w_hh, lens, g_out, g_hn, g_cn):
    return torch.empty_like(gates)


def _setup_context(ctx, inputs, output):
    _, w_hh, _, lens, _ = inputs
    out, _, _, gates, cells = output
    ctx.mark_non_differentiable(gates, cells)
    ctx.set_materialize_grads(False)  # an unused output's gradient stays None
    ctx.save_for_backward(w_hh, lens, out, gates, cells)


def _contiguous(g: torch.Tensor | None) -> torch.Tensor | None:
    return None if g is None else g.contiguous()


def _autograd_backward(ctx, g_out, g_hn, g_cn, _g_gates, _g_cells):
    w_hh, lens, out, gates, cells = ctx.saved_tensors
    if gates.numel() != 4 * out.numel():
        raise RuntimeError("the LSTM forward saved no gates: it ran with nothing requiring grad")
    dgates = torch.ops.mgnns.lstm_backward(gates, cells, w_hh, lens, _contiguous(g_out),
                                           _contiguous(g_hn), _contiguous(g_cn))
    B, L, _ = out.shape
    dirs, H, G = w_hh.shape
    dg = dgates.view(dirs, B * L, G)
    # dW_hh = sum over steps of h_{t-1}^T dgates_t: h_{t-1} is the output one
    # step back in each direction's walk (zero before its first step, and
    # after held steps, where the output is 0 and the carry still the initial
    # one).  A product a document (a depth of L), summed over the batch by a
    # reduction: one product over all B * L rows is deep enough for cuBLAS
    # to split its depth in a way that depends on its workspace, and two
    # engines of one process then round it differently
    o = out.view(B, L, dirs, H)
    prev = out.new_zeros(dirs, B, L, H)
    prev[0, :, 1:] = o[:, :-1, 0]
    if dirs == 2:
        prev[1, :, :-1] = o[:, 1:, 1]
    d_w_hh = torch.bmm(prev.view(dirs * B, L, H).transpose(1, 2),
                       dgates.view(dirs * B, L, G)).view(dirs, B, H, G).sum(1)
    return dgates, d_w_hh, dg.sum(1), None, None


lstm_forward.register_autograd(_autograd_backward, setup_context=_setup_context)


# FLOPs for ``FlopCounterMode``, which sees the operators and not what runs
# inside them: the products of h_{t-1} @ w_hh at every step of the forward,
# and in the backward dgates_t @ w_hh^T at every step but the walk's last
# (whose dh no step needs); the backward's dW_hh is the autograd formula's
# own bmm, counted as it runs.
@register_flop_formula(torch.ops.mgnns.lstm_forward)
def _forward_flops(xw_shape, w_hh_shape, *args, out_shape=None, **kwargs) -> int:
    dirs, B, L, G = xw_shape
    return 2 * B * L * dirs * (G // 4) * G


@register_flop_formula(torch.ops.mgnns.lstm_backward)
def _backward_flops(gates_shape, cells_shape, w_hh_shape, *args, out_shape=None,
                    **kwargs) -> int:
    B, L, _ = cells_shape
    dirs, H, G = w_hh_shape
    return 2 * B * (L - 1) * dirs * H * G


def lstm_layer(xw: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor,
               lens: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One layer's recurrence over the input projection of every direction:
    xw [dirs, B, L, 4H] (``x @ w_ih + b_ih`` of each), w_hh [dirs, H, 4H],
    b_hh [dirs, 4H], lens [B] (gate order i, f, g, o; direction 1 walks
    from L - 1).  Returns (out [B, L, dirs*H], h_n [dirs, B, H], c_n
    [dirs, B, H]): the kernel for CUDA tensors (float32, int32 lens), the
    plain loop for CPU tensors.  The gates are saved for the backward only
    when a gradient is wanted."""
    _check(xw, w_hh, b_hh, lens)
    save = torch.is_grad_enabled() and (xw.requires_grad or w_hh.requires_grad
                                        or b_hh.requires_grad)
    out, h_n, c_n, _, _ = torch.ops.mgnns.lstm_forward(xw, w_hh, b_hh, lens, save)
    return out, h_n, c_n
