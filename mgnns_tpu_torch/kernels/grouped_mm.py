"""Grouped products over the rows of the held experts, as two operators.

``mgnns::grouped_mm(x [R, K], w [G, K, N], offs [G]) -> [R, N]`` multiplies
each group's rows of ``x`` by its own weight: group ``g`` holds rows
``offs[g-1] <= r < offs[g]`` (``offs[-1]`` before the first), so a product
over all of the experts a chip holds is one call whatever the routing sent
them, and the offsets stay on the device: nothing asks the host how many
rows each group has, so the call can be captured in a CUDA graph.  Rows at
or past ``offs[-1]`` are not computed: their values are unspecified (zeros
on the CPU), and no caller reads them.
``mgnns::grouped_mm_wgrad(x [R, K], dy [R, N], offs) -> [G, K, N]`` is the
weight gradient, each group's ``x^T dy``; the autograd formula of
``grouped_mm`` calls it and ``grouped_mm`` again on the transposed weights.

On the card both run PyTorch's grouped GEMM (``torch._grouped_mm``, CUTLASS
on sm_90), which wants every group's row count times the element size to be
a multiple of 16 bytes in the weight gradient: callers pad each group to
:func:`row_align` rows (:mod:`mgnns_tpu_torch.nn.moe`).  The CPU
registration is the plain version, a loop over the groups.
"""

from __future__ import annotations

import torch

# Python calls since each counter was last reset (a graph replay makes none)
launches = 0        # grouped_mm
wgrad_launches = 0  # grouped_mm_wgrad


def row_align(dtype: torch.dtype) -> int:
    """Rows a group's count is padded to: 16 bytes of ``dtype``."""
    return max(16 // torch.empty((), dtype=dtype).element_size(), 1)


def _bounds(offs: torch.Tensor) -> list[tuple[int, int]]:
    ends = [int(v) for v in offs.tolist()]
    return list(zip([0] + ends[:-1], ends))


@torch.library.custom_op("mgnns::grouped_mm", mutates_args=(), device_types="cpu")
def grouped_mm(x: torch.Tensor, w: torch.Tensor, offs: torch.Tensor) -> torch.Tensor:
    """Each group's rows of ``x`` times its weight.  This registration is
    the CPU one, the plain loop."""
    global launches
    launches += 1
    out = x.new_zeros(x.shape[0], w.shape[2])
    for g, (lo, hi) in enumerate(_bounds(offs)):
        if hi > lo:
            out[lo:hi] = x[lo:hi] @ w[g]
    return out


@grouped_mm.register_kernel("cuda")
def _grouped_mm_cuda(x, w, offs):
    global launches
    launches += 1
    return torch._grouped_mm(x, w, offs=offs)


@grouped_mm.register_fake
def _grouped_mm_fake(x, w, offs):
    return x.new_empty(x.shape[0], w.shape[2])


@torch.library.custom_op("mgnns::grouped_mm_wgrad", mutates_args=(), device_types="cpu")
def grouped_mm_wgrad(x: torch.Tensor, dy: torch.Tensor, offs: torch.Tensor) -> torch.Tensor:
    """Each group's ``x^T dy`` over its rows, ``[G, K, N]`` (zero for an
    empty group).  This registration is the CPU one, the plain loop."""
    global wgrad_launches
    wgrad_launches += 1
    out = x.new_zeros(offs.shape[0], x.shape[1], dy.shape[1])
    for g, (lo, hi) in enumerate(_bounds(offs)):
        if hi > lo:
            out[g] = x[lo:hi].T @ dy[lo:hi]
    return out


@grouped_mm_wgrad.register_kernel("cuda")
def _grouped_mm_wgrad_cuda(x, dy, offs):
    global wgrad_launches
    wgrad_launches += 1
    return torch._grouped_mm(x.T, dy, offs=offs)


@grouped_mm_wgrad.register_fake
def _grouped_mm_wgrad_fake(x, dy, offs):
    return x.new_empty(offs.shape[0], x.shape[1], dy.shape[1])


def _setup_context(ctx, inputs, output):
    x, w, offs = inputs
    ctx.save_for_backward(x, w, offs)


def _backward(ctx, dy):
    x, w, offs = ctx.saved_tensors
    dy = dy.contiguous()
    dx = torch.ops.mgnns.grouped_mm(dy, w.transpose(1, 2), offs) if ctx.needs_input_grad[0] \
        else None
    dw = torch.ops.mgnns.grouped_mm_wgrad(x, dy, offs) if ctx.needs_input_grad[1] else None
    return dx, dw, None


grouped_mm.register_autograd(_backward, setup_context=_setup_context)

