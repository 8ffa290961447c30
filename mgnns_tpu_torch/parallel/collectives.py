"""The collectives of the data and model axes, written out.

This module has no counterpart in the JAX package.  There a train step is
jitted with the batch sharded ``P('data')``, and XLA inserts every
collective the global batch's function needs without being asked.  Here
each rank runs its own rows of the global batch, and these functions are
the collectives that make N ranks compute what one device computes on the
global batch:

- :func:`sync_batch_norm`: train-mode BatchNorm with the global batch's
  statistics (the forward gathers every rank's float32 mean, variance and
  count; the backward all-reduces the two per-channel gradient sums, as
  ``torch.nn.SyncBatchNorm`` does);
- :func:`all_reduce_sum`: the gradient bucket (every gradient leaf and the
  rank's share of the loss in one flat buffer), and the epoch's confusion
  matrix and eval losses;
- :func:`gather_blocks`: the prediction blocks of the test split;
- :func:`broadcast_`, :func:`barrier`, :func:`all_true`: replicated state,
  coordinated saves and the shared-directory probe.

The model axis holds each sharded parameter as this rank's shard, a plain
tensor (:mod:`mgnns_tpu_torch.parallel.sharding`), and Megatron-style
autograd functions carry its collectives through a forward and a backward:

- :func:`copy_to_model`: the identity forward, an all-reduce of the
  gradient backward; at the input of a column-parallel layer;
- :func:`reduce_from_model`: an all-reduce forward, the identity backward;
  at the output of a row-parallel layer and of a vocab-parallel gather;
- :func:`gather_from_model`: every rank's slice along a dimension forward,
  this rank's slice of the gradient backward (no sum: what follows it is
  replicated);
- :func:`model_sum`: a sum over the axis outside autograd (the clip norm).

Only ``all_reduce`` and ``broadcast`` run: both backends take them on CUDA
tensors, captured (NCCL) or not.

Every function is a collective: every rank of the axis calls it, in the same
order.  Collectives on the card under NCCL can be captured in a CUDA graph
(:mod:`mgnns_tpu_torch.engine.graphs`); gloo's cannot.
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class DataAxis:
    """The ``'data'`` dimension of a mesh as this rank sees it: its process
    group, this rank's position and the number of positions."""

    group: object
    rank: int
    size: int
    device: torch.device
    backend: str

    DIM: ClassVar[str] = "data"

    @classmethod
    def of(cls, mesh, device):
        group = mesh.get_group(cls.DIM)
        return cls(group=group, rank=dist.get_rank(group), size=dist.get_world_size(group),
                   device=torch.device(device), backend=str(dist.get_backend(group)))

    @property
    def capturable(self) -> bool:
        """Whether a CUDA graph can hold this axis's collectives (NCCL's)."""
        return self.backend == "nccl"


class ModelAxis(DataAxis):
    """The ``'model'`` dimension of a mesh as this rank sees it: the ranks
    that hold the shards of one copy of the parameters (consecutive global
    ranks, :func:`mgnns_tpu_torch.parallel.mesh.create_mesh`)."""

    DIM = "model"


def world_axis(device) -> DataAxis:
    """The whole process group as one axis (replicated state and the
    writer's saves under a 2-D mesh)."""
    return DataAxis(group=dist.group.WORLD, rank=dist.get_rank(), size=dist.get_world_size(),
                    device=torch.device(device), backend=str(dist.get_backend()))


def all_reduce_sum(tensors: list[torch.Tensor], axis: DataAxis) -> list[torch.Tensor]:
    """The sums over the axis of ``tensors``, through one flat buffer: one
    collective whatever their number.  Tensors of one dtype are summed in
    it; mixed dtypes go through float64, which holds int64 counts below
    2**53 exactly."""
    dtypes = {t.dtype for t in tensors}
    dtype = dtypes.pop() if len(dtypes) == 1 else torch.float64
    flat = torch.cat([t.reshape(-1).to(dtype) for t in tensors])
    dist.all_reduce(flat, group=axis.group)
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].view(t.shape).to(t.dtype))
        at += t.numel()
    return out


def broadcast_(tensors: list[torch.Tensor], axis: DataAxis, src: int = 0) -> None:
    """Overwrite ``tensors`` with rank ``src``'s values in place, one
    collective per dtype."""
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        dist.broadcast(flat, src=dist.get_global_rank(axis.group, src), group=axis.group)
        at = 0
        for t in group:
            t.copy_(flat[at:at + t.numel()].view(t.shape))
            at += t.numel()


def barrier(axis: DataAxis) -> None:
    """Wait until every rank of the axis reaches this point (an all-reduce:
    the same call under gloo and NCCL)."""
    t = torch.zeros(1, device=axis.device)
    dist.all_reduce(t, group=axis.group)
    t.item()


def all_true(flag: bool, axis: DataAxis) -> bool:
    """Whether ``flag`` holds on every rank."""
    t = torch.tensor([int(bool(flag))], dtype=torch.int64, device=axis.device)
    dist.all_reduce(t, op=dist.ReduceOp.MIN, group=axis.group)
    return bool(t.item())


def gather_blocks(block: torch.Tensor, axis: DataAxis) -> list[torch.Tensor]:
    """Every rank's ``block`` ``[k, m_r]`` (int64, the same ``k`` on every
    rank, ``m_r`` free), in rank order.  Two all-reduces: the widths, then
    the blocks, each in its rank's slot of a zero buffer padded to the
    widest."""
    k, m = block.shape
    widths = torch.zeros(axis.size, dtype=torch.int64, device=axis.device)
    widths[axis.rank] = m
    dist.all_reduce(widths, group=axis.group)
    widths = widths.tolist()
    slots = torch.zeros((axis.size, k, max(max(widths), 1)), dtype=torch.int64,
                        device=axis.device)
    slots[axis.rank, :, :m] = block.to(axis.device)
    dist.all_reduce(slots, group=axis.group)
    return [slots[r, :, :w].cpu() for r, w in enumerate(widths)]


class _SyncBatchNorm(torch.autograd.Function):
    """Train-mode BatchNorm over the global batch; see :func:`sync_batch_norm`."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps: float, axis: DataAxis):
        C = x.shape[1]
        xf = x.float()
        var_l, mean_l = torch.var_mean(xf, dim=(0, 2, 3), unbiased=False)
        # an all-gather of (mean, var) as an all-reduce into this rank's slot:
        # all-reduce is the collective that both backends take, captured or not
        slots = torch.zeros((axis.size, 2, C), dtype=torch.float32, device=x.device)
        slots[axis.rank, 0] = mean_l
        slots[axis.rank, 1] = var_l
        dist.all_reduce(slots, group=axis.group)
        means, vars_ = slots[:, 0], slots[:, 1]
        # every rank counts the same rows: the global moments are the mean of
        # the ranks' means and of their variances about the global mean
        mean = means.mean(dim=0)
        var = (vars_ + (means - mean) ** 2).mean(dim=0)
        invstd = torch.rsqrt(var + eps)
        y = (xf - mean[:, None, None]) * (invstd * scale)[:, None, None] + bias[:, None, None]
        ctx.save_for_backward(x, scale, mean, invstd)
        ctx.axis = axis
        ctx.n = (x.numel() // C) * axis.size
        ctx.mark_non_differentiable(mean, var)
        return y.to(x.dtype), mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, scale, mean, invstd = ctx.saved_tensors
        dyf = dy.float()
        xmu = x.float() - mean[:, None, None]
        sums = torch.stack([dyf.sum(dim=(0, 2, 3)), (dyf * xmu).sum(dim=(0, 2, 3))])
        local_dy, local_dy_xmu = sums[0].clone(), sums[1].clone()
        dist.all_reduce(sums, group=ctx.axis.group)
        n = ctx.n
        dx = None
        if ctx.needs_input_grad[0]:
            k = (invstd * invstd * sums[1] / n)[:, None, None]
            dx = ((dyf - (sums[0] / n)[:, None, None] - xmu * k)
                  * (invstd * scale)[:, None, None]).to(x.dtype)
        # this rank's share of the parameter gradients: the gradient bucket
        # sums the shares over the ranks
        dscale = local_dy_xmu * invstd if ctx.needs_input_grad[1] else None
        dbias = local_dy if ctx.needs_input_grad[2] else None
        return dx, dscale, dbias, None, None


def sync_batch_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float,
                    axis: DataAxis) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, int]:
    """(y, mean, var, n) of train-mode BatchNorm of ``x`` ``[B, C, H, W]``
    over the global batch of ``axis``: ``mean`` and the biased ``var`` are
    the global batch's, float32, and ``n`` its per-channel count.  ``y`` is
    normalized in float32 and rounded once to ``x``'s dtype, as
    ``F.batch_norm`` does.  Every rank's batch must have ``x``'s shape (the
    input plan gives every rank the same rows per step); padding rows enter
    the statistics, as in the JAX package.

    The forward gathers each rank's mean and variance and combines them
    exactly (the variance about the global mean, not ``E[x^2] - mean^2``);
    the backward all-reduces ``sum(dy)`` and ``sum(dy * (x - mean))``.  So a
    train step holds two collectives per BatchNorm layer, one in the
    forward and one in the backward."""
    y, mean, var = _SyncBatchNorm.apply(x, scale, bias, eps, axis)
    return y, mean, var, (x.numel() // x.shape[1]) * axis.size


# ------------------------------------------------------------------ model axis


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis: ModelAxis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.axis.group)
        return g, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis: ModelAxis):
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=axis.group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def gather_cat(x: torch.Tensor, axis, dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` (one shape on every rank) concatenated along
    ``dim`` in rank order: an all-gather as an all-reduce into this rank's
    slot (see :class:`_SyncBatchNorm`), outside autograd."""
    slots = x.new_zeros((axis.size, *x.shape))
    slots[axis.rank] = x
    dist.all_reduce(slots, group=axis.group)
    return torch.cat(slots.unbind(0), dim=dim)


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis: ModelAxis, dim: int):
        ctx.axis, ctx.dim, ctx.n = axis, dim, x.shape[dim]
        return gather_cat(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.axis.rank * ctx.n, ctx.n).contiguous(), None, None


def copy_to_model(x: torch.Tensor, axis: ModelAxis) -> torch.Tensor:
    """``x``, replicated over the model axis, at the input of a
    column-parallel layer: each rank's backward holds the gradient of its
    columns only, and the all-reduce sums them into the input's."""
    return _CopyToModel.apply(x, axis)


def reduce_from_model(x: torch.Tensor, axis: ModelAxis) -> torch.Tensor:
    """The sum over the model axis of every rank's partial ``x`` (a
    row-parallel product, a vocab-parallel gather); its gradient is
    replicated, so each rank takes it as it is."""
    return _ReduceFromModel.apply(x, axis)


def gather_from_model(x: torch.Tensor, axis: ModelAxis, dim: int) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order.  What
    follows is replicated, so every rank's gradient of the whole is the same
    and each keeps its own slice of it: a summing backward would multiply
    it by the axis size."""
    return _GatherFromModel.apply(x, axis, dim)


def model_sum(x: torch.Tensor, axis: ModelAxis) -> torch.Tensor:
    """The sum over the model axis of ``x``, outside autograd."""
    y = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, group=axis.group)
    return y
