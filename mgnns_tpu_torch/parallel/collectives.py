"""The collectives of the data axis, written out.

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

Every function is a collective: every rank of the axis calls it, in the same
order.  Collectives on the card under NCCL can be captured in a CUDA graph
(:mod:`mgnns_tpu_torch.engine.graphs`); gloo's cannot.
"""

from __future__ import annotations

import dataclasses

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

    @classmethod
    def of(cls, mesh, device) -> "DataAxis":
        group = mesh.get_group("data")
        return cls(group=group, rank=dist.get_rank(group), size=dist.get_world_size(group),
                   device=torch.device(device), backend=str(dist.get_backend(group)))

    @property
    def capturable(self) -> bool:
        """Whether a CUDA graph can hold this axis's collectives (NCCL's)."""
        return self.backend == "nccl"


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
