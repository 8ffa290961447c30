"""The device mesh, replicated state and a rank's rows of a batch.

Port of the JAX package's ``mgnns_tpu/parallel/mesh.py``.  The mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with the JAX package's
dimensions ``('data', 'model')`` over the world of ranks, one card each,
laid out row-major: rank ``r`` sits at data position ``r // model`` and
model position ``r % model``, so the ranks of one model group are
consecutive (on one host when ``model`` divides the ranks per host).
Batches split over ``'data'``; the parameters split over ``'model'`` by
:mod:`mgnns_tpu_torch.parallel.sharding`'s rules and are replicated over
``'data'``, as are the BatchNorm statistics.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from mgnns_tpu_torch.parallel.collectives import DataAxis, broadcast_
from mgnns_tpu_torch.utils import tree_leaves

# batch fields whose leading axis is the batch dimension
BATCH_FIELDS = {"ids", "lens", "mask", "eids", "label", "weight", "sample_index", "image"}


def create_mesh(data: int = 1, model: int = 1, device="cuda"):
    """A ``('data', 'model')`` mesh of ``data * model`` ranks over the
    process group (:func:`mgnns_tpu_torch.parallel.multihost.initialize`
    first), which must be the world."""
    from torch.distributed.device_mesh import init_device_mesh

    if data < 1 or model < 1:
        raise ValueError(f"mesh axes must be >= 1, got data={data} model={model}")
    if not dist.is_initialized():
        raise RuntimeError("create_mesh needs a process group: start the ranks with torchrun "
                           "and call mgnns_tpu_torch.parallel.multihost.initialize()")
    world = dist.get_world_size()
    if data * model != world:
        raise ValueError(f"a mesh of data {data} x model {model} needs a world of "
                         f"{data * model} ranks, got {world}")
    return init_device_mesh(torch.device(device).type, (data, model),
                            mesh_dim_names=("data", "model"))


def replicate_tree(tree, axis: DataAxis) -> None:
    """Give every rank rank 0's values of a tree's tensors, in place (the
    counterpart of ``shard_pytree(tree, mesh, [])``, which replicates)."""
    leaves = [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]
    if leaves:
        broadcast_(leaves, axis)


def batch_device_put(batch: dict, axis: DataAxis, device) -> dict:
    """This rank's rows of a host batch of the global batch size, on
    ``device``: the batch fields split over the data axis into equal blocks
    in the order of the data positions (``axis.rank`` is this rank's data
    coordinate, which the ranks of one model group share), everything else
    whole.  ``weight_total`` is the global batch's weight sum, the loss's
    normaliser on every rank."""
    out = {}
    for k, v in batch.items():
        v = np.asarray(v)
        if k in BATCH_FIELDS:
            if v.shape[0] % axis.size:
                raise ValueError(f"{k}: batch of {v.shape[0]} rows does not split over "
                                 f"{axis.size} ranks")
            rows = v.shape[0] // axis.size
            v = v[axis.rank * rows:(axis.rank + 1) * rows]
        out[k] = torch.from_numpy(np.ascontiguousarray(v)).to(device)
    if "weight" in batch:
        out["weight_total"] = torch.tensor(float(np.asarray(batch["weight"]).sum()),
                                           device=device)
    return out
