"""The device mesh, replicated state and a rank's rows of a batch.

Port of the JAX package's ``mgnns_tpu/parallel/mesh.py``.  The mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with the JAX package's
dimensions ``('data', 'model')`` over the world of ranks, one card each.
This slice of the port takes the data axis: batches split over ``'data'``,
and the parameters, the BatchNorm statistics and the optimizer state are
replicated on every rank.  The model axis (``parallel/sharding.py``'s rules
as DTensor placements) is ``ROADMAP.md`` queue 1 item 6b.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from mgnns_tpu_torch.parallel.collectives import DataAxis, broadcast_
from mgnns_tpu_torch.utils import tree_leaves

MODEL_AXIS = ("the mesh's model axis (sharded tables and projections) is ROADMAP.md queue 1 "
              "item 6b")

# batch fields whose leading axis is the batch dimension
BATCH_FIELDS = {"ids", "lens", "mask", "eids", "label", "weight", "sample_index", "image"}


def create_mesh(data: int = 1, model: int = 1, device="cuda"):
    """A ``('data', 'model')`` mesh of ``data`` ranks over the process group
    (:func:`mgnns_tpu_torch.parallel.multihost.initialize` first).
    ``data`` must equal the world size, and ``model`` must be 1."""
    from torch.distributed.device_mesh import init_device_mesh

    if model != 1:
        raise ValueError(f"model={model}: {MODEL_AXIS}")
    if not dist.is_initialized():
        raise RuntimeError("create_mesh needs a process group: start the ranks with torchrun "
                           "and call mgnns_tpu_torch.parallel.multihost.initialize()")
    world = dist.get_world_size()
    if data != world:
        raise ValueError(f"a data axis of {data} needs a world of {data} ranks, got {world}")
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
    in rank order, everything else whole.  ``weight_total`` is the global
    batch's weight sum, the loss's normaliser on every rank."""
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
