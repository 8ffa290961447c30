"""Multi-process runs: the process group, and each host's share of the data.

Port of the JAX package's ``mgnns_tpu/parallel/multihost.py``.  There one
process per host drives every chip of the host, and the JAX coordination
service joins the hosts.  Here one process drives one card: ``torchrun``
starts a process per card on every node, and ``torch.distributed`` joins
them (NCCL between cards, gloo on the CPU).  A JAX *process* is a *host*,
which here is a ``torchrun`` node: :func:`process_index` and
:func:`process_count` count nodes, and the ranks of a node share its record
slice (:func:`process_batch_slice`), each rank taking its data-axis position
of it (:mod:`mgnns_tpu_torch.parallel.input`).

1. every rank calls :func:`initialize` (a no-op outside ``torchrun``);
2. :func:`mgnns_tpu_torch.parallel.mesh.create_mesh` builds the
   ``('data', 'model')`` mesh over the world;
3. each host loads only its record slice (:func:`process_batch_slice`) and
   every rank runs the same number of steps per epoch
   (:func:`epoch_num_batches`).
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from mgnns_tpu_torch.utils import resolve_device

# what torchrun sets for every rank
_ENV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")


def initialize(backend: str | None = None, device="cuda") -> bool:
    """Join the process group that ``torchrun`` describes (``env://`` from
    ``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE`` and
    ``LOCAL_RANK``) and run one warm-up collective; returns whether a group
    is up.  Without that environment it does nothing and returns False, as
    a single-process run needs no group.

    ``device``: ``cuda`` runs rank ``r`` on ``cuda:{LOCAL_RANK}`` (an
    explicit index, such as ``cuda:0``, is taken as it is) and raises
    without a card; ``cpu`` runs on the host.  ``backend``: NCCL on CUDA and
    gloo on the CPU by default; gloo also takes CUDA tensors, staging them
    through the host, which lets several ranks share one card (NCCL refuses
    two ranks on one device)."""
    if dist.is_initialized():
        return True
    if not all(k in os.environ for k in _ENV):
        return False
    dev = resolve_device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
    dist.init_process_group(backend or ("nccl" if dev.type == "cuda" else "gloo"),
                            init_method="env://")
    # forms the communicator now: a CUDA graph cannot capture its creation
    probe = torch.ones(1, device=dev)
    dist.all_reduce(probe)
    if int(probe.item()) != dist.get_world_size():
        raise RuntimeError(f"warm-up all-reduce gave {probe.item()}, expected "
                           f"{dist.get_world_size()}")
    return True


def _local_world() -> int:
    world = dist.get_world_size()
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if local < 1 or world % local:
        raise ValueError(f"LOCAL_WORLD_SIZE={local} does not divide the world of {world} ranks")
    return local


def process_index() -> int:
    """This rank's host (``torchrun`` node) index; 0 without a group."""
    return dist.get_rank() // _local_world() if dist.is_initialized() else 0


def process_count() -> int:
    """The number of hosts (``torchrun`` nodes); 1 without a group."""
    return dist.get_world_size() // _local_world() if dist.is_initialized() else 1


def process_batch_slice(n_samples: int, batch_size: int) -> tuple[int, int, int]:
    """(start, stop, per_host_batch): this host's contiguous record range and
    its share of the global batch.  The global batch must divide by the host
    count; ranges are balanced to within one record (the first ``n % p``
    hosts get the extra one)."""
    p = process_count()
    i = process_index()
    if batch_size % p:
        raise ValueError(f"process count {p} must divide global batch {batch_size}")
    base, extra = divmod(n_samples, p)
    start = i * base + min(i, extra)
    stop = start + base + (1 if i < extra else 0)
    return start, stop, batch_size // p


def epoch_num_batches(n_samples: int, batch_size: int) -> int:
    """The per-epoch batch count, the same on every host.  Record ranges are
    balanced only to within one record, so hosts can count different
    natural batches (N=101, p=2, B=50: 3 and 2); the rank with the extra
    step would wait forever in its collectives.  Short hosts run all-padding
    (``weight`` 0) batches for the tail steps instead."""
    p = process_count()
    per_host_batch = batch_size // p
    base, extra = divmod(n_samples, p)
    max_host_n = base + (1 if extra else 0)
    return max(1, (max_host_n + per_host_batch - 1) // per_host_batch)
