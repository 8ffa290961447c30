"""Device, parameter-tree and profiling helpers."""

from __future__ import annotations

import contextlib

import torch


def resolve_device(device: str | torch.device) -> torch.device:
    """The torch device for ``device``; raises when it names CUDA and no
    card is present (the port never drops to the CPU by itself)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' explicitly to run on the CPU")
    return dev


def tree_map(fn, tree):
    """Apply ``fn`` to every leaf of a tree of dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_to(tree, device: torch.device, copy: bool = False):
    """Move every tensor leaf of a parameter tree to ``device``; ``copy``
    copies leaves that are there already too."""
    return tree_map(lambda t: t.to(device, copy=copy) if isinstance(t, torch.Tensor) else t, tree)


def tree_leaves(tree) -> list:
    """The leaves of a tree in :func:`tree_map`'s order."""
    out: list = []
    tree_map(out.append, tree)
    return out


def tree_unflatten(like, leaves):
    """A tree shaped like ``like`` whose leaves are ``leaves``, in order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def tree_paths(tree, prefix: str = "") -> list[str]:
    """The ``/``-joined key paths of the leaves of a tree, in
    :func:`tree_map`'s order (list items by index)."""
    if isinstance(tree, dict):
        return [p for k, v in tree.items() for p in tree_paths(v, f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree) for p in tree_paths(v, f"{prefix}/{i}")]
    return [prefix]


@contextlib.contextmanager
def torch_profile(log_dir: str | None, device: torch.device):
    """A ``torch.profiler`` trace of the block into ``log_dir`` (a Chrome
    trace per run, by ``tensorboard_trace_handler``, which needs no
    tensorboard), with the card's kernels when ``device`` is CUDA; the
    counterpart of the JAX package's ``jax_profile``.  No trace without a
    ``log_dir``."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield
