"""The optimizer's chain (:mod:`mgnns_tpu_torch.engine.optim`) on CUDA
leaves as hand-written multi-tensor kernels (``csrc/adam.cu``, which says
how): :func:`sum_squares` takes the clip's global norm in two passes,
:func:`update` runs the rest of the chain, Adam or SGD, over every trained
leaf, and :func:`select` is the nan-guard's guarded copy of other state.

Each launch takes a table of leaves by value: pointers, element counts,
layouts, group factors and each leaf's first chunk (:func:`plan`); a set of
more leaves than a table holds takes more launches.  The chunk size follows
from the set's element count (:func:`chunk_size`), so the fusion model's
several hundred small leaves and a text encoder's billions of elements take
the same algorithm.  A gradient whose layout differs from its parameter's
is read through the channels_last index map when it is one
(:func:`layout`), and is otherwise copied once to match
(:func:`match_layouts`, counted in ``grad_copies``).

The plain version is the ``torch._foreach_*`` chain in ``engine/optim.py``,
which CPU leaves take; here every tensor must be a float32 CUDA tensor of
one card, or the wrapper raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

# kernel launches since each counter was last reset (Python calls; a graph
# replay runs none of them)
launches = 0         # mgnns_adam_update_kernel
norm_launches = 0    # mgnns_adam_sumsq_kernel and its finishing pass
select_launches = 0  # mgnns_adam_select_kernel
# the last update's
leaves = 0           # trained leaves updated
grad_copies = 0      # gradients copied to their parameter's layout (match_layouts)

MAX_UPDATE_LEAVES = 672  # kMaxUpdateLeaves in csrc/adam.cu
MAX_NORM_LEAVES = 1536   # kMaxNormLeaves
MAX_COPIES = 1280        # kMaxCopies
MIN_CHUNK = 4096         # elements of a chunk, a power of two in [MIN_CHUNK, MAX_CHUNK]
MAX_CHUNK = 65536
COPY_CHUNK = 65536       # bytes of a guarded copy's chunk
_MAX_NUMEL = (1 << 31) - (1 << 16)  # the kernels index a leaf in 32 bits


@dataclasses.dataclass(frozen=True)
class Launch:
    first: int   # the launch's leaves: positions [first, stop) of the plan's leaves
    stop: int
    chunks: int  # its blocks
    base: int    # chunks of the launches before it


def chunk_size(total: int, sm_count: int) -> int:
    """Elements of a chunk for a set of ``total`` elements: the largest power
    of two that still gives four chunks an SM, within [MIN_CHUNK,
    MAX_CHUNK]."""
    target = max(total // (4 * sm_count), 1)
    return max(MIN_CHUNK, min(MAX_CHUNK, 1 << (target.bit_length() - 1)))


def plan(sizes: list[int], chunk: int, max_leaves: int
         ) -> tuple[np.ndarray, np.ndarray, list[Launch]]:
    """(the positions of the non-empty ``sizes``, each one's first chunk in
    its launch, the launches): consecutive leaves, at most ``max_leaves`` a
    launch; leaf k's chunks are ``start[k] ..`` of its launch, chunk j
    covering elements ``[j * chunk, (j + 1) * chunk)`` of the leaf."""
    keep = np.array([i for i, n in enumerate(sizes) if n > 0], dtype=np.int64)
    counts = np.array([-(-sizes[i] // chunk) for i in keep], dtype=np.int64)
    start = np.zeros(len(keep), dtype=np.int32)
    out, base = [], 0
    for first in range(0, len(keep), max_leaves):
        stop = min(first + max_leaves, len(keep))
        c = counts[first:stop]
        start[first:stop] = np.cumsum(c) - c
        out.append(Launch(first, stop, int(c.sum()), base))
        base += int(c.sum())
    return keep, start, out


def _dense(t: torch.Tensor) -> bool:
    """Whether ``t``'s elements fill its storage span with no gap or overlap."""
    if t.numel() == 0 or t.is_contiguous():
        return True
    expect = 1
    for stride, size in sorted((st, s) for s, st in zip(t.shape, t.stride()) if s != 1):
        if stride != expect:
            return False
        expect *= size
    return True


def _map(t: torch.Tensor) -> list[tuple[int, int]]:
    """(size, stride) of each dimension longer than one: two tensors of one
    shape with the same map lay out their elements alike."""
    return [(s, st) for s, st in zip(t.shape, t.stride()) if s != 1]


def layout(p: torch.Tensor, g: torch.Tensor) -> int | None:
    """How the kernels read gradient ``g`` of dense parameter ``p``: 0, as
    flat storage like ``p``; ``(I << 16) | H * W``, through the index map of
    a channels_last ``g`` of a contiguous OIHW ``p``; None, neither."""
    if g.shape != p.shape:
        return None
    if g.stride() == p.stride() or _map(g) == _map(p):
        return 0
    if (p.dim() == 4 and p.is_contiguous() and g.is_contiguous(memory_format=torch.channels_last)
            and p.shape[1] < 1 << 16 and p.shape[2] * p.shape[3] < 1 << 16):
        return (p.shape[1] << 16) | (p.shape[2] * p.shape[3])
    return None


def match_layouts(params: list[torch.Tensor], grads: list[torch.Tensor | None]) -> list:
    """``grads`` with each one the kernels cannot read copied once into its
    parameter's layout; sets ``grad_copies``."""
    global grad_copies
    out = list(grads)
    grad_copies = 0
    for i, (p, g) in enumerate(zip(params, grads)):
        if g is not None and layout(p, g) is None:
            out[i] = torch.empty_like(p, dtype=g.dtype).copy_(g)
            grad_copies += 1
    return out


def _check(tensors: list, what: str) -> torch.device:
    """The one CUDA device of float32 ``tensors`` (None entries skipped)."""
    present = [t for t in tensors if t is not None]
    dtypes = {t.dtype for t in present}
    if dtypes - {torch.float32}:
        raise TypeError(f"the optimizer kernels take float32 {what}, got {sorted(map(str, dtypes))}")
    devices = {t.device for t in present}
    if len(devices) > 1:
        raise ValueError(f"the optimizer kernels' {what} lie on several devices: "
                         f"{sorted(map(str, devices))}")
    device = devices.pop() if devices else None
    if device is not None and device.type != "cuda":
        raise ValueError(f"the optimizer kernels run on CUDA tensors, got {what} on {device}")
    for t in present:
        if t.numel() > _MAX_NUMEL or not _dense(t):
            raise ValueError(f"the optimizer kernels take dense {what} of under 2**31 elements, "
                             f"got {tuple(t.shape)} with strides {t.stride()}")
    return device


def _check_ok(ok: torch.Tensor | None, device: torch.device) -> None:
    if ok is not None and (ok.dtype != torch.bool or ok.device != device):
        raise ValueError(f"ok must be a bool tensor on {device}, got {ok.dtype} on {ok.device}")


def _layouts(params, grads) -> list[int]:
    out = []
    for p, g in zip(params, grads):
        cl = 0 if g is None else layout(p, g)
        if cl is None:
            raise ValueError(f"a gradient of shape {tuple(g.shape)} and strides {g.stride()} does "
                             f"not match its parameter's {tuple(p.shape)}, {p.stride()} "
                             f"(match_layouts copies it)")
        out.append(cl)
    return out


@functools.cache
def _sm_count(device: int) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _ptr(t: torch.Tensor | None) -> int:
    return 0 if t is None else t.data_ptr()


def _arr(a: np.ndarray, first: int):
    return a[first:].ctypes.data


def sum_squares(params: list[torch.Tensor], grads: list[torch.Tensor]) -> torch.Tensor:
    """``[sum of the squares of every element of grads, its square root]``,
    a float32 device tensor, in a fixed order whatever the gradients'
    layouts (each read in its parameter's order) and alignment; ``grads``
    as :func:`match_layouts` leaves them."""
    global norm_launches
    device = _check(list(grads), "gradients")
    if device is None:
        raise ValueError("sum_squares needs at least one gradient")
    cls = _layouts(params, grads)
    sizes = [g.numel() for g in grads]
    chunk = chunk_size(sum(sizes), _sm_count(device.index))
    keep, start, launches_ = plan(sizes, chunk, MAX_NORM_LEAVES)
    total = launches_[-1].base + launches_[-1].chunks if launches_ else 0
    partials = torch.empty(max(total, 1), dtype=torch.float32, device=device)
    out = torch.empty(2, dtype=torch.float32, device=device)
    ptrs = np.array([grads[i].data_ptr() for i in keep], dtype=np.int64)
    n = np.array([sizes[i] for i in keep], dtype=np.int32)
    cl = np.array([cls[i] for i in keep], dtype=np.uint32)
    lib, stream = _library(), _stream(device)
    for ln in launches_:
        err = lib.mgnns_adam_sumsq(
            _arr(ptrs, ln.first), _arr(n, ln.first), _arr(start, ln.first), _arr(cl, ln.first),
            ln.stop - ln.first, ln.chunks, chunk, partials.data_ptr() + 4 * ln.base,
            device.index, stream)
        if err != 0:
            raise RuntimeError(f"the norm kernel's launch failed: CUDA error {err}")
        norm_launches += 1
    err = lib.mgnns_adam_sumsq_finish(partials.data_ptr(), total, out.data_ptr(), device.index,
                                      stream)
    if err != 0:
        raise RuntimeError(f"the norm's finishing launch failed: CUDA error {err}")
    norm_launches += 1
    return out


def update(params: list[torch.Tensor], grads: list[torch.Tensor | None],
           mu: list[torch.Tensor] | None, nu: list[torch.Tensor] | None,
           factors: list[float], *, norm: torch.Tensor, clip: float, weight_decay: float,
           bc1: torch.Tensor | None, bc2: torch.Tensor | None, neg_lr: torch.Tensor,
           ok: torch.Tensor | None) -> None:
    """Steps 1-5 of the chain on trained leaves ``params`` in place: the clip
    of ``grads`` (None = zeros; as :func:`match_layouts` leaves them) by
    ``norm`` (a device scalar), weight decay, Adam's moments ``mu`` and
    ``nu`` in place with bias corrections ``bc1``, ``bc2`` (None for all
    four: SGD), each leaf's group factor, ``neg_lr`` = -lr(step).  Where the
    device flag ``ok`` is false nothing is stored."""
    global launches, leaves
    adam = mu is not None
    if len(grads) != len(params) or len(factors) != len(params) or (
            adam and not len(mu) == len(nu) == len(params)):
        raise ValueError(f"{len(params)} parameters, {len(grads)} gradients, {len(factors)} "
                         f"factors, moments {None if mu is None else (len(mu), len(nu))}")
    scalars = [norm, bc1, bc2, neg_lr] if adam else [norm, neg_lr]
    device = _check(list(params) + list(grads) + (list(mu) + list(nu) if adam else []) + scalars,
                    "leaves and scalars")
    _check_ok(ok, device)
    if adam:
        for p, m, v in zip(params, mu, nu):
            if not (m.shape == v.shape == p.shape and (m.stride() == v.stride() == p.stride()
                                                       or _map(m) == _map(v) == _map(p))):
                raise ValueError(f"moments {tuple(m.shape)} / {tuple(v.shape)} laid out unlike "
                                 f"their parameter {tuple(p.shape)}")
    cls = _layouts(params, grads)
    leaves = len(params)
    sizes = [p.numel() for p in params]
    chunk = chunk_size(sum(sizes), _sm_count(device.index))
    keep, start, launches_ = plan(sizes, chunk, MAX_UPDATE_LEAVES)
    ptrs = np.array([[params[i].data_ptr(), _ptr(grads[i]), _ptr(mu[i]) if adam else 0,
                      _ptr(nu[i]) if adam else 0] for i in keep], dtype=np.int64).reshape(-1, 4)
    n = np.array([sizes[i] for i in keep], dtype=np.int32)
    cl = np.array([cls[i] for i in keep], dtype=np.uint32)
    fac = np.array([factors[i] for i in keep], dtype=np.float32)
    lib, stream = _library(), _stream(device)
    for ln in launches_:
        err = lib.mgnns_adam_update(
            _arr(ptrs, ln.first), _arr(n, ln.first), _arr(start, ln.first), _arr(cl, ln.first),
            _arr(fac, ln.first), ln.stop - ln.first, ln.chunks, chunk, norm.data_ptr(),
            _ptr(ok), _ptr(bc1), _ptr(bc2), neg_lr.data_ptr(), clip, weight_decay, int(adam),
            device.index, stream)
        if err != 0:
            raise RuntimeError(f"the optimizer kernel's launch failed: CUDA error {err}")
        launches += 1


def select(olds: list[torch.Tensor], news: list[torch.Tensor], ok: torch.Tensor | None) -> None:
    """``old = new`` where the device flag ``ok`` holds (always for None),
    byte for byte, in one launch a table of tensors; a ``new`` laid out
    unlike its ``old`` is first copied into its layout."""
    global select_launches
    if len(olds) != len(news):
        raise ValueError(f"{len(olds)} targets, {len(news)} sources")
    devices = {t.device for t in list(olds) + list(news)}
    if len(devices) > 1 or any(d.type != "cuda" for d in devices):
        raise ValueError(f"the guarded copy runs on one CUDA device, got "
                         f"{sorted(map(str, devices))}")
    if not olds:
        return
    device = devices.pop()
    _check_ok(ok, device)
    srcs = []
    for old, new in zip(olds, news):
        if old.dtype != new.dtype or old.shape != new.shape or not _dense(old):
            raise ValueError(f"cannot copy {new.dtype} {tuple(new.shape)} into {old.dtype} "
                             f"{tuple(old.shape)} (strides {old.stride()})")
        srcs.append(new if _map(new) == _map(old) else torch.empty_like(old).copy_(new))
    sizes = [t.numel() * t.element_size() for t in olds]
    if max(sizes) > _MAX_NUMEL:
        raise ValueError(f"the guarded copy takes tensors of under 2**31 bytes, got {max(sizes)}")
    keep, start, launches_ = plan(sizes, COPY_CHUNK, MAX_COPIES)
    ptrs = np.array([[olds[i].data_ptr(), srcs[i].data_ptr()] for i in keep],
                    dtype=np.int64).reshape(-1, 2)
    n = np.array([sizes[i] for i in keep], dtype=np.int32)
    lib, stream = _library(), _stream(device)
    for ln in launches_:
        err = lib.mgnns_adam_select(_arr(ptrs, ln.first), _arr(n, ln.first),
                                    _arr(start, ln.first), ln.stop - ln.first, ln.chunks,
                                    COPY_CHUNK, _ptr(ok), device.index, stream)
        if err != 0:
            raise RuntimeError(f"the guarded copy's launch failed: CUDA error {err}")
        select_launches += 1


@functools.cache
def _library() -> ctypes.CDLL:
    from mgnns_tpu_torch.kernels import build

    lib = build.load("adam")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.mgnns_adam_update.restype = i
    lib.mgnns_adam_update.argtypes = [p] * 5 + [i] * 3 + [p] * 5 + [f, f, i, i, p]
    lib.mgnns_adam_sumsq.restype = i
    lib.mgnns_adam_sumsq.argtypes = [p] * 4 + [i] * 3 + [p, i, p]
    lib.mgnns_adam_sumsq_finish.restype = i
    lib.mgnns_adam_sumsq_finish.argtypes = [p, i, p, i, p]
    lib.mgnns_adam_select.restype = i
    lib.mgnns_adam_select.argtypes = [p] * 3 + [i] * 3 + [p, i, p]
    return lib
