"""Mark kernels: empty one-thread kernels named by a mark's id
(``csrc/mark.cu``), launched on the current stream while a CUDA graph
captures, so that each replay's device trace shows where the stages of the
step begin and end (:mod:`mgnns_tpu_torch.tracing`).

A mark has no plain version: it computes nothing.  On the CPU nothing
launches one, since nothing captures there.
"""

from __future__ import annotations

import ctypes
import functools

import torch


def launch(mark_id: int) -> None:
    """Launch mark ``mark_id`` on the current device's current stream."""
    stream = torch.cuda.current_stream()
    err = _library().mgnns_launch_mark(mark_id, stream.device.index, stream.cuda_stream)
    if err != 0:
        raise RuntimeError(f"mark kernel launch failed: CUDA error {err}")


@functools.cache
def _library() -> ctypes.CDLL:
    from mgnns_tpu_torch.kernels import build

    lib = build.load("mark")
    fn = lib.mgnns_launch_mark
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    return lib
