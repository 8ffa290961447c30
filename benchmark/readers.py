"""Shared arithmetic of the per-layer metrics' readers (``metrics/``).

A reader gets ``ctx``: the cell's ``config`` and ``params``, the mix's
``counters`` and the ``trace`` of the traced stretch (None when the run
was not traced).  It returns None where it finds nothing to read.
"""

from __future__ import annotations

import numpy as np

from benchmark import flops as F

K1_KERNEL, K2_KERNEL = "edge_max_fwd_kernel", "edge_max_bwd_kernel"


def mfu(ctx: dict, flops_per_unit: float, units_key: str, seconds: float | None = None):
    """100 x FLOPs of the window's work over (its seconds x the published
    peak of the cell's precision)."""
    c = ctx["counters"]
    units = c.get(units_key)
    seconds = c.get("window_s") if seconds is None else seconds
    if not units or not seconds:
        return None
    return 100.0 * flops_per_unit * units / (seconds * F.PEAK_FLOPS[ctx["params"]["compute_dtype"]])


def roofline(ctx: dict, fragment: str, least_fn):
    """100 x the least time of the traced launches of the kernel named by
    ``fragment`` over their summed device time.  A launch's least time is
    that of its batch's lengths (whole epochs are traced); the mean over
    the epoch's batches stands for each launch found."""
    trace, c = ctx["trace"], ctx["counters"]
    if trace is None or "lens" not in c:
        return None
    found = trace.named(fragment)
    busy = sum(e - s for _, s, e in found) / 1e6
    if not found or busy <= 0:
        return None
    cfg, B = ctx["config"], c["batch"]
    lens = np.asarray(c["lens"])
    least = [least_fn(lens[i:i + B], cfg["max_len"], cfg["emb_size"], cfg["ngram"])
             for i in range(0, len(lens), B)]
    return 100.0 * float(np.mean(least)) * len(found) / busy


def idle_share(ctx: dict):
    trace = ctx["trace"]
    if trace is None or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
