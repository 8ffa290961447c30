"""The held experts' share of their roofline: the least time of their
products in a step (the larger of FLOPs over the bf16 peak and bytes over
the HBM bandwidth, from the tokens they got in the window, the program's
``moe.tokens`` per step) over the ``encoder.experts`` stage's device time
per step in the traced epoch."""

from benchmark import flops_moe as FM
from benchmark import marks as M


def read(ctx):
    ms = M.stage_ms(ctx, ("encoder.experts",))
    tokens = ctx["counters"].get("moe_tokens")
    if not ms or not tokens:
        return None
    return 100.0 * FM.routed_least_seconds(ctx["config"], tokens) / (ms / 1e3)
