"""Share of the published bf16 peak that the window's eval epochs reach:
closed-form forward FLOPs of a record x records, over the window's wall
seconds."""

from benchmark import flops as F
from benchmark import readers as R


def read(ctx):
    return R.mfu(ctx, F.forward_flops(ctx["config"], 1), "samples")
