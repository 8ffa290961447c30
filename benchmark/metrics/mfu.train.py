"""Share of the published bf16 peak that the window's train steps reach:
closed-form FLOPs of a step x steps, over the window's wall seconds."""

from benchmark import flops as F
from benchmark import readers as R


def read(ctx):
    return R.mfu(ctx, F.train_step_flops(ctx["config"], ctx["counters"].get("batch", 0)), "steps")
