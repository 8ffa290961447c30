"""Share of the published peak of the cell's precision that the traced
stretch's forwards reach: closed-form FLOPs of the records answered in it
(padding rows of a bucket are not counted), over the device's busy seconds
there (at a fixed offered rate the work of a stretch is fixed)."""

from benchmark import flops as F
from benchmark import readers as R


def read(ctx):
    trace = ctx["trace"]
    if trace is None or trace.busy_s <= 0:
        return None
    cfg = ctx["config"]
    per = F.forward_flops(cfg, 1) if cfg["model"] == "fusion" else F.text_forward_flops(cfg, 1)
    return R.mfu(ctx, per, "traced_answered", trace.busy_s)
