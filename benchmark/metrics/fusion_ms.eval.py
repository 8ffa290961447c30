"""Device milliseconds per step of the fusion stage (``mgnns.fusion``: the
cross-attention stacks and the classifier), from its marks in the traced
eval epoch's replays, idle gaps included."""

from benchmark import marks as M


def read(ctx):
    return M.stage_ms(ctx, M.FUSION)
