"""Device milliseconds per step of the fusion stage (``mgnns.fusion``: the
cross-attention stacks and the classifier), forward and backward (to the
next mark after its ``.bwd`` mark), from its marks in the traced training
epoch's replays, idle gaps included."""

from benchmark import marks as M


def read(ctx):
    return M.stage_ms(ctx, M.FUSION)
