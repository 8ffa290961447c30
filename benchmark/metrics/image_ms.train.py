"""Device milliseconds per step of the image stage: the object and place
channels together (``mgnns.object_channel``, ``mgnns.place_channel``),
trunks and label GCNs, forward and backward (to the next mark after its
``.bwd`` mark), from its marks in the traced training epoch's replays, idle
gaps included."""

from benchmark import marks as M


def read(ctx):
    return M.stage_ms(ctx, M.IMAGE)
