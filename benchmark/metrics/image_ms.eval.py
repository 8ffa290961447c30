"""Device milliseconds per step of the image stage: the object and place
channels together (``mgnns.object_channel``, ``mgnns.place_channel``),
trunks and label GCNs, from its marks in the traced eval epoch's replays,
idle gaps included."""

from benchmark import marks as M


def read(ctx):
    return M.stage_ms(ctx, M.IMAGE)
