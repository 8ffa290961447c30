"""Device milliseconds per step of the text GCN's stage
(``mgnns.text_gcn``), from its marks in the traced eval epoch's replays,
idle gaps included."""

from benchmark import marks as M


def read(ctx):
    return M.stage_ms(ctx, M.TEXT_GCN)
