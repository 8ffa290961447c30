"""Device milliseconds per step of the held experts' stage
(``encoder.experts``: the dispatch's gather, the grouped products, the
weighted combine), forward and backward, from its marks in the traced
training epoch."""

from benchmark import marks as M


def read(ctx):
    return M.stage_ms(ctx, ("encoder.experts",))
