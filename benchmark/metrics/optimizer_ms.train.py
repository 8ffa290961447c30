"""Device milliseconds per step of the engine's optimizer stage
(engine.optimizer: the nan-guard, the clip, Adam, the statistics' select
and the confusion update), from its marks in the traced training epoch."""

from benchmark import marks as M


def read(ctx):
    return M.stage_ms(ctx, M.OPTIMIZER)
