"""Device milliseconds per step of the engine's optimizer stage
(``engine.optimizer``) with the MoE text encoder's 2.7 B parameters, from
its marks in the traced training epoch."""

from benchmark import marks as M


def read(ctx):
    return M.stage_ms(ctx, M.OPTIMIZER)
