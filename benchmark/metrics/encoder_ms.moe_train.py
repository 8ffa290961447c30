"""Device milliseconds per step of the MoE text encoder's four stages
(``encoder.attention``, ``.routing``, ``.experts``, ``.mlp``, every layer),
forward and backward, from their marks in the traced training epoch."""

from benchmark import marks as M

STAGES = ("encoder.attention", "encoder.routing", "encoder.experts", "encoder.mlp")


def read(ctx):
    return M.stage_ms(ctx, STAGES)
