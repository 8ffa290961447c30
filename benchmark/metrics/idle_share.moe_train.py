"""Share of the traced stretch of the MoE encoder's training in which no
operation ran on the device."""

from benchmark import readers as R


def read(ctx):
    return R.idle_share(ctx)
