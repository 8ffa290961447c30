"""Share of the traced stretch in which no operation ran on the device."""

from benchmark import readers as R


def read(ctx):
    return R.idle_share(ctx)
