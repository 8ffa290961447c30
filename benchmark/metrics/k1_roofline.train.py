"""K1's share of its roofline in the traced training epoch."""

from benchmark import flops as F
from benchmark import readers as R


def read(ctx):
    return R.roofline(ctx, R.K1_KERNEL, F.k1_least_seconds)
