"""Records a device chunk carries: requests answered in the traced stretch
over K1's launches there (one K1 launch per forward, so per chunk)."""

from benchmark import readers as R


def read(ctx):
    trace = ctx["trace"]
    if trace is None:
        return None
    launches = len(trace.named(R.K1_KERNEL))
    answered = ctx["counters"].get("traced_answered", 0)
    return answered / launches if launches else None
