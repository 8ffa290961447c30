"""Seconds of the run's graph captures (graphs.capture: each plan shape's
warm-up steps and its capture) that ended before the window, but the
traced split's, which an unprofiled set-up does not capture."""

from benchmark import marks as M


def read(ctx):
    return M.capture_s(ctx)
