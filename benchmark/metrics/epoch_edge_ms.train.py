"""Device-idle milliseconds per training epoch outside its replays: the
host's plan and load before the first replay (the window's unprofiled
epochs, from the span ring), plus the traced epoch's wait for its first
kernel and its tail from the last kernel to the end of graphs.readback."""

from benchmark import marks as M


def read(ctx):
    return M.epoch_edge_ms(ctx)
