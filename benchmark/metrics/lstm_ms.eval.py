"""Device milliseconds per step of the BiLSTM's stage (``mgnns.lstm``, with
the embedding lookup), from its marks in the traced eval epoch's replays,
idle gaps included."""

from benchmark import marks as M


def read(ctx):
    return M.stage_ms(ctx, M.LSTM)
