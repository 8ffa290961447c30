"""Host milliseconds of the model's ``mgnns.lstm`` range per forward in the
traced stretch: the BiLSTM's step loop, launched from the host."""


def read(ctx):
    trace = ctx["trace"]
    if trace is None:
        return None
    spans = [(e - s) / 1e3 for name, s, e in trace.host if name == "mgnns.lstm"]
    return sum(spans) / len(spans) if spans else None
