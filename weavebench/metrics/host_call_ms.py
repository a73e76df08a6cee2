"""Host time a wave spends inside the entry call(s): the mean of the
benchmark's span around them over the traced run's untraced waves."""


def read(ctx):
    ms = ctx["entry_ms"]
    return sum(ms) / len(ms) if ms else None
