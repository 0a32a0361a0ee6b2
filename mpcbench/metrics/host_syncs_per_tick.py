"""The host's blocking runtime calls (stream, device and event synchronizes,
synchronous copies) that start inside a ``doa.tick`` span, per tick."""

from mpcbench import spans


def read(tr):
    ticks = spans.intervals(tr, spans.TICK)
    if not ticks:
        return None
    n = sum(1 for s, _ in spans.blocking(tr) if any(a <= s < b for a, b in ticks))
    return n / len(ticks)
