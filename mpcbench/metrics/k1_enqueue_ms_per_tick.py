"""Host milliseconds per tick inside ``doa.solve``, outside blocking runtime
calls: K1's wrapper (cost normalization, the plans, the launch)."""

from mpcbench import spans


def read(tr):
    solve = spans.intervals(tr, spans.SOLVE)
    return spans.per_tick_ms(tr, spans.length(solve) - spans.overlap(solve, spans.blocking(tr)))
