"""Host milliseconds per tick inside ``doa.tick``, outside ``doa.solve`` and
outside blocking runtime calls: the tick glue's own enqueue time."""

from mpcbench import spans


def read(tr):
    ticks = spans.intervals(tr, spans.TICK)
    away = spans.intervals(tr, spans.SOLVE) + spans.blocking(tr)
    return spans.per_tick_ms(tr, spans.length(ticks) - spans.overlap(ticks, away))
