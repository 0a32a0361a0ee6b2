"""Host milliseconds per tick inside ``doa.rk4_lin``, outside blocking
runtime calls: the enqueue of the rk4 linearization's ``vmap(jacfwd)``.
None without the span, or where the segment's enqueue calls and device
operations do not pair one to one (``mpcbench/enqueued.py``)."""

from mpcbench import enqueued, spans


def read(tr):
    got = enqueued.in_span(tr)
    if got is None:
        return None
    lin = spans.intervals(tr, enqueued.RK4_LIN)
    return (spans.length(lin) - spans.overlap(lin, spans.blocking(tr))) / 1e3 / got[2]
