"""Enqueue calls (kernel launches, asynchronous copies and fills) that start
inside ``doa.rk4_lin``, the rk4 linearization's ``vmap(jacfwd)``, per tick.
None without the span, or where the segment's enqueue calls and device
operations do not pair one to one (``mpcbench/enqueued.py``)."""

from mpcbench import enqueued


def read(tr):
    got = enqueued.in_span(tr)
    return len(got[0]) / got[2] if got else None
