"""Device milliseconds per tick of the operations enqueued inside
``doa.rk4_lin`` (the rk4 linearization), each paired with its enqueue call
by order on the tick's one stream (``mpcbench/enqueued.py``); None without
the span or where the pairing is not one to one."""

from mpcbench import enqueued


def read(tr):
    got = enqueued.in_span(tr)
    return sum(op[2] for op in got[1]) / 1e3 / got[2] if got else None
