"""Device-idle milliseconds per tick while the host's innermost ``doa.*``
span was not ``doa.solve``: the exact overlap of the idle intervals with the
times the host spent in the tick glue."""

from mpcbench import spans


def read(tr):
    glue = [(s, e) for s, e, name in spans.innermost(tr) if name != spans.SOLVE]
    return spans.per_tick_ms(tr, spans.overlap(tr.gaps(), glue))
