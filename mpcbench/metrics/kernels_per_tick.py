"""Device kernels per tick, as the profiler names them (the tick glue's
dispatch: forecast, linearization, QP assembly, solve, advance)."""


def read(tr):
    return tr.kernels_per_tick()
