"""Device milliseconds of K1 (ip_solve_kernel, the whole IP solve) per tick."""


def read(tr):
    return tr.ms_per_tick("k1")
