"""Device milliseconds of K3 (irk_step_kernel, both IRK launches) per tick."""


def read(tr):
    return tr.ms_per_tick("k3")
