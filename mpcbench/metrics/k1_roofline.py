"""K1's share of its roofline: per launch, the larger of its bytes over 3.35 TB/s
and its operations (frozen counter, on a seeded sample of the profiled
tick's rows, scaled by the batch) over 67 TFLOP/s, over its device time."""


def read(tr):
    return tr.roofline_pct("k1")
