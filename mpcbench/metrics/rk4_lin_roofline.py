"""The rk4 linearization's share of its roofline: per ``doa.rk4_lin`` span
the larger of its bytes from shapes (B N rows of x and u in, Phi, A and B
out, float32) over 3.35 TB/s and its operations (a closed-form count,
``mpcbench/rk4_yardstick.py``) over 67 TFLOP/s, over the device time of the
operations enqueued inside the spans, in percent."""

from mpcbench import enqueued, rk4_yardstick, spans


def read(tr):
    got = enqueued.in_span(tr)
    if got is None or not got[1]:
        return None
    rows = tr.rows * tr.config["world"]["n_solv"]
    bound = len(spans.intervals(tr, enqueued.RK4_LIN)) * rk4_yardstick.bound_s(rows)
    return 100.0 * bound / (sum(op[2] for op in got[1]) / 1e6)
