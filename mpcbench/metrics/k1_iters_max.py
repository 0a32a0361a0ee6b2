"""The mean, over traced K1 launches, of the largest count of iterations
among the launch's rows (K1 writes the count while a profiler records): the
iterations the launch's slowest row needed."""

from mpcbench import spans


def read(tr):
    rows = spans.k1_rows(tr)
    return sum(float(i.max()) for i, _ in rows) / len(rows) if rows else None
