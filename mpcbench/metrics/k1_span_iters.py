"""The mean, over traced K1 launches, of the largest count among the
launch's rows of the iterations their tile had run when it was done with
them (K1 writes the count while a profiler records, and the program keeps
it as ``k1.end``): the launch's length in iterations. None where the
program keeps no such count."""

from mpcbench import spans


def read(tr):
    ends = spans.kept("k1.end")
    return sum(float(e.max()) for e in ends) / len(ends) if ends else None
