"""The share of rows, over every traced K1 launch, that K1 skipped because
the tick marked them done (K1 counts them while a profiler records, and the
program keeps the count as ``k1.skipped``), in percent of the launches'
rows. None without tick spans, or where the program keeps no such count or
not one per launch."""

from mpcbench import spans


def read(tr):
    if not spans.intervals(tr, spans.TICK):
        return None
    skipped, iters = spans.kept("k1.skipped"), spans.kept("k1.iters")
    if not skipped or len(skipped) != len(iters):
        return None
    return 100.0 * sum(int(s.sum()) for s in skipped) / sum(i.numel() for i in iters)
