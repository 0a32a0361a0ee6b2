"""The median, over the live rows of every traced K1 launch, of the
iterations that updated the row (K1 writes the count while a profiler
records; a converged row keeps its iterate)."""

import numpy as np

from mpcbench import spans


def read(tr):
    rows = spans.k1_rows(tr)
    live = [i[d] for i, d in rows or ()]
    live = np.concatenate([x.numpy() for x in live]) if live else np.zeros(0)
    return float(np.median(live)) if live.size else None
