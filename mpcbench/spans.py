"""The program's spans and kept counts, read from a traced segment.

While a profiler records, the program wraps each phase of its tick in a
host range named ``doa.*`` (``doa.tick`` around the whole tick, and inside
it ``doa.forecast``, ``doa.build_qp`` with ``doa.linearize``, ``doa.solve``,
``doa.advance`` with ``doa.integrate``), on the clock of the device
operations, and keeps K1's count of iterations per row (``k1.iters``) beside
the tick's input ``done`` (``tick.done``), one of each per K1 launch.

This module is the benchmark's one import of the program besides
``system.py``. It imports only the program's tracing facility
(``doa_mpc_tpu_torch.utils.profiling``) and only reads from it. A program
without spans gives a trace with no ``doa.tick`` span, and every reader
then returns None; a program without kept counts reads as an empty list.

Times are the trace's microseconds; an interval is (start, end).
"""

from __future__ import annotations

from doa_mpc_tpu_torch.utils import profiling

PREFIX = "doa."
TICK, SOLVE = "doa.tick", "doa.solve"
# host runtime calls that wait for the device (cudaMemcpyAsync does not)
BLOCKING = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
            "cudaMemcpy")


def program(tr, name=None) -> list:
    """The program's spans (name, start, end), all or those named ``name``."""
    return [(n, s, s + d) for n, s, d in tr.host
            if n.startswith(PREFIX) and (name is None or n == name)]


def intervals(tr, name) -> list:
    return [(s, e) for _, s, e in program(tr, name)]


def blocking(tr) -> list:
    """The host's blocking runtime calls as intervals."""
    return [(s, s + d) for n, s, d in tr.host if n in BLOCKING]


def union(ivs) -> list:
    """Sorted, disjoint intervals covering the same time."""
    out = []
    for s, e in sorted(ivs):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(iv) for iv in out]


def length(ivs) -> float:
    return sum(e - s for s, e in union(ivs))


def overlap(a, b) -> float:
    """The time that both sets of intervals cover."""
    a, b = union(a), union(b)
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def innermost(tr) -> list:
    """The segment's time cut where a program span starts or ends, each piece
    (start, end, name) with the innermost span that covers it (spans nest on
    the host's one thread: the latest started, of those the first to end)."""
    spans = program(tr)
    cuts = sorted({t for _, s, e in spans for t in (s, e)})
    out = []
    for lo, hi in zip(cuts, cuts[1:]):
        best = None
        for n, s, e in spans:
            if s <= lo and e >= hi and (best is None or (s, -e) > (best[1], -best[2])):
                best = (n, s, e)
        if best is not None:
            out.append((lo, hi, best[0]))
    return out


def kept(name) -> list:
    """The program's kept tensors under ``name`` (empty where it keeps none)."""
    read = getattr(profiling, "kept", None)
    return read(name) if read is not None else []


def per_tick_ms(tr, us):
    """``us`` microseconds per ``doa.tick`` span, in ms; None without ticks."""
    n = len(intervals(tr, TICK))
    return us / 1e3 / n if n else None


def k1_rows(tr):
    """Per traced K1 launch, the rows' counts (int64 on the host) and the
    tick's live rows; None without tick spans, counts, or a ``done`` per
    launch."""
    if not intervals(tr, TICK):
        return None
    iters, done = kept("k1.iters"), kept("tick.done")
    if not iters or len(iters) != len(done):
        return None
    return [(i.long().cpu(), ~d.bool().cpu()) for i, d in zip(iters, done)]
