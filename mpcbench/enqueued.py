"""The device operations that the host enqueued inside a program span.

The batched tick runs on one stream, so the device runs the operations in
the order the host enqueued them: the segment's enqueue calls (kernel
launches, asynchronous copies and fills) in host order pair one to one
with its device operations in start order. A span's device operations are
those whose call started inside it. Where the two counts differ, some call
is not named in :data:`ENQUEUE` (or an operation has no call), the pairing
is not known, and nothing is read.

Like :mod:`mpcbench.spans`, it reads only the trace; a program without the
span gives None.
"""

from __future__ import annotations

from mpcbench import spans

RK4_LIN = "doa.rk4_lin"
# runtime calls that put one operation on the device's stream (a traced
# segment of the batched tick on the card holds the first three only)
ENQUEUE = ("cudaLaunchKernel", "cudaMemcpyAsync", "cudaMemsetAsync", "cudaLaunchKernelExC",
           "cudaMemcpy")


def calls(tr) -> list:
    """The segment's enqueue calls as (name, start, dur), in host order."""
    return [h for h in tr.host if h[0] in ENQUEUE]


def in_span(tr, name=RK4_LIN):
    """(calls, ops, ticks): the enqueue calls that start inside the spans
    named ``name``, their device operations, and the segment's tick count;
    None without ticks, without the span, or where the segment's enqueue
    calls and device operations do not pair one to one."""
    ticks, inside = spans.intervals(tr, spans.TICK), spans.intervals(tr, name)
    every = calls(tr)
    if not ticks or not inside or len(every) != len(tr.ops):
        return None
    pairs = [(c, op) for c, op in zip(every, tr.ops)
             if any(a <= c[1] < b for a, b in inside)]
    return [c for c, _ in pairs], [op for _, op in pairs], len(ticks)
