"""Performance accounting (``doa_mpc_tpu/utils/profiling.py``): the bytes
of kernels K1 and K3, the card's bounds, timing, and the tick's spans. The
kernels' operations are counted by ``ops/op_count.py``.

The bounds model one NVIDIA H100 SXM at its 700 W limit, from NVIDIA's data
sheet: 3.35 TB/s of HBM and 67 TFLOP/s in float32 outside the tensor cores.
A bound is the larger of the bytes a function must move (each input read
once, each output written once) over the memory rate and its operations
over the f32 rate; state it beside the card's power limit, which
:func:`device_label` reads.

Spans and kept tensors exist only while a ``torch.profiler`` records: run
any command under ``torch.profiler.profile`` and the trace holds the tick's
phases (:func:`span`, ``doa.*``) on the clock of its device operations, and
:func:`kept` holds what the tick kept for readers (``k1.iters``, K1's
iterations per row; ``tick.done``, the batched tick's input ``done``, the
i-th one beside the i-th K1 launch). With no profiler recording, a span is
one check of the profiler's flag and a shared object that does nothing, and
nothing is kept. This module imports nothing of the package at import time,
so every module can import it.
"""

from __future__ import annotations

import collections
import subprocess
import time

import torch

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
KEPT_MAX = 1024        # the newest references kept per name


def fused_hbm_bytes(spec, batch: int, structure=None) -> int:
    """Bytes kernel K1 must move for one solve of ``batch`` scenarios
    (float32): the QP entries its instantiation for ``structure`` reads
    (default: the unicycle structure), once, whatever the IP iteration
    count, and dx, du, s, mu, stat written once. The unicycle instantiation
    skips the entries the structure fixes (off-diagonal Q and R, S, the
    zero columns of C, the unit columns of A)."""
    from doa_mpc_tpu_torch.ops.ip_fused import GENERIC_STRUCTURE, UNICYCLE_QP_STRUCTURE

    structure = UNICYCLE_QP_STRUCTURE if structure is None else structure
    if structure not in (GENERIC_STRUCTURE, UNICYCLE_QP_STRUCTURE):
        raise ValueError("K1 has instantiations for GENERIC_STRUCTURE and "
                         "UNICYCLE_QP_STRUCTURE only")
    uni = structure == UNICYCLE_QP_STRUCTURE
    N, M = spec.n_solv, spec.n_obst
    n1 = N + 1
    ins = (N * 5 * (3 if uni else 5) + N * 10 + N * 5 + 5
           + n1 * (5 if uni else 25) + n1 * 5 + N * (2 if uni else 4) + N * 2
           + (0 if uni else N * 10) + N * 4 + n1 * 8
           + n1 * M * (2 if uni else 5) + n1 * M * (2 if uni else 3))
    outs = n1 * 5 + N * 2 + n1 * M + 2
    return 4 * batch * (ins + outs)


def irk_step_bytes(rows: int, stages: int, sensitivities: bool, itemsize: int,
                   nx: int = 5, nu: int = 2) -> int:
    """Bytes kernel K3 must move for one step of ``rows`` rows: x and u read
    once, Phi (and with ``sensitivities`` D, nx (nx + nu) per row) written
    once, and the tableau (s^2 + s)."""
    per_row = nx + nu + nx + (nx * (nx + nu) if sensitivities else 0)
    return itemsize * (rows * per_row + stages * stages + stages)


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the f32 rate, and which of the two it is."""
    t_b, t_o = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def _first_tensor(tree) -> torch.Tensor:
    while not isinstance(tree, torch.Tensor):
        tree = next(iter(tree.values())) if isinstance(tree, dict) else tree[0]
    return tree


def time_fn(fn, state0, reps: int = 10) -> float:
    """Steady-state seconds per call of ``fn`` (state -> state): one warm-up
    call, then ``reps`` chained calls. On a CUDA state, CUDA events around
    the chain on the state's device (the host's enqueue overlaps the card's
    work, as in a rollout); on a CPU state, the host clock."""
    dev = _first_tensor(state0).device
    state = fn(state0)
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            state = fn(state)
        return (time.perf_counter() - t0) / reps
    with torch.cuda.device(dev):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            state = fn(state)
        stop.record()
        stop.synchronize()
    return start.elapsed_time(stop) / 1e3 / reps


def device_label(device) -> str:
    """``nvidia-smi``'s "name, power limit" of a CUDA device (the limit sets
    the card's speed under load), or the device's name otherwise."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return str(dev)
    index = torch.cuda.current_device() if dev.index is None else dev.index
    res = subprocess.run(["nvidia-smi", "-i", str(index),
                          "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# spans and kept tensors, on while a torch.profiler records
# ---------------------------------------------------------------------------

# True while a torch.profiler records (False in its schedule's warm-up)
tracing = torch.autograd._profiler_enabled
# a host-only range: unlike ``record_function``'s user annotation it puts no
# range of its own on the device's timeline, and its keyword values show in
# the trace's args when the profiler records shapes
_range = torch._C._profiler._RecordFunctionFast


class _Off:
    """The span while no profiler records: enters and exits, nothing else."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()
_ticks = 0
_kept: dict = {}


def span(name: str, tick: bool = False):
    """A context manager over one phase of the tick, ``name`` (``doa.*``).

    ``tick=True`` on the span that opens a tick: the tick count (every tick,
    traced or not) advances. While a profiler records, every span is a range
    in its trace whose args carry the current tick's number; otherwise it is
    one shared object that does nothing."""
    global _ticks
    if tick:
        _ticks += 1
    if not tracing():
        return _OFF
    return _range(name, (), {"tick": _ticks})


def keep(name: str, tensor: torch.Tensor) -> None:
    """While a profiler records, keep a reference to ``tensor`` under
    ``name`` (the newest :data:`KEPT_MAX`): no copy, no kernel, no sync."""
    if tracing():
        _kept.setdefault(name, collections.deque(maxlen=KEPT_MAX)).append(tensor)


def kept(name: str) -> list:
    """The tensors kept under ``name``, oldest first."""
    return list(_kept.get(name, ()))


def clear_kept() -> None:
    _kept.clear()
