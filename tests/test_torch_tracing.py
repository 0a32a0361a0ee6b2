"""The tick's spans and K1's per-row iteration count (``utils/profiling.py``),
and the benchmark's readers of them (``mpcbench/spans.py``,
``mpcbench/metrics/``), on the CPU.

With no profiler recording, a span is a shared object that does nothing and
nothing is kept. Under ``torch.profiler`` each tick is one ``doa.tick`` range
with its phases nested inside, every range carrying the tick's number, and
K1's plain version keeps each row's count of the iterations that updated it.
K1's own count on the card is held to the plain version's in
``tests/test_torch_cuda.py``; its body, built as host C++, is held to it
here.
"""

import ctypes
import os
import shutil
import subprocess

import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._pytree import tree_leaves

from doa_mpc_tpu_torch.config import SolverOptions, WorldSpec, default_cost_params
from doa_mpc_tpu_torch.ops import ip_fused
from doa_mpc_tpu_torch.ops.ip_fused import UNICYCLE_QP_STRUCTURE, solve_ocp_qp_fused_ref
from doa_mpc_tpu_torch.ops.ocp_qp import normalize_cost
from doa_mpc_tpu_torch.sim.closed_loop import (
    init_loop_state, make_batched_tick, make_parametric_tick)
from doa_mpc_tpu_torch.sim.obstacles import predict_trajectory, robot_start_goal
from doa_mpc_tpu_torch.solver.sqp_rti import RtiState, make_rti_controller
from doa_mpc_tpu_torch.utils import profiling
from mpcbench import harness, spans
from mpcbench.trace import Trace

F64 = torch.float64
PHASES = ("doa.forecast", "doa.build_qp", "doa.solve", "doa.advance")
INNER = {"doa.linearize": "doa.build_qp", "doa.rk4_lin": "doa.linearize",
         "doa.integrate": "doa.advance"}


@pytest.fixture(autouse=True)
def _empty_store():
    profiling.clear_kept()
    yield
    profiling.clear_kept()


def _setup(nb=3, qp_iter=3, integrator="rk4"):
    spec = WorldSpec(tf=0.6, n_solv=6, n_obst=3, qp_iter=qp_iter)
    opts = SolverOptions(qp_iter=qp_iter, integrator=integrator)
    ctrl = make_rti_controller(spec, opts, dtype=F64, device="cpu")
    params = default_cost_params(spec, dtype=F64, device="cpu")
    start, goal = robot_start_goal(spec)
    gen = torch.Generator().manual_seed(0)
    st = init_loop_state(ctrl, start, goal, "RANDOM", batch_shape=(nb,), generator=gen)
    return spec, ctrl, params, goal, gen, st


def _ticker(kind):
    """Two ticks' worth of a batched (K1's plain version) or a parametric
    tick on a small CPU batch: (state, tick as state -> state)."""
    spec, ctrl, params, goal, gen, st = _setup()
    if kind == "batched":
        return st, make_batched_tick(ctrl, goal, params, backend="fused", generator=gen)
    ptick = make_parametric_tick(ctrl, generator=gen)
    return st, lambda s: ptick(s, goal, params)


@pytest.mark.parametrize("kind", ["batched", "parametric"])
def test_without_a_profiler_a_tick_emits_and_keeps_nothing(kind, monkeypatch):
    opened = []
    monkeypatch.setattr(profiling, "_range", lambda *a: opened.append(a))
    st, tick = _ticker(kind)
    tick(tick(st))
    assert opened == []
    assert profiling.kept("k1.iters") == [] and profiling.kept("tick.done") == []
    off = profiling.span("doa.tick", tick=True)
    assert off is profiling.span("doa.solve") is profiling._OFF
    with off:
        pass


def _program_events(prof):
    return sorted((e for e in prof.events() if e.name.startswith("doa.")),
                  key=lambda e: e.time_range.start)


def _inside(e, p):
    return (p.time_range.start <= e.time_range.start
            and e.time_range.end <= p.time_range.end)


@pytest.mark.parametrize("kind", ["batched", "parametric"])
def test_each_tick_is_one_span_with_its_phases_nested_inside(kind):
    st, tick = _ticker(kind)
    st = tick(st)                                   # warm
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        tick(tick(st))
    evs = _program_events(prof)
    ticks = [e for e in evs if e.name == "doa.tick"]
    assert len(ticks) == 2
    numbers = [t.kwinputs["tick"] for t in ticks]
    assert numbers[1] == numbers[0] + 1
    for t, n in zip(ticks, numbers):
        inside = [e for e in evs if e is not t and _inside(e, t)]
        assert all(e.kwinputs["tick"] == n for e in inside)
        names = [e.name for e in inside]
        # one of each phase, in the tick's order
        assert [x for x in names if x in PHASES] == list(PHASES)
        for child, parent in INNER.items():
            (c,) = [e for e in inside if e.name == child]
            (p,) = [e for e in inside if e.name == parent]
            assert _inside(c, p)
    assert sum(1 for e in evs if not any(_inside(e, t) for t in ticks)) == 0
    kept = profiling.kept("k1.iters")
    assert len(kept) == (2 if kind == "batched" else 0)
    assert len(profiling.kept("tick.done")) == len(profiling.kept("k1.skipped")) == len(kept)


@pytest.mark.parametrize("integrator", ["rk4", "irk"])
def test_rk4_lin_span_lies_inside_linearize_only_in_an_rk4_tick(integrator):
    spec, ctrl, params, goal, gen, st = _setup(integrator=integrator)
    tick = make_batched_tick(ctrl, goal, params, backend="fused", generator=gen)
    st = tick(st)                                   # warm
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tick(tick(st))
    evs = _program_events(prof)
    outer = [e for e in evs if e.name == "doa.linearize"]
    lins = [e for e in evs if e.name == "doa.rk4_lin"]
    assert len(outer) == 2
    assert len(lins) == (2 if integrator == "rk4" else 0)
    assert all(any(_inside(e, p) for p in outer) for e in lins)


def test_rk4_tick_gives_the_same_bits_with_a_profiler_as_without():
    spec, ctrl, params, goal, gen, st = _setup()
    tick = make_batched_tick(ctrl, goal, params, backend="fused")
    g = torch.Generator().manual_seed(5)
    noise = [torch.randn(st.obst.pos.shape, generator=g, dtype=F64) for _ in range(3)]

    def run():
        s = st
        for n in noise:
            s = tick(s, noise=n)
        return tree_leaves(s)

    plain = run()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = run()
    assert any(e.name == "doa.rk4_lin" for e in prof.events())
    assert len(plain) == len(traced) == 12
    assert all(torch.equal(a, b) for a, b in zip(plain, traced))


def test_rk4_yardstick_bound_is_set_by_bytes():
    """The rk4 linearization's bound is its bytes (188 a row) over the
    memory rate: the closed-form operation count stays far under the
    count at which operations would set it."""
    from mpcbench import rk4_yardstick, yardstick

    rows = 131072 * 20
    assert rk4_yardstick.BYTES_PER_ROW == 188
    by_ops = rk4_yardstick.lin_ops(rows) / yardstick.F32_OPS_PER_S
    by_bytes = rk4_yardstick.lin_bytes(rows) / yardstick.HBM_BYTES_PER_S
    assert by_ops < by_bytes / 20 and rk4_yardstick.bound_s(rows) == by_bytes


def _spread_qps(nb=6):
    """A tick's QPs in float64, around warm starts perturbed by a growing
    amount per row, so that rows need different numbers of iterations (at
    the solver's default tolerances: 8, 8, 8, 8, more than 12, 7)."""
    spec, ctrl, params, goal, gen, st = _setup(nb)
    g = torch.Generator().manual_seed(1)
    scale = torch.tensor([0.0, 0.01, 0.1, 0.5, 1.0, 3.0], dtype=F64)[:nb, None, None]
    x = st.rti.x_traj + scale * torch.randn(st.rti.x_traj.shape, generator=g, dtype=F64)
    u = st.rti.u_traj + scale * torch.randn(st.rti.u_traj.shape, generator=g, dtype=F64)
    pred = predict_trajectory(st.obst, spec, spec.n_solv).movedim(0, 1)
    return ctrl.build_qp(RtiState(x, u), st.x0, torch.as_tensor(goal, dtype=F64), pred,
                         params)


def _first_converged(qp, iters):
    """Per row, the first iteration (from 0) whose pre-update iterate met
    ``mu < tol`` and ``stat < stat_tol``, capped at ``iters``: read from the
    plain version's ``mu`` and ``stat``, which after k iterations are those
    of iteration k - 1."""
    tol, _, _, stat_tol = ip_fused._constants(F64, None, None)
    first = torch.full((qp.A.shape[0],), iters, dtype=torch.long)
    for k in range(1, iters + 1):
        sol = solve_ocp_qp_fused_ref(qp, iters=k)
        met = (sol.mu < tol) & (sol.stat_res < stat_tol)
        first = torch.where(met & (first == iters), k - 1, first)
    return first


@pytest.mark.parametrize("iters", [5, 12])
def test_plain_k1_keeps_the_iterations_each_row_needed(iters):
    qp = _spread_qps()
    with profile(activities=[ProfilerActivity.CPU]):
        sol = solve_ocp_qp_fused_ref(qp, iters=iters)
    (used,) = profiling.kept("k1.iters")
    assert used.dtype == torch.int32 and used.shape == sol.mu.shape
    want = _first_converged(qp, iters)
    assert torch.equal(used.long(), want)
    if iters == 12:                     # the rows need different counts, one the cap
        assert len(set(want.tolist())) == 3 and int(want.max()) == iters


_HARNESS = r"""
#include "ip_solve.cu"
extern "C" void host_solve_f64(const double** in, double** out, int* used, int B, int N,
                               int M, int iters, double reg, double tau, double tol,
                               double stat_tol, double sigma_max, int structure) {
  ipk::Params<double> p{in[0], in[1], in[2], in[3], in[4], in[5], in[6], in[7], in[8],
                        in[9], in[10], in[11], in[12], in[13], in[14], in[15], in[16],
                        out[0], out[1], out[2], out[3], out[4], B, N, M, iters,
                        reg, tau, tol, stat_tol, sigma_max, used};
  ipk::host_solve<double>(p, structure);
}
"""


def test_kernel_source_on_host_counts_what_the_plain_version_counts(tmp_path):
    """K1's body, built by g++ as one lane per row, writes the same counts
    as the plain version in float64 (and leaves the buffer alone when it
    gets a null pointer)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no host C++ compiler")
    (tmp_path / "harness.cpp").write_text(_HARNESS)
    lib = tmp_path / "libhost.so"
    subprocess.run([gxx, "-std=c++17", "-O1", "-shared", "-fPIC",
                    "-I", os.path.dirname(ip_fused.KERNEL_SOURCE), "-o", str(lib),
                    str(tmp_path / "harness.cpp")], check=True, timeout=300)
    so = ctypes.CDLL(str(lib))
    so.host_solve_f64.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                                  + [ctypes.c_double] * 5 + [ctypes.c_int])
    qp, iters = _spread_qps(), 12
    tol, reg, sigma_max, stat_tol = ip_fused._constants(F64, None, None)
    ins = [a.contiguous() for a in normalize_cost(qp)[0]]
    nb, N, M = qp.A.shape[0], qp.A.shape[1], qp.C.shape[-2]
    outs = [torch.empty((nb, N + 1, 5), dtype=F64), torch.empty((nb, N, 2), dtype=F64),
            torch.empty((nb, N + 1, M), dtype=F64), torch.empty((nb,), dtype=F64),
            torch.empty((nb,), dtype=F64)]
    ptrs = lambda ts: (ctypes.c_void_p * len(ts))(*[t.data_ptr() for t in ts])
    args = (nb, N, M, iters, reg, 0.99, tol, stat_tol, sigma_max,
            ip_fused.structure_id(UNICYCLE_QP_STRUCTURE))
    used = torch.full((nb,), -1, dtype=torch.int32)
    so.host_solve_f64(ptrs(ins), ptrs(outs), None, *args)
    assert torch.equal(used, torch.full((nb,), -1, dtype=torch.int32))
    so.host_solve_f64(ptrs(ins), ptrs(outs), used.data_ptr(), *args)
    with profile(activities=[ProfilerActivity.CPU]):
        solve_ocp_qp_fused_ref(qp, iters=iters)
    assert torch.equal(used, profiling.kept("k1.iters")[0])


# A hand-built segment (microseconds). Device operations at [0, 10],
# [30, 40], [60, 100]: idle (10, 30) and (40, 60). Two ticks.
_DEVICE = [("k_a", 0.0, 10.0), ("ip_solve_kernel", 30.0, 10.0), ("k_b", 60.0, 40.0)]
_SPANS = [
    ("doa.tick", 5.0, 45.0),          # 5-50
    ("doa.forecast", 6.0, 6.0),       # 6-12
    ("doa.build_qp", 12.0, 8.0),      # 12-20
    ("doa.linearize", 13.0, 2.0),     # 13-15
    ("doa.rk4_lin", 13.25, 1.5),      # 13.25-14.75
    ("doa.solve", 20.0, 15.0),        # 20-35
    ("doa.advance", 36.0, 12.0),      # 36-48
    ("doa.integrate", 40.0, 4.0),     # 40-44
    ("doa.tick", 55.0, 40.0),         # 55-95
    ("doa.solve", 56.0, 10.0),        # 56-66
]
_RUNTIME = [
    ("cudaStreamSynchronize", 8.0, 3.0),      # 8-11, forecast
    ("cudaLaunchKernel", 13.5, 0.3),          # enqueues k_a
    ("cudaMemcpyAsync", 14.0, 0.5),           # not blocking; enqueues ip_solve_kernel
    ("cudaStreamSynchronize", 22.0, 2.0),     # 22-24, inside solve
    ("cudaMemcpy", 70.0, 4.0),                # 70-74, second tick's glue; enqueues k_b
    ("cudaEventSynchronize", 49.0, 3.0),      # 49-52: starts in the first tick
    ("cudaDeviceSynchronize", 96.0, 4.0),     # after the last tick
    ("aten::add", 30.0, 2.0),
]
# blocking calls starting in a tick: 8, 22, 49, 70 -> 4 over 2 ticks
# glue: tick time 45 + 40 = 85, less solve (15 + 10) and blocking outside
# solve inside ticks (8-11: 3, 49-50: 1, 70-74: 4) -> 85 - 25 - 8 = 52 us
# K1's enqueue: solve 25 us less 22-24 (2) -> 23 us
# idle 10-30 in glue except solve 20-30: 10-20 -> 10; idle 40-60: 40-48
# advance (8), 48-50 tick (2), 50-55 no span, 55-56 tick (1), 56-60 solve
# -> 10 + 8 + 2 + 1 = 21 us
# doa.rk4_lin: the three enqueue calls pair with the three device ops in
# order; the two starting in 13.25-14.75 enqueue k_a and ip_solve_kernel,
# 10 + 10 = 20 us of device time; its host time 1.5 us holds no blocking
# call; its bound over B N = 3 x 4 rows is set by bytes: 12 x 188 B / 3.35 TB/s
_LIN_BOUND_S = 12 * 188 / 3.35e12
_EXPECTED = {"host_syncs_per_tick": 2.0, "glue_enqueue_ms_per_tick": 0.026,
             "k1_enqueue_ms_per_tick": 0.0115, "glue_idle_ms_per_tick": 0.0105,
             "k1_iters_p50": 4.0, "k1_iters_max": 54.5,
             "rk4_lin_launches_per_tick": 1.0, "rk4_lin_enqueue_ms_per_tick": 0.00075,
             "rk4_lin_ms_per_tick": 0.01, "rk4_lin_roofline": 100.0 * _LIN_BOUND_S / 20e-6}
NEW = sorted(_EXPECTED)
RK4_LIN = sorted(n for n in _EXPECTED if n.startswith("rk4_lin"))


def _trace(with_spans=True, spans_left_out=(), runtime=(), device=()):
    """The hand-built segment; ``spans_left_out`` names spans it lacks, and
    ``runtime`` and ``device`` are further host calls and device ops."""
    kept = [h for h in _SPANS if with_spans and h[0] not in spans_left_out]
    host = sorted(_RUNTIME + list(runtime) + kept, key=lambda h: h[1])
    ops = sorted(_DEVICE + list(device), key=lambda o: o[1])
    return Trace(ops, host, 2, 100e-6, {"world": {"n_solv": 4}}, 3, None)


def _keep_two_launches():
    with profile(activities=[ProfilerActivity.CPU]):
        for it, done in (([3, 5, 100], [False, False, True]), ([2, 7, 9], [False, True, False])):
            profiling.keep("tick.done", torch.tensor(done))
            profiling.keep("k1.iters", torch.tensor(it, dtype=torch.int32))
    # live rows: 3, 5 and 2, 9 -> median 4; largest per launch 100, 9 -> 54.5


@pytest.mark.parametrize("name", NEW)
def test_reader_gives_its_exact_value_on_a_known_trace(name):
    _keep_two_launches()
    assert harness.reader(name)(_trace()) == pytest.approx(_EXPECTED[name], rel=1e-12)


@pytest.mark.parametrize("name", NEW)
def test_reader_gives_none_without_tick_spans(name):
    _keep_two_launches()
    assert harness.reader(name)(_trace(with_spans=False)) is None


@pytest.mark.parametrize("name", RK4_LIN)
def test_rk4_lin_reader_gives_none_without_its_span_or_a_one_to_one_pairing(name):
    """An IRK tick has no ``doa.rk4_lin``; an enqueue call the reader does
    not know (here a device op with no call), or a call whose op the trace
    lacks, leaves the pairing unknown: each reads None."""
    read = harness.reader(name)
    assert read(_trace(spans_left_out=("doa.rk4_lin",))) is None
    assert read(_trace(device=[("Memset (Device)", 50.0, 1.0)])) is None
    assert read(_trace(runtime=[("cudaMemsetAsync", 57.0, 0.2)])) is None
    assert read(_trace(runtime=[("cudaGetDevice", 57.0, 0.2)])) == pytest.approx(
        _EXPECTED[name], rel=1e-12)


def test_skipped_share_reads_the_rows_k1_skipped_over_the_launches_rows():
    """``k1_skipped_pct``: the rows K1 skipped over all rows of the traced
    launches, in percent; None without tick spans, without the count, or
    without one count per launch."""
    read = harness.reader("k1_skipped_pct")
    with profile(activities=[ProfilerActivity.CPU]):
        for rows, skipped in ((3, 1), (4, 2)):
            profiling.keep("k1.iters", torch.zeros(rows, dtype=torch.int32))
            profiling.keep("k1.skipped", torch.tensor([skipped], dtype=torch.int32))
    assert read(_trace()) == pytest.approx(100.0 * 3 / 7, rel=1e-12)
    assert read(_trace(with_spans=False)) is None
    with profile(activities=[ProfilerActivity.CPU]):
        profiling.keep("k1.iters", torch.zeros(5, dtype=torch.int32))
    assert read(_trace()) is None            # a launch without the count
    profiling.clear_kept()
    assert read(_trace()) is None


def test_innermost_span_and_interval_arithmetic():
    pieces = spans.innermost(_trace())
    assert (13.0, 13.25, "doa.linearize") in pieces and (15.0, 20.0, "doa.build_qp") in pieces
    assert (13.25, 14.75, "doa.rk4_lin") in pieces and (14.75, 15.0, "doa.linearize") in pieces
    assert all(name != "doa.tick" for lo, hi, name in pieces if 20.0 <= lo and hi <= 35.0)
    assert spans.union([(5, 7), (1, 3), (2, 4)]) == [(1, 4), (5, 7)]
    assert spans.overlap([(0, 10)], [(2, 3), (5, 12)]) == 6
    assert spans.length([(0, 2), (1, 3)]) == 3
