"""Kernel K1 of the PyTorch port (``doa_mpc_tpu_torch/ops/ip_fused.py``).

The plain PyTorch version is held against the JAX package's XLA solver
``solve_ocp_qp(..., sigma_retry=0.0)``. The JAX fused Pallas kernel cannot
serve as the CPU oracle (its interpret mode is far too slow here), and the
two follow the same algorithm: they differ only in the association order of
the fraction-to-boundary rule and of mu_aff (``tests/test_ip_pallas.py``), so
float64 keeps them within 1e-8 for a few iterations. In float32 the
centering power (mu_aff/mu)^3 amplifies those last-ulp differences, hence the
5e-4 / 2e-3 tolerances of ``tests/test_ip_pallas.py``.

The CUDA source is also compiled here as host C++ with g++ (its solve body
is ``__host__ __device__``) and held against the plain version in float64,
and so is the operation counter built on it (``csrc/op_count.cpp``).
Its launches on a card are tested in ``tests/test_torch_cuda.py``.
"""

import ctypes
import functools
import os
import shutil
import subprocess

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from doa_mpc_tpu.ops.ip_qp import solve_ocp_qp
from doa_mpc_tpu_torch.interop import ocp_qp_from_numpy
from doa_mpc_tpu_torch.ops import ip_fused
from doa_mpc_tpu_torch.ops.ip_fused import (
    GENERIC_STRUCTURE, UNICYCLE_QP_STRUCTURE, QpStructure, solve_ocp_qp_fused,
    solve_ocp_qp_fused_ref)
from doa_mpc_tpu_torch.ops.ocp_qp import OcpQp, normalize_cost
from doa_mpc_tpu_torch.ops.op_count import OpCounter

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "hard_qps_f32.npz")


@functools.lru_cache(maxsize=None)
def _numpy_random_qps(n=4, N=6, M=3, seed=0):
    from test_ip_qp import _make_qp

    rng = np.random.default_rng(seed)
    qps = [_make_qp(rng, N=N, M=M, seed_scale=2.0) for _ in range(n)]
    return OcpQp(*[np.stack([np.asarray(getattr(q, f)) for q in qps])
                   for f in OcpQp._fields])


def random_qps(n, dtype, **kw):
    """``n`` random OCP QPs (``tests/test_ip_qp._make_qp``) as a torch batch."""
    return ocp_qp_from_numpy(_numpy_random_qps(n, **kw), device="cpu", dtype=dtype)


@functools.lru_cache(maxsize=None)
def _numpy_controller_qps(n=4, N=6, M=3):
    """QPs from the JAX controller's build_qp on compat_rng worlds, around a
    perturbed warm start so boxes and soft rows are in play (cached: the
    arrays are only read)."""
    from doa_mpc_tpu.config import SolverOptions, WorldSpec, default_cost_params
    from doa_mpc_tpu.sim.closed_loop import init_loop_state
    from doa_mpc_tpu.sim.compat_rng import mt_experiment_batch
    from doa_mpc_tpu.sim.obstacles import predict_trajectory, robot_start_goal
    from doa_mpc_tpu.solver.sqp_rti import make_rti_controller

    spec = WorldSpec(tf=0.1 * N, n_solv=N, n_obst=M, qp_iter=6)
    ctrl = make_rti_controller(spec, SolverOptions(qp_iter=6, integrator="rk4"),
                               dtype=jnp.float64)
    params = default_cost_params(spec, dtype=jnp.float64)
    start, goal = robot_start_goal(spec)
    obst, _ = mt_experiment_batch(range(n), spec, "RANDOM", 1, dtype=np.float64)
    obst = obst._replace(pos=obst.pos * 0.25 - 5.0)   # obstacles near the start
    st = init_loop_state(jax.random.PRNGKey(0), ctrl, jnp.asarray(start), goal,
                         batch_shape=(n,), obst=obst)
    rng = np.random.default_rng(1)
    rti = st.rti._replace(
        x_traj=st.rti.x_traj + 0.3 * rng.standard_normal(st.rti.x_traj.shape),
        u_traj=st.rti.u_traj + rng.standard_normal(st.rti.u_traj.shape))
    pred = jnp.moveaxis(predict_trajectory(st.obst, spec, N), 0, 1)
    qp = jax.vmap(lambda r, x0, p: ctrl.build_qp(r, x0, goal, p, params))(
        rti, st.x0, pred)
    return OcpQp(*[np.asarray(a) for a in qp])


def _numpy_hard_qps():
    """The fixture's controller QPs that once drove float32 solves
    non-finite (N=20, M=5), as float64."""
    d = np.load(FIXTURE)
    return OcpQp(*[d[f].astype(np.float64) for f in OcpQp._fields])


QP_SETS = {"random": _numpy_random_qps, "controller": _numpy_controller_qps,
           "hard": _numpy_hard_qps}


def _compare(kind, dtype, iters, atol, mu_rtol=None):
    qpn = QP_SETS[kind]()
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    ref = solve_ocp_qp(OcpQp(*[jnp.asarray(a, jdt) for a in qpn]), iters=iters,
                       sigma_retry=0.0)
    sol = solve_ocp_qp_fused_ref(ocp_qp_from_numpy(qpn, "cpu", dtype), iters=iters)
    for f in ("dx", "du", "s"):
        np.testing.assert_allclose(getattr(sol, f).numpy(), np.asarray(getattr(ref, f)),
                                   rtol=0, atol=atol, err_msg=f)
    if mu_rtol is not None:
        np.testing.assert_allclose(sol.mu.numpy(), np.asarray(ref.mu), rtol=mu_rtol)
        np.testing.assert_allclose(sol.kappa.numpy(), np.asarray(ref.kappa), rtol=mu_rtol)
    return sol


@pytest.mark.parametrize("kind", ["random", "controller"])
@pytest.mark.parametrize("iters", [1, 6])
def test_plain_matches_jax_f64(kind, iters):
    _compare(kind, torch.float64, iters, atol=1e-8, mu_rtol=1e-8)


@pytest.mark.parametrize("kind", ["random", "controller"])
def test_plain_matches_jax_f64_converged(kind):
    # near tol = 1e-10 a row's convergence freeze could fall one iteration
    # apart between the two solvers; 1e-6 covers that case
    sol = _compare(kind, torch.float64, 25, atol=1e-6)
    assert float(sol.mu.max()) < 1e-6


@pytest.mark.parametrize("kind", ["random", "controller"])
def test_plain_matches_jax_f32_one_iteration(kind):
    _compare(kind, torch.float32, 1, atol=5e-4)


def test_plain_matches_jax_f32_converged():
    _compare("random", torch.float32, 25, atol=2e-3)


def test_plain_f32_tracks_f64_like_jax_on_controller_qps():
    """On controller QPs (slack weights ~1e6 before normalization) any f32
    interior point lands ~1e-1 from the f64 one after a few iterations: the
    JAX f32 solver does too, and the two f32 solvers drift apart by more than
    2e-3 by iteration 25. So at 25 iterations each is judged against the
    float64 plain solve, by the rule of ``scripts/tpu_equiv_check.py``: the
    port's error is at most max(2x the JAX f32 error, 1e-3)."""
    qpn = _numpy_controller_qps()
    truth = solve_ocp_qp_fused_ref(ocp_qp_from_numpy(qpn, "cpu", torch.float64), iters=25)
    j32 = solve_ocp_qp(OcpQp(*[jnp.asarray(a, jnp.float32) for a in qpn]), iters=25,
                       sigma_retry=0.0)
    p32 = solve_ocp_qp_fused_ref(ocp_qp_from_numpy(qpn, "cpu", torch.float32), iters=25)
    for f in ("dx", "du"):
        want = getattr(truth, f).numpy()
        err_j = np.abs(np.asarray(getattr(j32, f)) - want).max()
        err_p = np.abs(getattr(p32, f).numpy() - want).max()
        assert err_p <= max(2 * err_j, 1e-3), (f, err_p, err_j)


def test_plain_hard_qps_stay_finite():
    d = np.load(FIXTURE)
    qp = OcpQp(*[torch.as_tensor(d[f]) for f in OcpQp._fields])
    assert qp.A.dtype == torch.float32 and qp.A.shape[:2] == (2, 20)
    sol = solve_ocp_qp_fused(qp, iters=int(d["iters"]))
    for a in sol:
        assert torch.isfinite(a).all()


def test_cuda_wrapper_validates_inputs():
    """Shape/dtype checks run before any build or launch."""
    qp = random_qps(2, torch.float64)
    with pytest.raises(TypeError, match="float32"):
        ip_fused._check_cuda_qp(qp)
    qp32 = random_qps(2, torch.float32)
    with pytest.raises(ValueError, match="OcpQp.c"):
        ip_fused._check_cuda_qp(qp32._replace(c=qp32.c[:, :-1]))
    ip_fused._check_cuda_qp(qp32)


MASKS = {"none": lambda nb: torch.zeros(nb, dtype=torch.bool),
         "some": lambda nb: torch.arange(nb) % 2 == 1,
         "all": lambda nb: torch.ones(nb, dtype=torch.bool)}


def _assert_skipped_rows(sol, ref, skip, used=None, want_used=None):
    """``sol`` (solved under ``skip``) against ``ref`` (solved without a
    mask): the kernel's zeros on the skipped rows, the bits of ``ref`` on
    the others; likewise the iteration counts, where given."""
    for f in ("dx", "du", "s", "mu", "stat_res"):
        got, want = getattr(sol, f), getattr(ref, f)
        assert torch.equal(got[~skip], want[~skip]), f
        assert bool((got[skip] == 0).all()), f
    assert torch.equal(sol.kappa, ref.kappa)
    if used is not None:
        assert torch.equal(used, torch.where(skip, 0, want_used))


@pytest.mark.parametrize("mask", MASKS)
@pytest.mark.parametrize("kind", ["controller", "hard"])
def test_plain_skips_the_masked_rows(kind, mask):
    """With a mask the plain version gives the bits it gives without one on
    the unmasked rows, and on the masked rows the kernel's zeros and no
    iteration (``k1.iters`` 0), counting them in ``k1.skipped``."""
    from torch.profiler import ProfilerActivity, profile

    from doa_mpc_tpu_torch.utils import profiling

    qp = ocp_qp_from_numpy(QP_SETS[kind](), "cpu", torch.float32)
    skip = MASKS[mask](qp.A.shape[0])
    profiling.clear_kept()
    with profile(activities=[ProfilerActivity.CPU]):
        ref = solve_ocp_qp_fused_ref(qp, iters=20)
        sol = solve_ocp_qp_fused(qp, iters=20, skip=skip)
    (want_used, used), (skipped,) = profiling.kept("k1.iters"), profiling.kept("k1.skipped")
    profiling.clear_kept()
    _assert_skipped_rows(sol, ref, skip, used, want_used)
    assert int(skipped) == int(skip.sum())


def test_wrapper_validates_the_skip_mask():
    """The mask is bool, one per row, on the QP's device; anything else
    raises before a solve."""
    qp = random_qps(2, torch.float32)
    for bad, err in ((torch.zeros(2, dtype=torch.int32), TypeError),
                     (torch.zeros(3, dtype=torch.bool), ValueError),
                     (torch.zeros(2, 1, dtype=torch.bool), ValueError),
                     (torch.zeros(2, dtype=torch.bool, device="meta"), ValueError)):
        with pytest.raises(err, match="skip"):
            solve_ocp_qp_fused(qp, iters=1, skip=bad)
    assert ip_fused._check_skip(None, qp) is None


def test_wrapper_raises_on_a_structure_without_an_instantiation():
    """Only GENERIC_STRUCTURE (or None) and UNICYCLE_QP_STRUCTURE have a
    kernel instantiation; any other declaration raises, on every device."""
    qp = random_qps(2, torch.float64)
    assert ip_fused.structure_id(None) == ip_fused.structure_id(GENERIC_STRUCTURE) == 0
    assert ip_fused.structure_id(UNICYCLE_QP_STRUCTURE) == 1
    for st in (QpStructure(q_diag=True), UNICYCLE_QP_STRUCTURE._replace(c_cols=(0, 1, 2))):
        with pytest.raises(ValueError, match="no kernel instantiation"):
            solve_ocp_qp_fused(qp, iters=1, structure=st)


_HARNESS = r"""
#include "ip_solve.cu"
extern "C" void host_solve_f64(const double** in, double** out, int B, int N, int M,
                               int iters, double reg, double tau, double tol,
                               double stat_tol, double sigma_max, int structure,
                               int* used, int* end, const bool* skip, int* skipped) {
  ipk::Params<double> p{in[0], in[1], in[2], in[3], in[4], in[5], in[6], in[7], in[8],
                        in[9], in[10], in[11], in[12], in[13], in[14], in[15], in[16],
                        out[0], out[1], out[2], out[3], out[4], B, N, M, iters,
                        reg, tau, tol, stat_tol, sigma_max, used, end, skip, skipped};
  ipk::host_solve<double>(p, structure);
}
template void ipk::host_solve<float>(const ipk::Params<float>&, int);
"""


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no host C++ compiler")
    d = tmp_path_factory.mktemp("host_kernel")
    src = d / "harness.cpp"
    src.write_text(_HARNESS)
    lib = d / "libhost.so"
    subprocess.run([gxx, "-std=c++17", "-O2", "-shared", "-fPIC",
                    "-I", os.path.dirname(ip_fused.KERNEL_SOURCE),
                    "-o", str(lib), str(src)], check=True, timeout=120)
    so = ctypes.CDLL(str(lib))
    so.host_solve_f64.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 4
                                  + [ctypes.c_double] * 5 + [ctypes.c_int]
                                  + [ctypes.c_void_p] * 4)
    return so


def _host_solve(host_kernel, qp, iters, structure, used=None, end=None, skip=None,
                skipped=None):
    """The kernel's body on the host in float64 (one lane walks the rows in
    order): dx, du, s, mu, stat, NaN where it wrote nothing."""
    tol, reg, sigma_max, stat_tol = ip_fused._constants(torch.float64, None, None)
    qpn, _ = normalize_cost(qp)
    nb, N, M = qp.A.shape[0], qp.A.shape[1], qp.C.shape[-2]
    ins = [a.contiguous() for a in qpn]
    f64 = dict(dtype=torch.float64)
    outs = [torch.full((nb, N + 1, 5), np.nan, **f64), torch.full((nb, N, 2), np.nan, **f64),
            torch.full((nb, N + 1, M), np.nan, **f64), torch.full((nb,), np.nan, **f64),
            torch.full((nb,), np.nan, **f64)]
    ptrs = lambda ts: (ctypes.c_void_p * len(ts))(*[t.data_ptr() for t in ts])
    host_kernel.host_solve_f64(ptrs(ins), ptrs(outs), nb, N, M, iters, reg, 0.99, tol,
                               stat_tol, sigma_max, ip_fused.structure_id(structure),
                               *[None if a is None else a.data_ptr()
                                 for a in (used, end, skip, skipped)])
    return outs


def _assert_host_matches_plain(outs, ref, atol=1e-10, mu_rtol=1e-9):
    for got, want in zip(outs[:3], (ref.dx, ref.du, ref.s)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=atol)
    np.testing.assert_allclose(outs[3].numpy(), ref.mu.numpy(), rtol=mu_rtol)
    np.testing.assert_allclose(outs[4].numpy(), ref.stat_res.numpy(), rtol=0, atol=atol)


@pytest.mark.parametrize("structure,kind", [
    (GENERIC_STRUCTURE, "random"), (GENERIC_STRUCTURE, "controller"),
    (UNICYCLE_QP_STRUCTURE, "controller")], ids=["generic-random", "generic-controller",
                                                  "unicycle-controller"])
@pytest.mark.parametrize("iters", [1, 6, 50])
def test_kernel_source_on_host_matches_plain_f64(host_kernel, structure, kind, iters):
    """The kernel's body, built by g++ as one lane per scenario, against the
    plain version in float64, batch-first in and out, for each instantiation
    the QPs satisfy (the controller's QPs carry the unicycle structure)."""
    qp = ocp_qp_from_numpy(QP_SETS[kind](), "cpu", torch.float64)
    outs = _host_solve(host_kernel, qp, iters, structure)
    _assert_host_matches_plain(outs, solve_ocp_qp_fused_ref(qp, iters=iters))


@pytest.mark.parametrize("structure", [GENERIC_STRUCTURE, UNICYCLE_QP_STRUCTURE],
                         ids=["generic", "unicycle"])
@pytest.mark.parametrize("kind", ["controller", "hard"])
def test_kernel_source_on_host_leaves_the_loop_once_a_row_is_frozen(host_kernel, kind,
                                                                   structure):
    """At 100 iterations a row runs the iterations that updated it and the
    one that froze it, and no more: the host's one lane walks the rows in
    order, so row b's run is end[b] - end[b - 1]. Its outputs are still
    those of the plain version, which takes every row through all 100
    (``tests/test_torch_tracing.py`` holds the body's counts of updating
    iterations to the plain version's). The hard rows are ill-conditioned:
    from 50 iterations on, the body and the plain version part there by up
    to 1.5e-8 in dx and 2e-7 of mu in float64, and so did the body that took
    every row through all the iterations (its outputs are this one's, bit
    for bit); so they are held to 1e-7 and 1e-6 of mu."""
    qp = ocp_qp_from_numpy(QP_SETS[kind](), "cpu", torch.float64)
    nb, iters = qp.A.shape[0], 100
    used, end = (torch.full((nb,), -1, dtype=torch.int32) for _ in range(2))
    outs = _host_solve(host_kernel, qp, iters, structure, used, end)
    _assert_host_matches_plain(outs, solve_ocp_qp_fused_ref(qp, iters=iters),
                               **(dict(atol=1e-7, mu_rtol=1e-6) if kind == "hard" else {}))
    run = torch.diff(end, prepend=torch.zeros(1, dtype=torch.int32))
    assert torch.equal(run, torch.clamp_max(used + 1, iters))
    assert int(used.max()) < iters       # every row froze before the cap


@pytest.mark.parametrize("structure", [GENERIC_STRUCTURE, UNICYCLE_QP_STRUCTURE],
                         ids=["generic", "unicycle"])
@pytest.mark.parametrize("mask", MASKS)
@pytest.mark.parametrize("kind", ["controller", "hard"])
def test_kernel_source_on_host_skips_the_masked_rows(host_kernel, kind, mask, structure):
    """Under a mask the kernel's body gives the plain version's outputs under
    the same mask: zeros, 0 iterations and the lane's count so far as
    ``end`` on the masked rows (so their run, end[b] - end[b - 1], is 0), and
    on the others the outputs and counts it gives without the mask. It
    counts the masked rows in ``skipped``."""
    qp = ocp_qp_from_numpy(QP_SETS[kind](), "cpu", torch.float64)
    nb, iters = qp.A.shape[0], 50
    skip = MASKS[mask](nb)
    ints = lambda: torch.full((nb,), -1, dtype=torch.int32)
    used0, end0, used, end = ints(), ints(), ints(), ints()
    skipped = torch.zeros(1, dtype=torch.int32)
    whole = _host_solve(host_kernel, qp, iters, structure, used0, end0)
    outs = _host_solve(host_kernel, qp, iters, structure, used, end, skip, skipped)
    plain = solve_ocp_qp_fused_ref(qp, iters=iters, skip=skip)
    _assert_host_matches_plain(outs, plain, **(dict(atol=1e-7, mu_rtol=1e-6)
                                               if kind == "hard" else {}))
    for got, want in zip(outs, whole):
        assert torch.equal(got[~skip], want[~skip]) and bool((got[skip] == 0).all())
    assert torch.equal(used, torch.where(skip, 0, used0))
    run = torch.diff(end, prepend=torch.zeros(1, dtype=torch.int32))
    want_run = torch.diff(end0, prepend=torch.zeros(1, dtype=torch.int32))
    assert torch.equal(run, torch.where(skip, 0, want_run))
    assert int(skipped) == int(skip.sum())


@pytest.fixture(scope="module")
def op_counter(tmp_path_factory):
    if shutil.which("g++") is None and shutil.which("c++") is None:
        pytest.skip("no host C++ compiler")
    return OpCounter(str(tmp_path_factory.mktemp("op_count")))


@pytest.mark.parametrize("structure", [GENERIC_STRUCTURE, UNICYCLE_QP_STRUCTURE],
                         ids=["generic", "unicycle"])
def test_op_count_of_a_batch_is_the_sum_of_its_scenarios(op_counter, structure):
    """Each scenario is counted on its own graph, whichever thread runs it."""
    qp = ocp_qp_from_numpy(QP_SETS["controller"](), "cpu", torch.float64)
    whole = op_counter.ip_solve(qp, iters=6, structure=structure)
    one_by_one = [op_counter.ip_solve(OcpQp(*[a[b:b + 1] for a in qp]), iters=6,
                                      structure=structure) for b in range(qp.A.shape[0])]
    assert whole == sum(one_by_one) > 0
    assert op_counter.ip_solve(qp, iters=1, structure=structure) < whole


def test_op_count_skips_structure_and_work_a_frozen_row_repeats(op_counter):
    """The unicycle instantiation needs fewer operations than the generic one
    on the same QPs, and a row that freezes (here at once: converged under
    loose tolerances) needs no operation in the iterations after: they
    recompute what the first computed."""
    qp = ocp_qp_from_numpy(QP_SETS["controller"](), "cpu", torch.float64)
    assert (op_counter.ip_solve(qp, 6, UNICYCLE_QP_STRUCTURE)
            < op_counter.ip_solve(qp, 6, GENERIC_STRUCTURE))
    loose = dict(tol=1e30, stat_tol=1e30)
    assert op_counter.ip_solve(qp, 1, **loose) == op_counter.ip_solve(qp, 5, **loose)
    r = [op_counter.riccati(n) for n in (4, 8, 12)]
    assert r[2] - r[1] == r[1] - r[0] > 0     # K2 does the same work at every stage
