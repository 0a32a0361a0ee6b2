"""The interior-point solver of the PyTorch port (``ops/ip_qp.py``) against
the JAX package's ``solve_ocp_qp(backend="xla")``.

Both port backends are held to it: ``"torch"`` (the plain Riccati sweep,
the counterpart of ``"xla"``) and ``"riccati"`` (kernel K2, whose plain
version runs on CPU tensors; the counterpart of ``"pallas"``). In float64
they follow the same iterates, so 1e-8 holds on unconstrained, box- and
soft-constrained QPs (``tests/test_ip_qp._make_qp``), batched and unbatched,
converged or not. The ``sigma_retry`` and hard-QP regressions of
``tests/test_sigma_retry.py`` and ``RtiController.rti_step`` are ported too.
"""

import functools
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from doa_mpc_tpu.ops.ip_qp import solve_ocp_qp as j_solve
from doa_mpc_tpu.ops.ocp_qp import OcpQp as JQp
from doa_mpc_tpu_torch import interop
from doa_mpc_tpu_torch.ops.ip_qp import solve_ocp_qp
from doa_mpc_tpu_torch.ops.ocp_qp import OcpQp
from doa_mpc_tpu_torch.ops.riccati import riccati_factorize, riccati_solve
from doa_mpc_tpu_torch.ops.riccati_fused import riccati_solve_fused
from test_ip_qp import _make_qp

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "hard_qps_f32.npz")
BACKENDS = ["torch", "riccati"]
KINDS = {"unconstrained": dict(box=False, soft=False), "box": dict(box=True, soft=False),
         "soft": dict(box=True, soft=True)}


@functools.lru_cache(maxsize=None)
def _numpy_qps(kind, n=3, seed=0):
    rng = np.random.default_rng(seed)
    qps = [_make_qp(rng, seed_scale=2.0, **KINDS[kind]) for _ in range(n)]
    return JQp(*[np.stack([np.asarray(getattr(q, f)) for q in qps]) for f in JQp._fields])


def _torch(qpn, dtype=torch.float64):
    return interop.ocp_qp_from_numpy(qpn, "cpu", dtype)


@functools.lru_cache(maxsize=None)
def _jax_solution(kind, iters):
    sol, info = j_solve(JQp(*map(jnp.asarray, _numpy_qps(kind))), iters=iters, debug=True)
    return jax.tree.map(np.asarray, sol), {k: np.asarray(v) for k, v in info.items()}


def _assert_solution_close(sol, want, atol=1e-8):
    for f in ("dx", "du", "s"):
        got = getattr(sol, f).numpy()
        assert got.shape == getattr(want, f).shape, f
        np.testing.assert_allclose(got, getattr(want, f), rtol=0, atol=atol, err_msg=f)
    np.testing.assert_allclose(sol.mu.numpy(), want.mu, rtol=1e-8, atol=1e-14)
    np.testing.assert_allclose(sol.stat_res.numpy(), want.stat_res, rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(sol.kappa.numpy(), want.kappa, rtol=1e-14)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("iters", [1, 30])
@pytest.mark.parametrize("kind", list(KINDS))
def test_matches_jax_xla_f64(kind, iters, backend):
    want, _ = _jax_solution(kind, iters)
    sol = solve_ocp_qp(_torch(_numpy_qps(kind)), iters=iters, backend=backend)
    _assert_solution_close(sol, want)
    if iters == 30:
        assert float(sol.mu.max()) < 1e-9


@pytest.mark.parametrize("backend", BACKENDS)
def test_debug_output_matches_jax(backend):
    _, want = _jax_solution("soft", 30)
    sol, info = solve_ocp_qp(_torch(_numpy_qps("soft")), iters=30, backend=backend,
                             debug=True)
    assert set(info) == {"mu", "stat", "alpha", "sigma"}
    # stat reaches its rounding floor (~1e-13) once converged
    for k, atol in (("mu", 1e-14), ("stat", 1e-10), ("alpha", 1e-10)):
        assert info[k].shape == (30, 3), k
        np.testing.assert_allclose(info[k].numpy(), want[k], rtol=1e-7, atol=atol, err_msg=k)
    # the centering sigma = (mu_aff / mu)^3 amplifies last-ulp differences
    # once mu is near its floor
    np.testing.assert_allclose(info["sigma"].numpy(), want["sigma"], rtol=0, atol=1e-8)
    np.testing.assert_array_equal(info["mu"][-1].numpy(), sol.mu.numpy())


@pytest.mark.parametrize("backend", BACKENDS)
def test_unbatched_call_matches_jax(backend):
    one = JQp(*[a[1] for a in _numpy_qps("soft")])
    want, winfo = j_solve(JQp(*map(jnp.asarray, one)), iters=12, debug=True)
    sol, info = solve_ocp_qp(_torch(one), iters=12, backend=backend, debug=True)
    assert sol.dx.shape == (7, 5) and sol.mu.shape == () and info["mu"].shape == (12,)
    _assert_solution_close(sol, jax.tree.map(np.asarray, want))
    np.testing.assert_allclose(info["alpha"].numpy(), np.asarray(winfo["alpha"]),
                               rtol=1e-7, atol=1e-14)


@pytest.mark.parametrize("backend", BACKENDS)
def test_f32_tracks_jax_f32(backend):
    """f32 after one iteration: the same algorithm in the same dtype."""
    qpn = _numpy_qps("soft")
    want = j_solve(JQp(*[jnp.asarray(a, jnp.float32) for a in qpn]), iters=1)
    sol = solve_ocp_qp(_torch(qpn, torch.float32), iters=1, backend=backend)
    assert sol.dx.dtype == torch.float32
    for f in ("dx", "du", "s"):
        np.testing.assert_allclose(getattr(sol, f).numpy(), np.asarray(getattr(want, f)),
                                   rtol=0, atol=5e-5, err_msg=f)


def test_unconstrained_matches_riccati():
    """Without inequality rows the solve is one LQR (``test_ip_qp``'s
    first check)."""
    qp = _torch(_numpy_qps("unconstrained"))
    sol = solve_ocp_qp(qp, iters=25)
    fac = riccati_factorize(qp.Q, qp.R, qp.S, qp.A, qp.B)
    x_ref, u_ref, _ = riccati_solve(fac, qp.q, qp.r, qp.c, qp.dx0)
    np.testing.assert_allclose(sol.du.numpy(), u_ref.numpy(), atol=2e-6)
    np.testing.assert_allclose(sol.dx.numpy(), x_ref.numpy(), atol=2e-6)


def _f32_batch(qps):
    return OcpQp(*[torch.tensor(np.stack([np.asarray(getattr(q, f)) for q in qps]),
                                dtype=torch.float32) for f in OcpQp._fields])


@pytest.mark.parametrize("backend", BACKENDS)
def test_retry_is_quality_neutral(backend):
    """On QPs that never trip the guard, sigma_retry on and off give
    bit-identical solutions (``test_sigma_retry.py``)."""
    rng = np.random.default_rng(3)
    qp = _f32_batch([_make_qp(rng, N=10, seed_scale=s) for s in (1.0, 3.0)])
    a = solve_ocp_qp(qp, iters=30, sigma_retry=0, backend=backend)
    b = solve_ocp_qp(qp, iters=30, backend=backend)
    np.testing.assert_array_equal(a.dx.numpy(), b.dx.numpy())
    np.testing.assert_array_equal(a.mu.numpy(), b.mu.numpy())
    assert float(a.mu.max()) < 1e-6


@pytest.mark.parametrize("backend", BACKENDS)
def test_per_row_cap_is_isolated(backend):
    """A poisoned row (inf cost gradient, non-finite directions every
    iteration) leaves the healthy row bit-identical with retry on and off,
    and freezes finitely."""
    rng = np.random.default_rng(5)
    good = _make_qp(rng, N=8)
    bad = good._replace(q=good.q.at[0, 0].set(jnp.inf))
    mixed = _f32_batch([good, bad])
    with_retry = solve_ocp_qp(mixed, iters=25, backend=backend)
    no_retry = solve_ocp_qp(mixed, iters=25, sigma_retry=0, backend=backend)
    np.testing.assert_array_equal(with_retry.dx[0].numpy(), no_retry.dx[0].numpy())
    np.testing.assert_array_equal(with_retry.mu[0].numpy(), no_retry.mu[0].numpy())
    assert float(with_retry.mu[0]) < 1e-6
    assert torch.isfinite(with_retry.dx[1]).all()


@pytest.mark.parametrize("backend", BACKENDS)
def test_recorded_hard_qps_recover(backend):
    """The captured hard closed-loop QPs make full interior-point progress
    in f32 (``test_sigma_retry.test_recorded_hard_qps_recover``)."""
    d = np.load(FIXTURE)
    qp = OcpQp(*[torch.as_tensor(d[f]) for f in OcpQp._fields])
    assert qp.A.dtype == torch.float32
    sol = solve_ocp_qp(qp, iters=50, backend=backend)
    assert all(bool(torch.isfinite(a).all()) for a in sol)
    assert float(sol.mu.max()) < 1e-2, sol.mu


def test_cpu_solve_counts_no_kernel_launch():
    before = riccati_solve_fused.launches
    solve_ocp_qp(_torch(_numpy_qps("box")), iters=2, backend="riccati")
    assert riccati_solve_fused.launches == before


def test_rejects_unknown_backend_and_zero_iters():
    qp = _torch(_numpy_qps("box"))
    with pytest.raises(ValueError, match="not ported"):
        solve_ocp_qp(qp, iters=2, backend="xla")
    with pytest.raises(ValueError, match="iters"):
        solve_ocp_qp(qp, iters=0)


def test_rti_step_matches_jax_f64():
    """``RtiController.rti_step`` (reg = ``options.ip_reg``) against the JAX
    package's, vmapped over the same QP inputs."""
    from test_torch_rti import B, N, _pair
    from doa_mpc_tpu.config import default_cost_params as j_params
    from doa_mpc_tpu.sim.closed_loop import init_loop_state as j_init
    from doa_mpc_tpu.sim.compat_rng import mt_experiment_batch
    from doa_mpc_tpu.sim.obstacles import predict_trajectory as j_predict
    from doa_mpc_tpu.sim.obstacles import robot_start_goal

    jc, jspec, tc, _ = _pair()
    params = j_params(jspec, dtype=jnp.float64)
    start, goal = robot_start_goal(jspec)
    obst, _ = mt_experiment_batch(range(B), jspec, "RANDOM", 1, dtype=np.float64)
    obst = obst._replace(pos=obst.pos * 0.25 - 5.0)       # obstacles near the start
    st = j_init(jax.random.PRNGKey(0), jc, jnp.asarray(start), goal,
                batch_shape=(B,), obst=obst)
    rng = np.random.default_rng(6)
    rti = st.rti._replace(
        x_traj=st.rti.x_traj + 0.3 * rng.standard_normal(st.rti.x_traj.shape),
        u_traj=st.rti.u_traj + rng.standard_normal(st.rti.u_traj.shape))
    pred = jnp.moveaxis(j_predict(st.obst, jspec, N), 0, 1)
    want_state, want_u0, want_sol = jax.vmap(
        lambda r, x, p: jc.rti_step(r, x, goal, p, params))(rti, st.x0, pred)

    got_state, got_u0, got_sol = tc.rti_step(
        interop.rti_state_from_numpy(jax.tree.map(np.asarray, rti), "cpu", torch.float64),
        torch.tensor(np.asarray(st.x0)), torch.as_tensor(goal),
        torch.tensor(np.asarray(pred)),
        interop.cost_params_from_numpy(params, "cpu", torch.float64))
    assert got_u0.shape == (B, 2)
    pairs = [("x_traj", got_state.x_traj, want_state.x_traj),
             ("u_traj", got_state.u_traj, want_state.u_traj), ("u0", got_u0, want_u0),
             ("s", got_sol.s, want_sol.s)]
    for name, got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-8,
                                   err_msg=name)
    np.testing.assert_allclose(got_sol.mu.numpy(), np.asarray(want_sol.mu), rtol=1e-6)


def _contiguity_spy(monkeypatch):
    """Replace K2's wrapper inside ``ops/ip_qp.py`` by its plain version
    behind a record of which arguments were not contiguous."""
    from doa_mpc_tpu_torch.ops import ip_qp
    from doa_mpc_tpu_torch.ops.riccati_fused import riccati_solve_fused_ref

    seen = []

    def spy(*args, **kw):
        seen.append([i for i, a in enumerate(args) if not a.is_contiguous()])
        return riccati_solve_fused_ref(*args, **kw)

    monkeypatch.setattr(ip_qp, "riccati_solve_fused", spy)
    return seen


def test_riccati_backend_hands_k2_contiguous_arrays(monkeypatch):
    """Kernel K2 reads its inputs in place and raises on a non-contiguous
    one, so the solver makes S, A and B contiguous once per solve and its
    per-iteration arrays come out contiguous: both on QPs whose dynamics are
    transposed views and on the batched tick's own QPs."""
    from doa_mpc_tpu_torch.config import SolverOptions, WorldSpec
    from doa_mpc_tpu_torch.sim.experiments import run_scenario_batch

    seen = _contiguity_spy(monkeypatch)
    qp = _torch(_numpy_qps("soft"))
    views = qp._replace(A=qp.A.mT.contiguous().mT, S=qp.S.mT.contiguous().mT,
                        B=qp.B.mT.contiguous().mT)
    assert not any(a.is_contiguous() for a in (views.A, views.S, views.B))
    sol = solve_ocp_qp(views, iters=3, backend="riccati")
    want = solve_ocp_qp(qp, iters=3, backend="riccati")
    for g, w in zip(sol, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    spec = WorldSpec(tf=1.0, n_solv=10, n_obst=3, qp_iter=2)
    opts = SolverOptions(qp_iter=2, integrator="rk4", compat_pred_bug=True)
    run_scenario_batch(spec, opts, "RANDOM", n_runs=2, max_iter=2, compat_rng=True,
                       backend="riccati", device="cpu")
    assert len(seen) == 2 * 3 * 2 + 2 * 2 * 2
    assert all(bad == [] for bad in seen), seen
