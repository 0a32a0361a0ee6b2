"""RK4, the linearization and the batched QP assembly of the PyTorch port
against the JAX package (``jax.jacfwd`` / ``vmap(build_qp)``) in float64 at
atol 1e-12 (1e-10 with the IRK integrator), with the native C++
``rk4_sens`` as a third oracle."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from doa_mpc_tpu import native
from doa_mpc_tpu.config import SolverOptions as JOptions, WorldSpec as JSpec
from doa_mpc_tpu.config import default_cost_params as j_params
from doa_mpc_tpu.models.unicycle import dynamics as j_dynamics
from doa_mpc_tpu.ops.integrators import rk4_step as j_rk4
from doa_mpc_tpu.sim.closed_loop import init_loop_state as j_init
from doa_mpc_tpu.sim.compat_rng import mt_experiment_batch
from doa_mpc_tpu.sim.obstacles import predict_trajectory as j_predict
from doa_mpc_tpu.sim.obstacles import robot_start_goal
from doa_mpc_tpu.solver.sqp_rti import make_rti_controller as j_make
from doa_mpc_tpu_torch import interop
from doa_mpc_tpu_torch.config import SolverOptions, WorldSpec, default_cost_params
from doa_mpc_tpu_torch.models.unicycle import dynamics
from doa_mpc_tpu_torch.ops.integrators import rk4_step
from doa_mpc_tpu_torch.ops.ocp_qp import OcpQp
from doa_mpc_tpu_torch.solver.sqp_rti import (
    UNICYCLE_QP_STRUCTURE, RtiState, make_rti_controller)

ATOL = 1e-12
N, M, B = 6, 3, 4


def _pair(init_guess="current", integrator="rk4"):
    jspec = JSpec(tf=0.1 * N, n_solv=N, n_obst=M, qp_iter=6)
    jopts = JOptions(qp_iter=6, integrator=integrator, init_guess=init_guess)
    spec = WorldSpec(tf=0.1 * N, n_solv=N, n_obst=M, qp_iter=6)
    opts = SolverOptions(qp_iter=6, integrator=integrator, init_guess=init_guess)
    return (j_make(jspec, jopts, dtype=jnp.float64), jspec,
            make_rti_controller(spec, opts, dtype=torch.float64, device="cpu"), spec)


def _states(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B * N, 5)) * np.array([3, 3, 2, 2, 1])
    u = rng.standard_normal((B * N, 2)) * 3
    return x, u


def test_rk4_step_matches_jax():
    x, u = _states()
    want = j_rk4(j_dynamics, jnp.asarray(x), jnp.asarray(u), 0.1, substeps=2)
    got = rk4_step(dynamics, torch.as_tensor(x), torch.as_tensor(u), 0.1, substeps=2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


def test_lin_matches_jacfwd_and_native():
    jc, _, tc, _ = _pair()
    x, u = _states(1)
    phi_j, A_j, B_j = jc.lin(jnp.asarray(x), jnp.asarray(u))
    phi, A, Bm = tc.lin(torch.as_tensor(x).reshape(B, N, 5),
                        torch.as_tensor(u).reshape(B, N, 2))
    for got, want in ((phi, phi_j), (A, A_j), (Bm, B_j)):
        np.testing.assert_allclose(got.reshape(want.shape).numpy(), np.asarray(want),
                                   rtol=0, atol=ATOL)
    # x/y columns of A are exactly the identity (UNICYCLE_QP_STRUCTURE)
    eye = np.eye(5)
    for j in (0, 1):
        np.testing.assert_array_equal(A[..., :, j].numpy(),
                                      np.broadcast_to(eye[:, j], A.shape[:-1]))
    if not native.available():
        pytest.skip("native rk4_sens library unavailable")
    for i in range(0, B * N, 5):
        phi_n, A_n, B_n = native.rk4_sens(x[i], u[i], 0.1)
        np.testing.assert_allclose(phi.reshape(-1, 5)[i].numpy(), phi_n, rtol=0, atol=ATOL)
        np.testing.assert_allclose(A.reshape(-1, 5, 5)[i].numpy(), A_n, rtol=0, atol=ATOL)
        np.testing.assert_allclose(Bm.reshape(-1, 5, 2)[i].numpy(), B_n, rtol=0, atol=ATOL)


def _qps(seed, integrator="rk4"):
    """The same QP assembly in both packages, on compat_rng worlds and a
    perturbed warm start."""
    jc, jspec, tc, spec = _pair(integrator=integrator)
    params = j_params(jspec, dtype=jnp.float64)
    start, goal = robot_start_goal(jspec)
    obst, _ = mt_experiment_batch(range(seed, seed + B), jspec, "RANDOM", 1,
                                  dtype=np.float64)
    st = j_init(jax.random.PRNGKey(0), jc, jnp.asarray(start), goal,
                batch_shape=(B,), obst=obst)
    rng = np.random.default_rng(seed)
    rti = st.rti._replace(
        x_traj=st.rti.x_traj + 0.5 * rng.standard_normal(st.rti.x_traj.shape),
        u_traj=st.rti.u_traj + rng.standard_normal(st.rti.u_traj.shape))
    x0 = st.x0 + 0.2 * rng.standard_normal(st.x0.shape)
    pred = jnp.moveaxis(j_predict(st.obst, jspec, N), 0, 1)
    jqp = jax.jit(jax.vmap(lambda r, x, p: jc.build_qp(r, x, goal, p, params)))(rti, x0, pred)
    tqp = tc.build_qp(interop.rti_state_from_numpy(jax.tree.map(np.asarray, rti), "cpu",
                                                   torch.float64),
                      torch.tensor(np.asarray(x0)),
                      torch.as_tensor(goal),
                      torch.tensor(np.asarray(pred)),
                      interop.cost_params_from_numpy(params, "cpu", torch.float64))
    return jqp, tqp


@pytest.mark.parametrize("seed", [0, 8])
def test_build_qp_matches_jax(seed):
    jqp, tqp = _qps(seed)
    assert isinstance(tqp, OcpQp)
    for name in OcpQp._fields:
        want, got = np.asarray(getattr(jqp, name)), getattr(tqp, name).numpy()
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL * max(1.0, np.abs(want).max()),
                                   err_msg=name)


@pytest.mark.parametrize("seed", [0, 8])
def test_build_qp_irk_matches_jax(seed):
    """With the default integrator (4-stage Gauss-Legendre IRK, 3 Newton
    iterations) the dynamics rows come from the IFT sensitivities. The x/y
    columns of A stay exactly the identity, as UNICYCLE_QP_STRUCTURE
    declares to kernel K1."""
    jqp, tqp = _qps(seed, integrator="irk")
    for name in OcpQp._fields:
        want, got = np.asarray(getattr(jqp, name)), getattr(tqp, name).numpy()
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-10 * max(1.0, np.abs(want).max()),
                                   err_msg=name)
    eye = np.eye(5)
    for j in UNICYCLE_QP_STRUCTURE.a_unit_cols:
        np.testing.assert_array_equal(tqp.A[..., :, j].numpy(),
                                      np.broadcast_to(eye[:, j], tqp.A.shape[:-1]))


def test_build_qp_satisfies_declared_unicycle_structure():
    """The port's copy of the JAX contract test: the entries the structure
    declares trivial are exact zeros / exact identity columns."""
    _, qp = _qps(3)
    ST = UNICYCLE_QP_STRUCTURE
    nx = qp.A.shape[-1]
    assert ST.q_diag and ST.r_diag and ST.s_zero and ST.zl_eq_zl2
    np.testing.assert_array_equal(qp.Q.numpy() * (1 - np.eye(nx)), 0.0)
    np.testing.assert_array_equal(qp.R.numpy() * (1 - np.eye(qp.R.shape[-1])), 0.0)
    np.testing.assert_array_equal(qp.S.numpy(), 0.0)
    np.testing.assert_array_equal(qp.zl.numpy(), qp.Zl.numpy())
    dropped = [j for j in range(nx) if j not in ST.c_cols]
    np.testing.assert_array_equal(qp.C[..., dropped].numpy(), 0.0)
    eye = np.eye(nx)
    for j in ST.a_unit_cols:
        np.testing.assert_array_equal(qp.A[..., :, j].numpy(),
                                      np.broadcast_to(eye[:, j], qp.A.shape[:-1]))


def test_shift_matches_jax():
    jc, _, tc, _ = _pair()
    rng = np.random.default_rng(2)
    x, u = rng.standard_normal((B, N + 1, 5)), rng.standard_normal((B, N, 2))
    from doa_mpc_tpu.solver.sqp_rti import RtiState as JRti
    want = jc.shift(JRti(jnp.asarray(x), jnp.asarray(u)))
    got = tc.shift(RtiState(torch.as_tensor(x), torch.as_tensor(u)))
    np.testing.assert_array_equal(got.x_traj.numpy(), np.asarray(want.x_traj))
    np.testing.assert_array_equal(got.u_traj.numpy(), np.asarray(want.u_traj))


@pytest.mark.parametrize("strategy", ["current", "interpolate"])
def test_initial_guess_matches_jax(strategy):
    jc, jspec, tc, _ = _pair(strategy)
    rng = np.random.default_rng(4)
    x0 = rng.standard_normal((B, 5)) * 3
    _, goal = robot_start_goal(jspec)
    want = jax.vmap(lambda x: jc.initial_guess(x, jnp.asarray(goal)))(jnp.asarray(x0))
    got = tc.initial_guess(torch.as_tensor(x0), torch.as_tensor(goal))
    np.testing.assert_allclose(got.x_traj.numpy(), np.asarray(want.x_traj), rtol=0, atol=ATOL)
    np.testing.assert_array_equal(got.u_traj.numpy(), np.asarray(want.u_traj))
    one = tc.initial_guess(torch.as_tensor(x0[1]), torch.as_tensor(goal))
    np.testing.assert_array_equal(one.x_traj.numpy(), got.x_traj[1].numpy())


def test_cost_params_match_jax():
    spec = WorldSpec()
    got = default_cost_params(spec, dtype=torch.float64, device="cpu")
    want = interop.cost_params_from_numpy(j_params(JSpec(), dtype=jnp.float64), "cpu",
                                          torch.float64)
    for f in ("q_diag", "r_diag", "qe_diag", "lm_reg", "slack_scale", "slack_offset",
              "x_bound", "v_bound", "u_bound"):
        torch.testing.assert_close(getattr(got, f), getattr(want, f), rtol=0, atol=0)
    moved = got.to(dtype=torch.float32)
    assert moved.q_diag.dtype == torch.float32
