"""The slice as a whole: the PyTorch port's batched closed loop against the
JAX package's ``make_batched_rollout(backend="xla")`` in float64, the
experiment harness against JAX's, and the CLI's artifacts.

Both packages start from the same state (carried across with
``doa_mpc_tpu_torch.interop``) and consume the same compat_rng obstacle
noise. Every port backend is held to the JAX ``xla`` rollout: ``fused``
(kernel K1's plain version) differs from it only in association order (see
``test_torch_ip_fused.py``), ``torch`` is its port and ``riccati`` runs K2's
plain version inside the same solver. So over 30 ticks the float64
trajectories stay within 1e-6 and every discrete outcome agrees exactly,
with the status-4 analogue off (the default) and on."""

import dataclasses
import functools
import glob
import json
import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from doa_mpc_tpu.config import SolverOptions as JOptions, WorldSpec as JSpec
from doa_mpc_tpu.config import default_cost_params as j_params
from doa_mpc_tpu.sim.closed_loop import init_loop_state as j_init
from doa_mpc_tpu.sim.closed_loop import make_batched_rollout as j_rollout
from doa_mpc_tpu.sim.compat_rng import mt_experiment_batch
from doa_mpc_tpu.sim.experiments import run_scenario_batch as j_run
from doa_mpc_tpu.sim.obstacles import robot_start_goal
from doa_mpc_tpu.solver.sqp_rti import make_rti_controller as j_make
from doa_mpc_tpu_torch import interop
from doa_mpc_tpu_torch.config import SolverOptions, WorldSpec, default_cost_params
from doa_mpc_tpu_torch.ops.ip_fused import UNICYCLE_QP_STRUCTURE, solve_ocp_qp_fused
from doa_mpc_tpu_torch.ops.riccati_fused import riccati_solve_fused
from doa_mpc_tpu_torch.sim import closed_loop
from doa_mpc_tpu_torch.sim.closed_loop import make_batched_rollout, metrics_of
from doa_mpc_tpu_torch.sim.experiments import run_scenario_batch
from doa_mpc_tpu_torch.solver.sqp_rti import make_rti_controller

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, M, B, TICKS = 6, 3, 4, 30


def _specs(qp_iter=6, status4=False, integrator="rk4", knobs=()):
    """Both packages' spec and options; ``knobs`` are further (field, value)
    pairs of the options."""
    return (JSpec(tf=0.1 * N, n_solv=N, n_obst=M, qp_iter=qp_iter),
            JOptions(qp_iter=qp_iter, integrator=integrator, init_guess_when_error=status4,
                     **dict(knobs)),
            WorldSpec(tf=0.1 * N, n_solv=N, n_obst=M, qp_iter=qp_iter),
            SolverOptions(qp_iter=qp_iter, integrator=integrator,
                          init_guess_when_error=status4, **dict(knobs)))


@functools.lru_cache(maxsize=None)
def _jax_rollout(status4=False, integrator="rk4", knobs=(), slack_mult=1.0):
    """Start state, noise and the JAX ``xla`` rollout's final state (numpy);
    ``slack_mult`` scales the cost's ``slack_scale``."""
    jspec, jopts, _, _ = _specs(status4=status4, integrator=integrator, knobs=knobs)
    jc = j_make(jspec, jopts, dtype=jnp.float64)
    start, goal = robot_start_goal(jspec)
    obst, noise = mt_experiment_batch(range(B), jspec, "RANDOM", max_iter=TICKS,
                                      dtype=np.float64)
    st = j_init(jax.random.PRNGKey(0), jc, jnp.asarray(start), goal,
                batch_shape=(B,), obst=obst)
    # row 0 starts near the goal, reaches it after ~20 ticks and stays frozen
    x0 = np.asarray(st.x0).copy()
    x0[0, :4] = [6.6, 6.7, 0.8, 0.4]
    x0[1, :4] = [6.2, 6.4, 0.7, 0.6]
    st = st._replace(x0=jnp.asarray(x0), rti=jax.vmap(
        lambda x: jc.initial_guess(x, jnp.asarray(goal)))(jnp.asarray(x0)))
    jp = j_params(jspec, dtype=jnp.float64)
    jp = dataclasses.replace(jp, slack_scale=jp.slack_scale * slack_mult)
    final_j = jax.jit(j_rollout(jc, goal, jp,
                                max_iter=TICKS, backend="xla",
                                use_noise_traj=True))(st, jnp.asarray(noise))
    return (jax.tree.map(np.asarray, st), noise, goal,
            jax.tree.map(np.asarray, final_j))


def _port_rollout(backend, status4=False, integrator="rk4", knobs=(), slack_mult=1.0):
    st, noise, goal, _ = _jax_rollout(status4, integrator, knobs, slack_mult)
    _, _, spec, opts = _specs(status4=status4, integrator=integrator, knobs=knobs)
    tc = make_rti_controller(spec, opts, dtype=torch.float64, device="cpu")
    ts = interop.loop_state_from_numpy(st, "cpu", torch.float64)
    params = default_cost_params(spec, dtype=torch.float64, device="cpu")
    params = dataclasses.replace(params, slack_scale=params.slack_scale * slack_mult)
    return make_batched_rollout(tc, goal, params, max_iter=TICKS, backend=backend,
                                use_noise_traj=True)(ts, torch.as_tensor(noise))


def _assert_final_close(final_t, final_j):
    reached = np.asarray(final_j.reached)
    assert reached.any() and not reached.all()
    for name in ("steps", "reached", "done", "oob", "resets"):
        np.testing.assert_array_equal(getattr(final_t, name).numpy(),
                                      np.asarray(getattr(final_j, name)), err_msg=name)
    assert final_t.steps.dtype == torch.int32
    pairs = [("x0", final_t.x0, final_j.x0),
             ("x_traj", final_t.rti.x_traj, final_j.rti.x_traj),
             ("u_traj", final_t.rti.u_traj, final_j.rti.u_traj),
             ("min_margin", final_t.min_margin, final_j.min_margin),
             ("dist", final_t.dist, final_j.dist),
             ("obst", final_t.obst.pos, final_j.obst.pos)]
    for name, got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6,
                                   err_msg=name)
    hit_t = metrics_of(final_t).hit.numpy()
    np.testing.assert_array_equal(hit_t, np.asarray(final_j.min_margin) <= 0)


def test_rollout_matches_jax_f64(monkeypatch):
    """The ``fused`` tick declares UNICYCLE_QP_STRUCTURE to the solver, as
    the JAX tick does, and its rollout matches JAX's."""
    seen = []

    def spy(qp, **kw):
        seen.append(kw.get("structure"))
        return solve_ocp_qp_fused(qp, **kw)

    monkeypatch.setattr(closed_loop, "solve_ocp_qp_fused", spy)
    before = solve_ocp_qp_fused.launches
    final_t = _port_rollout("fused")
    assert solve_ocp_qp_fused.launches == before      # CPU: the plain version
    assert len(seen) == TICKS and all(st == UNICYCLE_QP_STRUCTURE for st in seen)
    _assert_final_close(final_t, _jax_rollout()[3])


@pytest.mark.parametrize("backend", ["torch", "riccati"])
def test_rollout_solver_backends_match_jax_f64(backend):
    before = riccati_solve_fused.launches
    final_t = _port_rollout(backend)
    assert riccati_solve_fused.launches == before     # CPU: the plain version
    final_j = _jax_rollout()[3]
    _assert_final_close(final_t, final_j)
    assert not final_j.resets.any()


@pytest.mark.parametrize("backend", ["fused", "torch"])
def test_rollout_irk_matches_jax_f64(backend):
    """The default integrator (IRK) in both the linearization and the plant:
    30 float64 ticks stay within 1e-6 of the JAX rollout."""
    final_t = _port_rollout(backend, integrator="irk")
    _assert_final_close(final_t, _jax_rollout(integrator="irk")[3])


@pytest.mark.parametrize("backend", ["torch", "riccati", "fused"])
def test_status4_analogue_matches_jax_f64(backend):
    """``init_guess_when_error``: rows whose 6-iteration solve misses the
    fail tolerances reset their warm start and brake (compat_brake_bug);
    the resets count, the braked plant and every outcome follow JAX."""
    final_j = _jax_rollout(status4=True)[3]
    resets = np.asarray(final_j.resets)
    assert resets.sum() > 0 and (resets < TICKS).any()
    _assert_final_close(_port_rollout(backend, status4=True), final_j)


@pytest.mark.parametrize("knobs,slack_mult", [
    ((("slack_scale_dt", False),), 1.0),
    ((("cost_scale_dt", False), ("lm_scale_dt", False)), 1.0),
    ((("lm_scale_dt", False),), 1.0),
    ((), 2.0),
], ids=["slack_unscaled", "cost_unscaled", "lm_raw", "slack_mult_2"])
def test_cost_scaling_conventions_match_jax_f64(knobs, slack_mult):
    """The cost-scaling conventions of the parity matrix's legs v2-v5 (the
    slack penalty, the whole stage cost and the Levenberg-Marquardt term
    without the dt scale) and a doubled slack scale: the ``torch`` rollout
    follows JAX's ``xla`` rollout in f64."""
    final_j = _jax_rollout(knobs=knobs, slack_mult=slack_mult)[3]
    assert not np.array_equal(np.asarray(final_j.x0), np.asarray(_jax_rollout()[3].x0))
    _assert_final_close(_port_rollout("torch", knobs=knobs, slack_mult=slack_mult), final_j)


def test_run_scenario_batch_compat_rows_match_jax():
    jspec, jopts, spec, opts = _specs(qp_iter=4)
    want = j_run(jspec, jopts, "RANDOM", n_runs=3, max_iter=12, dtype=jnp.float64,
                 backend="xla", compat_rng=True)
    got = run_scenario_batch(spec, opts, "RANDOM", n_runs=3, max_iter=12,
                             dtype=torch.float64, compat_rng=True, device="cpu")
    assert got.shape == (3, 6) and got.dtype == np.float64
    np.testing.assert_array_equal(got[:, [0, 1, 4, 5]], want[:, [0, 1, 4, 5]])
    np.testing.assert_allclose(got[:, [2, 3]], want[:, [2, 3]], rtol=0, atol=1e-6)


def test_run_scenario_batch_generator_path_is_seeded():
    _, _, spec, opts = _specs(qp_iter=2)
    a = run_scenario_batch(spec, opts, "CENTER", n_runs=2, max_iter=4, seed=5,
                           dtype=torch.float64, device="cpu")
    b = run_scenario_batch(spec, opts, "CENTER", n_runs=2, max_iter=4, seed=5,
                           dtype=torch.float64, device="cpu")
    z = run_scenario_batch(spec, opts, "CENTER", n_runs=2, max_iter=4, seed=5,
                           dtype=torch.float64, device="cpu", backend="zero")
    np.testing.assert_array_equal(a, b)
    assert np.isfinite(a).all() and a.shape == (2, 6)
    assert (z[:, 4] == 4).all()          # a zero step never reaches the goal
    with pytest.raises(ValueError, match="not ported"):
        run_scenario_batch(spec, opts, "CENTER", n_runs=1, max_iter=1,
                           device="cpu", backend="xla")


def test_cli_experiment_writes_csv_and_spec(tmp_path):
    out = tmp_path / "out"
    cmd = [sys.executable, "-m", "doa_mpc_tpu_torch", "experiment", "--device", "cpu",
           "--runs", "2", "--max-iter", "5", "--n-solv", "4", "--n-obst", "2",
           "--qp-iter", "2", "--scenarios", "RANDOM", "--out", str(out)]
    res = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=REPO))
    assert res.returncode == 0, res.stderr
    (csv,) = glob.glob(str(out / "*_experiment_data.csv"))
    data = np.loadtxt(csv, delimiter=";")
    assert data.shape == (2, 6) and np.isfinite(data).all()
    (spec_path,) = glob.glob(str(out / "*_experiment_spec.json"))
    spec = json.load(open(spec_path))
    assert spec["engine"] == "doa_mpc_tpu_torch" and spec["device"] == "cpu"
    assert spec["N_SOLV"] == 4 and spec["N_OBST"] == 2 and spec["QP_ITER"] == 2
    assert spec["scenario"] == "RANDOM" and spec["backend"] == "fused"


def test_cli_experiment_riccati_backend_same_schema(tmp_path):
    """``--backend riccati`` writes the same CSV and JSON schema as the
    default backend, and its rows match the in-process run."""
    out = tmp_path / "out"
    cmd = [sys.executable, "-m", "doa_mpc_tpu_torch", "experiment", "--device", "cpu",
           "--runs", "2", "--max-iter", "5", "--n-solv", "4", "--n-obst", "2",
           "--qp-iter", "2", "--scenarios", "RANDOM", "--compat-rng", "--f64",
           "--backend", "riccati", "--out", str(out)]
    res = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=REPO))
    assert res.returncode == 0, res.stderr
    (csv,) = glob.glob(str(out / "*_experiment_data.csv"))
    data = np.loadtxt(csv, delimiter=";")
    assert data.shape == (2, 6) and np.isfinite(data).all()
    (spec_path,) = glob.glob(str(out / "*_experiment_spec.json"))
    spec = json.load(open(spec_path))
    assert set(spec) == {
        "slack", "random_move", "init_guess", "scenario", "TF", "N_SOLV", "N_OBST",
        "QP_ITER", "engine", "integrator", "dtype", "compat_pred_bug", "compat_rng",
        "fail_mu_tol", "fail_stat_tol", "backend", "device"}
    assert spec["backend"] == "riccati" and spec["engine"] == "doa_mpc_tpu_torch"
    assert spec["dtype"] == "float64" and spec["compat_rng"] is True
    wspec = WorldSpec(tf=2.0, n_solv=4, n_obst=2, qp_iter=2)
    want = run_scenario_batch(wspec, SolverOptions(qp_iter=2, integrator="rk4"), "RANDOM",
                              n_runs=2, max_iter=5, dtype=torch.float64, backend="riccati",
                              compat_rng=True, device="cpu")
    np.testing.assert_allclose(data, want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("status4", [False, True], ids=["plain", "status4"])
def test_fused_tick_skipping_done_rows_leaves_the_loop_state_unchanged(monkeypatch, status4):
    """The ``fused`` tick hands K1 its ``done`` rows to skip. Their zeros
    are discarded by the freeze, and with the status-4 analogue on they read
    as a solve that did not fail: over a few ticks of a small float32 batch
    with some rows done from the start, every field of the loop state is
    bit for bit what the tick gives when K1 solves every row."""
    _, _, spec, opts = _specs(qp_iter=8, status4=status4)
    ctrl = make_rti_controller(spec, opts, dtype=torch.float32, device="cpu")
    params = default_cost_params(spec, dtype=torch.float32, device="cpu")
    start, goal = robot_start_goal(spec)
    gen = torch.Generator().manual_seed(3)
    st0 = closed_loop.init_loop_state(ctrl, start, goal, "RANDOM", batch_shape=(6,),
                                      generator=gen)
    st0 = st0._replace(done=torch.tensor([True, False, False, True, False, True]))
    noise = torch.randn((4, 6, M, 2), generator=gen)
    handed = []

    def solve(qp, **kw):
        handed.append(kw.get("skip"))
        return solve_ocp_qp_fused(qp, **kw)

    def run():
        return make_batched_rollout(ctrl, goal, params, max_iter=4, backend="fused",
                                    use_noise_traj=True)(st0, noise)

    monkeypatch.setattr(closed_loop, "solve_ocp_qp_fused", solve)
    skipping = run()
    assert len(handed) == 4 and torch.equal(handed[0], st0.done)
    monkeypatch.setattr(closed_loop, "solve_ocp_qp_fused",
                        lambda qp, skip=None, **kw: solve_ocp_qp_fused(qp, **kw))
    solving = run()
    flat = lambda s: [a for f in s for a in (f if isinstance(f, tuple) else (f,))]
    for a, b in zip(flat(skipping), flat(solving)):
        assert torch.equal(a, b)
    assert torch.equal(skipping.x0[st0.done], st0.x0[st0.done])
