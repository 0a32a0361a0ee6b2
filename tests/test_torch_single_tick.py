"""The port's parametric, fixed-goal and rollout ticks, the noise-free and
collecting batched rollout, per-row goals and cost parameters, and the
``demo`` command, against the JAX package and the native C++ closed loop.

Tolerances: 1e-8 in float64 against the JAX package's ``vmap`` of its
single-scenario tick (both solve the same QPs with the same XLA-style
interior point at ``ip_reg``; the port's Newton solves run K2's plain
version) and against the native loop, 1e-9 between per-row and single-row
cost parameters, bit for bit where a shared input is repeated on every row.
Worlds come from ``compat_rng`` and the obstacles move without noise (or
with the same given noise) because ``jax.random`` streams cannot be
reproduced in torch.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from doa_mpc_tpu import native
from doa_mpc_tpu.config import SolverOptions as JOptions, WorldSpec as JSpec
from doa_mpc_tpu.config import default_cost_params as j_params
from doa_mpc_tpu.sim import closed_loop as jcl
from doa_mpc_tpu.sim.compat_rng import mt_experiment_batch
from doa_mpc_tpu.sim.obstacles import robot_start_goal
from doa_mpc_tpu.solver.sqp_rti import make_rti_controller as j_make
from doa_mpc_tpu_torch import cli, interop
from doa_mpc_tpu_torch.config import SolverOptions, WorldSpec, default_cost_params
from doa_mpc_tpu_torch.ops import ip_qp
from doa_mpc_tpu_torch.ops.ip_fused import solve_ocp_qp_fused
from doa_mpc_tpu_torch.ops.riccati_fused import riccati_solve_fused
from doa_mpc_tpu_torch.sim.closed_loop import (
    LoopState, init_loop_state, make_batched_rollout, make_batched_tick,
    make_parametric_tick, make_rollout,
)
from doa_mpc_tpu_torch.sim.obstacles import ObstacleState, bounce_step, obstacle_step
from doa_mpc_tpu_torch.solver.sqp_rti import make_rti_controller

ATOL = 1e-8
N, M, B, TICKS = 6, 3, 3, 10
GOALS = np.array([[6.75, 6.85], [2.0, -3.0], [-4.0, 5.0]])


def _specs(n=N, m=M, qp_iter=6, **opt_kw):
    return (JSpec(tf=0.1 * n, n_solv=n, n_obst=m, qp_iter=qp_iter),
            JOptions(qp_iter=qp_iter, integrator="rk4", **opt_kw),
            WorldSpec(tf=0.1 * n, n_solv=n, n_obst=m, qp_iter=qp_iter),
            SolverOptions(qp_iter=qp_iter, integrator="rk4", **opt_kw))


def _controllers(**opt_kw):
    jspec, jopts, spec, opts = _specs(**opt_kw)
    return (j_make(jspec, jopts, dtype=jnp.float64), jspec,
            make_rti_controller(spec, opts, dtype=torch.float64, device="cpu"), spec)


def _start(jc, jspec, goals=GOALS, nb=B, ticks=TICKS):
    """A JAX loop state on compat_rng worlds with per-row goals: row 0
    starts 0.21 m from its goal, moving toward it (it is reached in the
    first ticks and then stays frozen). Returns it with numpy leaves, and
    the worlds' noise."""
    start, goal = robot_start_goal(jspec)
    obst, noise = mt_experiment_batch(range(nb), jspec, "RANDOM", max_iter=ticks,
                                      dtype=np.float64)
    st = jcl.init_loop_state(jax.random.PRNGKey(0), jc, jnp.asarray(start), goal,
                             batch_shape=(nb,), obst=obst)
    x0 = np.asarray(st.x0).copy()
    x0[0, :4] = [6.6, 6.7, 0.8, 0.8]
    g = jnp.asarray(goals)
    st = st._replace(x0=jnp.asarray(x0), rti=jax.vmap(jc.initial_guess)(jnp.asarray(x0), g),
                     dist=jnp.linalg.norm(jnp.asarray(x0[:, :2]) - g, axis=-1))
    return jax.tree.map(np.asarray, st), noise


def _port(st_np):
    return interop.loop_state_from_numpy(st_np, "cpu", torch.float64)


def _assert_state_close(got: LoopState, want, atol=ATOL):
    for name in ("steps", "reached", "done", "oob", "resets"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)
    pairs = [("x0", got.x0, want.x0), ("x_traj", got.rti.x_traj, want.rti.x_traj),
             ("u_traj", got.rti.u_traj, want.rti.u_traj),
             ("min_margin", got.min_margin, want.min_margin), ("dist", got.dist, want.dist),
             ("pos", got.obst.pos, want.obst.pos), ("vel", got.obst.vel, want.obst.vel)]
    for name, g, w in pairs:
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=atol, err_msg=name)


# ---------------------------------------------------------------------------
# random_move and collect on the batched path
# ---------------------------------------------------------------------------

def test_random_move_false_is_bounce_and_draws_nothing():
    spec = WorldSpec(n_obst=4)
    rng = np.random.default_rng(0)
    st = ObstacleState(torch.tensor(rng.uniform(-8, 8, (5, 4, 2))),
                       torch.tensor(rng.uniform(-2, 2, (5, 4, 2))))
    gen = torch.Generator().manual_seed(3)
    before = gen.get_state()
    for noise in (None, torch.ones(5, 4, 2)):
        got = obstacle_step(st, spec, random_move=False, noise=noise, generator=gen)
        want = bounce_step(st, spec)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert torch.equal(gen.get_state(), before)
    moved = obstacle_step(st, spec, generator=gen)
    assert not torch.equal(moved.vel.abs(), st.vel.abs())
    assert not torch.equal(gen.get_state(), before)


def test_batched_rollout_noise_free_collect_matches_jax():
    """``random_move=False, collect=True`` on the ``torch`` backend against
    JAX's ``xla`` rollout: final state and the per-tick (x0, obst.pos)
    stacks, f64, 20 ticks."""
    jspec, jopts, spec, opts = _specs(n=5, m=3)
    jc = j_make(jspec, jopts, dtype=jnp.float64)
    tc = make_rti_controller(spec, opts, dtype=torch.float64, device="cpu")
    _, goal = robot_start_goal(jspec)
    st, _ = _start(jc, jspec, goals=np.broadcast_to(goal, (B, 2)), ticks=1)
    T = 20
    fin_j, (xs_j, ps_j) = jax.jit(jcl.make_batched_rollout(
        jc, goal, j_params(jspec, dtype=jnp.float64), max_iter=T, random_move=False,
        backend="xla", collect=True))(jax.tree.map(jnp.asarray, st))
    gen = torch.Generator().manual_seed(0)
    before = gen.get_state()
    fin, (xs, ps) = make_batched_rollout(
        tc, goal, default_cost_params(spec, dtype=torch.float64, device="cpu"), max_iter=T,
        random_move=False, backend="torch", collect=True, generator=gen)(_port(st))
    assert torch.equal(gen.get_state(), before)
    assert xs.shape == (T, B, 5) and ps.shape == (T, B, 3, 2)
    np.testing.assert_allclose(xs.numpy(), np.asarray(xs_j), rtol=0, atol=ATOL)
    np.testing.assert_allclose(ps.numpy(), np.asarray(ps_j), rtol=0, atol=ATOL)
    _assert_state_close(fin, fin_j)


def _native_oracle_world():
    """The world of ``tests/test_native.py``: avoidance is active on the
    way to the goal."""
    pos = np.array([[-3.5, -3.0], [-0.5, 0.5], [2.5, 2.0], [0.0, -2.0], [4.0, 5.0]])
    vel = np.array([[0.8, -0.5], [-0.6, 0.9], [0.5, 0.7], [-0.9, 0.4], [0.3, -0.8]])
    return pos, vel


@pytest.mark.skipif(not native.available(), reason="native toolchain unavailable")
@pytest.mark.parametrize("use_noise,pred_bug", [(False, False), (True, True)],
                         ids=["noise_free", "noise_pred_bug"])
def test_batched_rollout_matches_native_closed_loop(use_noise, pred_bug):
    """The native C++ closed loop (forecast, QP assembly, interior point,
    RK4 plant, shift; no JAX) against the port's batched rollout (``torch``
    backend, the counterpart of the JAX test's ``xla``) in f64, both legs of
    ``tests/test_native.py``, 50 ticks."""
    spec = WorldSpec(tf=2.0, n_solv=20, n_obst=5, qp_iter=30)
    opts = SolverOptions(qp_iter=30, integrator="rk4", compat_pred_bug=pred_bug)
    ctrl = make_rti_controller(spec, opts, dtype=torch.float64, device="cpu")
    params = default_cost_params(spec, dtype=torch.float64, device="cpu")
    start, goal = robot_start_goal(spec)
    pos, vel = _native_oracle_world()
    T = 50
    noise = np.random.default_rng(3).standard_normal((T, 5, 2))
    st = init_loop_state(ctrl, start, goal, batch_shape=(1,),
                         obst=ObstacleState(torch.tensor(pos)[None], torch.tensor(vel)[None]))
    fin, (xs, _) = make_batched_rollout(
        ctrl, goal, params, max_iter=T, random_move=use_noise, backend="torch",
        collect=True, use_noise_traj=True)(
            st, torch.tensor(noise)[:, None] if use_noise else None)
    res = native.closed_loop_run(
        JSpec(tf=2.0, n_solv=20, n_obst=5, qp_iter=30), j_params(JSpec(), dtype=jnp.float64),
        goal, start, pos, vel, max_iter=T, qp_iter=30, noise=noise if use_noise else None,
        compat_pred_bug=pred_bug, ip_tol=1e-10, ip_stat_tol=1e-8)
    n = res["ticks"]
    assert n >= 50
    err = np.abs(res["x_hist"][1:n + 1] - xs[:n, 0].numpy()).max()
    assert err < ATOL, f"native-vs-port closed-loop deviation {err}"
    np.testing.assert_allclose(res["min_margin"], float(fin.min_margin[0]), rtol=0, atol=ATOL)
    assert res["reached"] == bool(fin.reached[0])
    if use_noise:
        assert res["min_margin"] < spec.margin    # avoidance was active


# ---------------------------------------------------------------------------
# the parametric tick, make_tick and make_rollout against JAX's vmap
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_parametric(case):
    kw = dict(status4=dict(init_guess_when_error=True),
              interpolate=dict(init_guess="interpolate")).get(case, {})
    jspec, jopts, _, _ = _specs(**kw)
    jc = j_make(jspec, jopts, dtype=jnp.float64)
    st, _ = _start(jc, jspec)
    tick = jax.jit(jax.vmap(jcl.make_parametric_tick(jc, random_move=False, return_pred=True),
                            in_axes=(0, 0, None)))
    params = j_params(jspec, dtype=jnp.float64)
    s, preds = jax.tree.map(jnp.asarray, st), []
    for _ in range(TICKS):
        s, p = tick(s, jnp.asarray(GOALS), params)
        preds.append(np.asarray(p))
    return st, jax.tree.map(np.asarray, s), np.stack(preds), kw


@pytest.mark.parametrize("case", ["current", "status4", "interpolate"])
def test_parametric_tick_per_row_goals_matches_jax(case):
    """Three rows with three goals, 10 noise-free f64 ticks, against JAX's
    ``vmap(make_parametric_tick(..., random_move=False))`` over (state,
    goal): every state field and the returned pre-shift horizon, with the
    status-4 analogue on in one case and the "interpolate" guess in one."""
    st, want, want_preds, kw = _jax_parametric(case)
    _, _, spec, opts = _specs(**kw)
    tc = make_rti_controller(spec, opts, dtype=torch.float64, device="cpu")
    tick = make_parametric_tick(tc, random_move=False, return_pred=True)
    params = default_cost_params(spec, dtype=torch.float64, device="cpu")
    s = _port(st)
    before = riccati_solve_fused.launches
    for t in range(TICKS):
        s, pred = tick(s, torch.tensor(GOALS), params)
        np.testing.assert_allclose(pred.numpy(), want_preds[t], rtol=0, atol=ATOL)
    assert riccati_solve_fused.launches == before          # CPU: the plain version
    _assert_state_close(s, want)
    assert bool(s.done[0]) and not bool(s.done[1:].any())
    if case == "status4":
        assert 0 < int(s.resets.sum()) < B * TICKS


def test_make_rollout_collect_matches_jax_per_row_stacks():
    """``make_rollout(collect=True)``: the (x0, obst_pos, pred_x) stacks are
    (T, B, ...) and equal JAX's per-row stacks (its single-scenario
    rollout under ``vmap``, moved to tick-major)."""
    jc, jspec, tc, spec = _controllers()
    _, goal = robot_start_goal(jspec)
    st, _ = _start(jc, jspec, goals=np.broadcast_to(goal, (B, 2)))
    T = 8
    fin_j, traj_j = jax.jit(jax.vmap(jcl.make_rollout(
        jc, goal, j_params(jspec, dtype=jnp.float64), max_iter=T, random_move=False,
        collect=True)))(jax.tree.map(jnp.asarray, st))
    fin, traj = make_rollout(tc, goal, default_cost_params(spec, dtype=torch.float64,
                                                           device="cpu"),
                             max_iter=T, random_move=False, collect=True)(_port(st))
    for name, got, want, shape in zip(("x0", "obst_pos", "pred_x"), traj, traj_j,
                                      ((T, B, 5), (T, B, M, 2), (T, B, N + 1, 5))):
        assert got.shape == shape, name
        np.testing.assert_allclose(got.numpy(), np.moveaxis(np.asarray(want), 1, 0),
                                   rtol=0, atol=ATOL, err_msg=name)
    _assert_state_close(fin, fin_j)
    assert make_rollout(tc, goal, default_cost_params(spec, dtype=torch.float64, device="cpu"),
                        max_iter=2, random_move=False)(_port(st)).x0.shape == (B, 5)


def test_per_row_cost_params_match_single_runs():
    """The port of ``tests/test_weight_sweep.py``: three ``CostParams``
    stacked per row give the three single-row runs (1e-9), and the
    settings change the behaviour."""
    spec = WorldSpec(tf=0.5, n_solv=5, n_obst=3, qp_iter=8)
    opts = SolverOptions(qp_iter=8, integrator="rk4")
    ctrl = make_rti_controller(spec, opts, dtype=torch.float64, device="cpu")
    start, goal = robot_start_goal(spec)
    base = default_cost_params(spec, dtype=torch.float64, device="cpu")
    variants = [base, base.__class__(**{**base.__dict__, "r_diag": base.r_diag * 2000.0}),
                base.__class__(**{**base.__dict__, "lm_reg": base.lm_reg * 10.0})]
    stacked = base.__class__(**{f: torch.stack([getattr(v, f) for v in variants])
                                for f in base.__dict__})
    gen = torch.Generator().manual_seed(0)
    st = init_loop_state(ctrl, start, goal, batch_shape=(3,), generator=gen)
    noise = torch.randn((5, 3, 3, 2), generator=gen, dtype=torch.float64)
    tick = make_parametric_tick(ctrl)
    sb = st
    for t in range(5):
        sb = tick(sb, goal, stacked, noise=noise[t])
    for i, p in enumerate(variants):
        s = LoopState(*(type(a)(*(b[i:i + 1] for b in a)) if isinstance(a, tuple)
                        else a[i:i + 1] for a in st))
        for t in range(5):
            s = tick(s, goal, p, noise=noise[t, i:i + 1])
        np.testing.assert_allclose(sb.x0[i].numpy(), s.x0[0].numpy(), rtol=0, atol=1e-9)
    assert float((sb.x0[0] - sb.x0[1]).abs().max()) > 1e-4
    assert float((sb.x0[0] - sb.x0[2]).abs().max()) > 1e-4


@pytest.mark.parametrize("backend", ["fused", "riccati"])
def test_batched_tick_shared_goal_and_params_bit_identical_to_per_row(backend):
    """The main path does not move: a shared goal (2,) and shared params
    give the same states, bit for bit, as the same goal and params repeated
    on every row (f32, 5 ticks with compat noise)."""
    spec = WorldSpec(tf=1.0, n_solv=10, n_obst=4, qp_iter=6)
    opts = SolverOptions(qp_iter=6, integrator="rk4", compat_pred_bug=True)
    ctrl = make_rti_controller(spec, opts, dtype=torch.float32, device="cpu")
    params = default_cost_params(spec, dtype=torch.float32, device="cpu")
    nb = 5
    per_row = params.__class__(**{f: v.expand((nb,) + v.shape).clone()
                                  for f, v in params.__dict__.items()})
    start, goal = robot_start_goal(spec)
    obst, noise = mt_experiment_batch(range(nb), spec, "RANDOM", max_iter=5)
    st0 = init_loop_state(ctrl, start, goal, batch_shape=(nb,),
                          obst=ObstacleState(torch.tensor(obst.pos), torch.tensor(obst.vel)))
    goal_rows = torch.tensor(goal, dtype=torch.float32).expand(nb, 2).clone()
    a = b = st0
    ta = make_batched_tick(ctrl, goal, params, backend=backend)
    tb = make_batched_tick(ctrl, goal_rows, per_row, backend=backend)
    for t in range(5):
        a, b = ta(a, noise=torch.tensor(noise[t])), tb(b, noise=torch.tensor(noise[t]))
    for name, x, y in zip(LoopState._fields, a, b):
        for u, v in (zip(x, y) if isinstance(x, tuple) else [(x, y)]):
            assert torch.equal(u, v), name


def test_rti_step_solves_through_k2_plain_version_on_cpu(monkeypatch):
    """``rti_step`` solves with the ``riccati`` backend: two calls of K2's
    wrapper per IP iteration, which on CPU tensors run its plain version and
    count no launch; K1 is never called."""
    jc, jspec, tc, spec = _controllers()
    st, _ = _start(jc, jspec)
    s = _port(st)
    calls = []
    real = ip_qp.riccati_solve_fused

    def spy(*a, **k):
        calls.append(a[0].device.type)
        return real(*a, **k)

    monkeypatch.setattr(ip_qp, "riccati_solve_fused", spy)
    k1, k2 = solve_ocp_qp_fused.launches, riccati_solve_fused.launches
    pred = torch.zeros((B, N + 1, M, 2), dtype=torch.float64) + 5.0
    tc.rti_step(s.rti, s.x0, torch.tensor(GOALS), pred,
                default_cost_params(spec, dtype=torch.float64, device="cpu"))
    assert calls == ["cpu"] * (2 * 6)
    assert riccati_solve_fused.launches == k2 and solve_ocp_qp_fused.launches == k1


def test_demo_cli_writes_a_gif(tmp_path, capsys):
    pytest.importorskip("matplotlib")
    gif = tmp_path / "demo.gif"
    cli.main(["demo", "--device", "cpu", "--tf", "0.4", "--n-solv", "4", "--n-obst", "2",
              "--qp-iter", "3", "--max-iter", "12", "--gif", str(gif)])
    out = capsys.readouterr().out
    assert "reached=" in out and "min_margin=" in out and f"wrote {gif}" in out
    assert gif.stat().st_size > 1000
    assert gif.read_bytes()[:6] in (b"GIF87a", b"GIF89a")
