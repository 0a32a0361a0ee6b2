"""Model and obstacle world of the PyTorch port against the JAX package, on
shared numpy inputs in float64 (atol 1e-12; both evaluate the same
expressions, so only last-ulp rounding may differ), plus bitwise equality of
the MT19937 compat streams."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from doa_mpc_tpu.config import WorldSpec as JWorldSpec
from doa_mpc_tpu.models import unicycle as jm
from doa_mpc_tpu.sim import compat_rng as jrng
from doa_mpc_tpu.sim import obstacles as jo
from doa_mpc_tpu_torch.config import WorldSpec
from doa_mpc_tpu_torch.models import unicycle as tm
from doa_mpc_tpu_torch.sim import compat_rng as trng
from doa_mpc_tpu_torch.sim import obstacles as to

ATOL = 1e-12
SPEC = WorldSpec(tf=2.0, n_solv=20, n_obst=5)
JSPEC = JWorldSpec(tf=2.0, n_solv=20, n_obst=5)


def _j(a):
    return jnp.asarray(a, jnp.float64)


def _t(a):
    return torch.as_tensor(np.array(a), dtype=torch.float64)


def _close(j, t):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=ATOL)


def _world(seed, batch=6, m=5, far=False):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-7.9, 7.9, (batch, m, 2))
    vel = rng.uniform(-2.0, 2.0, (batch, m, 2))
    if far:   # free paths far outside the box, on both sides
        vel = vel * 40.0
    return pos, vel


@pytest.mark.parametrize("fn", ["dynamics", "obstacle_h", "obstacle_h_jac"])
def test_model_functions_match_jax(fn):
    rng = np.random.default_rng(0)
    s = rng.standard_normal((7, 5)) * 3.0
    u = rng.standard_normal((7, 2))
    p = rng.standard_normal((7, 4, 2)) * 4.0
    safe = tm.safe_dist_sq(SPEC)
    assert safe == jm.safe_dist_sq(JSPEC)
    if fn == "dynamics":
        _close(jm.dynamics(_j(s), _j(u)), tm.dynamics(_t(s), _t(u)))
    elif fn == "obstacle_h":
        _close(jm.obstacle_h(_j(s), _j(p), safe), tm.obstacle_h(_t(s), _t(p), safe))
    else:
        _close(jm.obstacle_h_jac(_j(s), _j(p)), tm.obstacle_h_jac(_t(s), _t(p)))


@pytest.mark.parametrize("seed", [0, 1])
def test_bounce_step_matches_jax(seed):
    pos, vel = _world(seed)
    pos[0, 0] = [7.95, -7.95]          # hits both walls this step
    vel[0, 0] = [2.0, -2.0]
    j = jo.bounce_step(jo.ObstacleState(_j(pos), _j(vel)), JSPEC)
    t = to.bounce_step(to.ObstacleState(_t(pos), _t(vel)), SPEC)
    _close(j.pos, t.pos)
    _close(j.vel, t.vel)


def test_obstacle_step_with_noise_matches_jax():
    pos, vel = _world(3)
    noise = np.random.default_rng(4).standard_normal(vel.shape) * 3.0
    j = jo.obstacle_step(None, jo.ObstacleState(_j(pos), _j(vel)), JSPEC,
                         noise=_j(noise))
    t = to.obstacle_step(to.ObstacleState(_t(pos), _t(vel)), SPEC, noise=_t(noise))
    _close(j.pos, t.pos)
    _close(j.vel, t.vel)


@pytest.mark.parametrize("bug", [False, True])
@pytest.mark.parametrize("far", [False, True])
def test_predict_trajectory_matches_jax(bug, far):
    pos, vel = _world(5, far=far)
    j = jo.predict_trajectory(jo.ObstacleState(_j(pos), _j(vel)), JSPEC, 20,
                              compat_pred_bug=bug)
    t = to.predict_trajectory(to.ObstacleState(_t(pos), _t(vel)), SPEC, 20,
                              compat_pred_bug=bug)
    free = pos[None] + np.arange(21)[:, None, None, None] * 0.1 * vel[None]
    if far:
        assert (free < SPEC.x_min).any() and (free > SPEC.x_max).any()
    _close(j, t)


def test_fold_matches_scan_oracle():
    pos, vel = _world(6)
    st = to.ObstacleState(_t(pos), _t(vel))
    np.testing.assert_allclose(to.predict_trajectory(st, SPEC, 20).numpy(),
                               to._predict_trajectory_scan(st, SPEC, 20).numpy(),
                               rtol=0, atol=1e-9)


def test_robot_start_goal_matches_jax():
    for a, b in zip(jo.robot_start_goal(JSPEC), to.robot_start_goal(SPEC)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("scenario", ["RANDOM", "CENTER", "EDGE"])
def test_compat_rng_streams_bitwise(scenario):
    for seed in range(8):
        for dtype in (np.float32, np.float64):
            jw, jn = jrng.mt_experiment_streams(seed, JSPEC, scenario, 50, dtype)
            tw, tn = trng.mt_experiment_streams(seed, SPEC, scenario, 50, dtype)
            np.testing.assert_array_equal(tw.pos, jw.pos)
            np.testing.assert_array_equal(tw.vel, jw.vel)
            np.testing.assert_array_equal(tn, jn)
    jw, jn = jrng.mt_experiment_batch(range(8), JSPEC, scenario, 9)
    tw, tn = trng.mt_experiment_batch(range(8), SPEC, scenario, 9)
    np.testing.assert_array_equal(tw.pos, jw.pos)
    np.testing.assert_array_equal(tn, jn)


def test_generate_obstacles_uses_generator():
    g1 = torch.Generator().manual_seed(3)
    g2 = torch.Generator().manual_seed(3)
    a = to.generate_obstacles(g1, SPEC, "RANDOM", (4,), torch.float64, "cpu")
    b = to.generate_obstacles(g2, SPEC, "RANDOM", (4,), torch.float64, "cpu")
    torch.testing.assert_close(a.pos, b.pos, rtol=0, atol=0)
    lo, hi, _, _ = SPEC.obst_box
    assert a.pos.shape == (4, 5, 2)
    assert (a.pos >= lo).all() and (a.pos <= hi).all()
    assert (a.vel.abs() <= SPEC.v_max_obst).all()
    e = to.generate_obstacles(g1, SPEC, "EDGE", (2,), torch.float64, "cpu")
    assert (e.pos == 7.0).all()
