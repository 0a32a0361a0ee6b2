"""Scenario sharding of the PyTorch port (``parallel/mesh.py``) on 8 CPU
shards, the counterpart of ``tests/conftest.py``'s 8 virtual CPU devices:
against the unsharded run (one ``torch.Generator`` draws every row's
noise, so the split must not change any row), against the JAX package's
``make_sharded_rollout`` in float64, and the mesh's layout and errors."""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from doa_mpc_tpu.config import SolverOptions as JOptions, WorldSpec as JSpec
from doa_mpc_tpu.config import default_cost_params as j_params
from doa_mpc_tpu.parallel.mesh import make_data_mesh as j_mesh
from doa_mpc_tpu.parallel.mesh import make_sharded_rollout as j_sharded
from doa_mpc_tpu.parallel.mesh import shard_leading_axis as j_shard
from doa_mpc_tpu.sim.closed_loop import init_loop_state as j_init
from doa_mpc_tpu.sim.closed_loop import make_batched_rollout as j_rollout
from doa_mpc_tpu.sim.closed_loop import metrics_of as j_metrics
from doa_mpc_tpu.solver.sqp_rti import make_rti_controller as j_make
from doa_mpc_tpu_torch import interop
from doa_mpc_tpu_torch.config import SolverOptions, WorldSpec, default_cost_params
from doa_mpc_tpu_torch.parallel.mesh import (
    DataMesh, make_data_mesh, make_sharded_rollout, shard_leading_axis, tree_map)
from doa_mpc_tpu_torch.sim.closed_loop import (
    BACKENDS, init_loop_state, make_batched_rollout, metrics_of)
from doa_mpc_tpu_torch.sim.experiments import run_scenario_batch
from doa_mpc_tpu_torch.sim.obstacles import robot_start_goal
from doa_mpc_tpu_torch.solver.sqp_rti import make_rti_controller

SPEC = WorldSpec(tf=1.0, n_solv=5, qp_iter=8)
OPTS = SolverOptions(qp_iter=8, integrator="rk4")
B, TICKS = 16, 15
CPU8 = [torch.device("cpu")] * 8


def _start():
    """A controller, goal, params, start state and its generator (seed 0)."""
    ctrl = make_rti_controller(SPEC, OPTS, dtype=torch.float64, device="cpu")
    start, goal = robot_start_goal(SPEC)
    gen = torch.Generator().manual_seed(0)
    state = init_loop_state(ctrl, start, goal, batch_shape=(B,), generator=gen)
    return ctrl, goal, default_cost_params(SPEC, dtype=torch.float64, device="cpu"), state, gen


def _cat(shards):
    return tree_map(lambda *a: torch.cat(a), *shards)


def _stats_of(m):
    return dict(n=float(m.steps.shape[0]), reached=float(m.reached.sum()),
                hit=float(m.hit.sum()), oob=float(m.oob.sum()),
                steps_sum=float(m.steps.sum()), min_margin=float(m.min_margin.min()))


@functools.lru_cache(maxsize=None)
def _unsharded_rows():
    return run_scenario_batch(SPEC, OPTS, "RANDOM", n_runs=B, max_iter=TICKS,
                              dtype=torch.float64, device="cpu")


def test_eight_cpu_shards_match_unsharded_rows():
    """run_scenario_batch over 8 CPU shards (random_move on): counts and
    flags equal, reals within 1e-10 of the unsharded rows."""
    ref = _unsharded_rows()
    got, state = run_scenario_batch(SPEC, OPTS, "RANDOM", n_runs=B, max_iter=TICKS,
                                    dtype=torch.float64, mesh=make_data_mesh(CPU8),
                                    return_state=True)
    assert got.shape == ref.shape == (B, 6)
    np.testing.assert_array_equal(got[:, [0, 1, 4, 5]], ref[:, [0, 1, 4, 5]])
    np.testing.assert_allclose(got[:, [2, 3]], ref[:, [2, 3]], rtol=0, atol=1e-10)
    assert state.x0.shape == (B, 5) and state.x0.device.type == "cpu"
    assert len({tuple(r) for r in got[:, 2:4]}) == B       # the rows are distinct worlds


def test_sharded_rollout_state_and_stats():
    """make_sharded_rollout against make_batched_rollout from one start and
    one generator seed: the final states agree and the statistics are the
    rows' sums and minimum."""
    ctrl, goal, params, state, gen = _start()
    ref = make_batched_rollout(ctrl, goal, params, max_iter=TICKS, generator=gen)(state)
    _, _, _, state, gen = _start()
    mesh = make_data_mesh(CPU8)
    fn = make_sharded_rollout(ctrl, goal, params, mesh, max_iter=TICKS, generator=gen)
    shards, stats = fn(shard_leading_axis(state, mesh))
    final = _cat(shards)
    for name in ("steps", "reached", "done", "oob"):
        assert torch.equal(getattr(final, name), getattr(ref, name)), name
    for got, want in ((final.x0, ref.x0), (final.min_margin, ref.min_margin),
                      (final.dist, ref.dist), (final.obst.pos, ref.obst.pos),
                      (final.rti.x_traj, ref.rti.x_traj)):
        torch.testing.assert_close(got, want, rtol=0, atol=1e-10)
    assert stats == _stats_of(metrics_of(final))
    assert stats["n"] == B and stats["min_margin"] == float(final.min_margin.min())


@pytest.mark.parametrize("backend", BACKENDS)
def test_every_backend_shards(backend):
    """Each batched-tick backend runs sharded and gives the unsharded rows
    (4 shards, 4 ticks)."""
    kw = dict(n_runs=8, max_iter=4, dtype=torch.float64, backend=backend)
    ref = run_scenario_batch(SPEC, OPTS, "RANDOM", device="cpu", **kw)
    got = run_scenario_batch(SPEC, OPTS, "RANDOM", mesh=make_data_mesh(CPU8[:4]), **kw)
    np.testing.assert_array_equal(got[:, [0, 1, 4, 5]], ref[:, [0, 1, 4, 5]])
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-10)


def test_port_matches_jax_sharded_rollout():
    """JAX's make_sharded_rollout over make_batched_rollout(xla,
    random_move=False) on its 8-device CPU mesh, and the port's over 8 CPU
    shards (backend torch, the same start carried across): rows within
    1e-8 in float64, statistics equal."""
    jspec, jopts = JSpec(tf=1.0, n_solv=5, qp_iter=8), JOptions(qp_iter=8, integrator="rk4")
    jc = j_make(jspec, jopts, dtype=jnp.float64)
    start, goal = robot_start_goal(jspec)
    st = j_init(jax.random.PRNGKey(0), jc, jnp.asarray(start), goal, "RANDOM",
                batch_shape=(B,))
    jfn = jax.jit(j_sharded(j_rollout(jc, goal, j_params(jspec, dtype=jnp.float64),
                                      max_iter=TICKS, backend="xla", random_move=False),
                            j_mesh()))
    jfinal, jstats = jfn(j_shard(st, j_mesh()))
    jm = jax.tree.map(np.asarray, jax.vmap(j_metrics)(jfinal))

    ctrl = make_rti_controller(SPEC, OPTS, dtype=torch.float64, device="cpu")
    ts = interop.loop_state_from_numpy(jax.tree.map(np.asarray, st), "cpu", torch.float64)
    mesh = make_data_mesh(CPU8)
    fn = make_sharded_rollout(ctrl, goal, default_cost_params(SPEC, dtype=torch.float64,
                                                              device="cpu"),
                              mesh, max_iter=TICKS, random_move=False, backend="torch")
    shards, stats = fn(shard_leading_axis(ts, mesh))
    m = metrics_of(_cat(shards))
    for name in ("hit", "reached", "steps", "oob"):
        np.testing.assert_array_equal(getattr(m, name).numpy(), getattr(jm, name), err_msg=name)
    for name in ("min_margin", "dist"):
        np.testing.assert_allclose(getattr(m, name).numpy(), getattr(jm, name), rtol=0,
                                   atol=1e-8, err_msg=name)
    for k in ("n", "reached", "hit", "oob", "steps_sum"):
        assert stats[k] == float(jstats[k]), k
    # JAX reduces min_margin in float32
    assert stats["min_margin"] == pytest.approx(float(jstats["min_margin"]), rel=1e-6)


def test_shard_layout_and_errors():
    ctrl, _, _, state, _ = _start()
    mesh = make_data_mesh(CPU8)
    assert isinstance(mesh, DataMesh) and mesh.size == 8 and mesh.group is None
    shards = shard_leading_axis(state, mesh)
    assert len(shards) == 8 and {s.x0.shape[0] for s in shards} == {2}
    assert torch.equal(_cat(shards).obst.vel, state.obst.vel)
    with pytest.raises(ValueError, match="not divisible"):
        shard_leading_axis(state, make_data_mesh(CPU8[:3]))
    with pytest.raises(ValueError, match="at least one device"):
        make_data_mesh([])


def test_default_mesh_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default mesh is valid")
    with pytest.raises(RuntimeError, match="cuda"):
        make_data_mesh()


def test_compat_rng_with_mesh_raises():
    with pytest.raises(ValueError, match="compat_rng"):
        run_scenario_batch(SPEC, OPTS, "RANDOM", n_runs=8, max_iter=1,
                           dtype=torch.float64, mesh=make_data_mesh(CPU8), compat_rng=True)
