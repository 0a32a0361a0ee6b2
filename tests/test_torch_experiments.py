"""The campaign tooling of the PyTorch port against the JAX package's: the
sweeps (grids, defaults and the CSV/JSON schema), ``evaluate``,
checkpoint/resume (including checkpoints that cross between the packages)
and the ``sweep``, ``qp-sweep``, ``evaluate`` and ``sim`` commands, all on
the CPU at tiny sizes."""

import functools
import glob
import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from doa_mpc_tpu.models.unicycle import dynamics as j_dynamics
from doa_mpc_tpu.ops.integrators import irk_step as j_irk
from doa_mpc_tpu.sim import checkpoint as j_checkpoint
from doa_mpc_tpu.sim import evaluate as j_evaluate
from doa_mpc_tpu.sim import experiments as j_experiments
from doa_mpc_tpu.solver.sqp_rti import RtiState as JRtiState
from doa_mpc_tpu_torch import cli
from doa_mpc_tpu_torch.config import SolverOptions, WorldSpec, default_cost_params
from doa_mpc_tpu_torch.sim import checkpoint, evaluate, experiments
from doa_mpc_tpu_torch.sim.closed_loop import (
    LoopState, init_loop_state, make_batched_rollout)
from doa_mpc_tpu_torch.sim.compat_rng import mt_experiment_batch
from doa_mpc_tpu_torch.sim.obstacles import robot_start_goal
from doa_mpc_tpu_torch.solver.sqp_rti import RtiState, make_rti_controller

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QUALITY = os.path.join(REPO, "results", "quality_r1")


def _record_points(monkeypatch, module):
    """Replace ``module.run_experiment`` by a recorder of its arguments."""
    seen = []

    def fake(spec=None, opts=None, **kw):
        seen.append((spec, opts, kw))
        return {}

    monkeypatch.setattr(module, "run_experiment", fake)
    return seen


def _as_tuple(cfg):
    return None if cfg is None else tuple(getattr(cfg, f) for f in cfg.__dataclass_fields__)


def test_sweep_grids_match_jax(monkeypatch):
    """Every point of both default grids: the same WorldSpec and
    SolverOptions (the defaults, i.e. IRK) as the JAX sweeps build, with N =
    int(tf * 10) (0.5 -> 5, 1.5 -> 15, 2.5 -> 25)."""
    got = _record_points(monkeypatch, experiments)
    want = _record_points(monkeypatch, j_experiments)
    for run in (lambda m: m.run_horizon_sweep(n_runs=3),
                lambda m: m.run_qp_iter_sweep(n_runs=3)):
        run(experiments)
        run(j_experiments)
    assert len(got) == len(want) == 36 + 4
    for (s, o, kw), (js, jo, jkw) in zip(got, want):
        assert _as_tuple(s) == _as_tuple(js) and _as_tuple(o) == _as_tuple(jo)
        assert kw == jkw == {"n_runs": 3}
    assert [s.n_solv for s, _, _ in got[:36:6]] == [5, 10, 15, 20, 25, 30]
    assert {o.integrator for _, o, _ in got[36:]} == {"irk"}


def _jax_spec_keys(tmp_path, monkeypatch, **kw):
    """The JSON keys the JAX package writes for one point (its rollout is
    replaced by zeros: the schema comes from ``run_experiment``)."""
    monkeypatch.setattr(j_experiments, "run_scenario_batch",
                        lambda spec, opts, s, n_runs=100, **_: np.zeros((n_runs, 6)))
    out = tmp_path / "jax"
    j_experiments.run_experiment(out_dir=str(out), n_runs=2, scenarios=("RANDOM",),
                                 verbose=False, **kw)
    (path,) = glob.glob(str(out / "*_experiment_spec.json"))
    return set(json.load(open(path)))


def _pairs(out):
    specs = sorted(glob.glob(str(out / "*_experiment_spec.json")))
    return [(json.load(open(p)), np.loadtxt(p[:-len("spec.json")] + "data.csv", delimiter=";"))
            for p in specs]


def test_sweeps_write_the_jax_schema(tmp_path, monkeypatch):
    """Tiny grids (2 runs, 5 ticks): one CSV/JSON pair per point and
    scenario, the JAX package's JSON keys plus ``device``, finite rows."""
    keys = _jax_spec_keys(tmp_path, monkeypatch) | {"device"}
    out = tmp_path / "sweep"
    res = experiments.run_horizon_sweep(tf_values=(0.5, 1.0), n_obst_values=(2,),
                                        n_runs=2, max_iter=5, out_dir=str(out),
                                        device="cpu", verbose=False)
    assert set(res) == {(0.5, 2), (1.0, 2)}
    pairs = _pairs(out)
    assert len(pairs) == 4
    for spec, data in pairs:
        assert set(spec) == keys
        assert spec["engine"] == "doa_mpc_tpu_torch" and spec["device"] == "cpu"
        assert spec["integrator"] == "irk" and spec["backend"] == "fused"
        assert data.shape == (2, 6) and np.isfinite(data).all()
        assert spec["N_SOLV"] == int(spec["TF"] * 10) and spec["QP_ITER"] == 50
    out = tmp_path / "qp"
    experiments.run_qp_iter_sweep(qp_iters=(2, 3), n_runs=2, max_iter=5, out_dir=str(out),
                                  scenarios=("EDGE",), device="cpu", verbose=False)
    pairs = _pairs(out)
    assert [s["QP_ITER"] for s, _ in pairs] == [2, 3]
    assert all(set(s) == keys and np.isfinite(d).all() for s, d in pairs)


def test_defaults_run_irk_and_the_jax_arguments(tmp_path, capsys):
    """``run_experiment`` without options runs the default IRK controller;
    ``verbose``, ``start_goal_margin`` and ``return_state`` act as in JAX."""
    spec = WorldSpec(tf=0.3, n_solv=3, n_obst=2, qp_iter=2)
    ctrl = make_rti_controller(spec, device="cpu")
    assert ctrl.options.integrator == "irk"
    res = experiments.run_experiment(spec, scenarios=("CENTER",), n_runs=2, max_iter=2,
                                     out_dir=str(tmp_path), verbose=False, device="cpu")
    assert capsys.readouterr().out == ""
    ((exp, data),) = _pairs(tmp_path)
    assert exp["integrator"] == "irk" and exp["QP_ITER"] == 2
    np.testing.assert_array_equal(data, res["CENTER"])
    data, final = experiments.run_scenario_batch(
        spec, SolverOptions(qp_iter=2), "RANDOM", n_runs=2, max_iter=3,
        start_goal_margin=2.0, return_state=True, device="cpu")
    assert isinstance(final, LoopState) and np.isfinite(data).all()
    # the robot started at (X_MIN + 2, Y_MIN + 2) and aims at (X_MAX - 2, Y_MAX - 2)
    start, goal = robot_start_goal(spec, margin=2.0)
    assert start[0] == spec.x_min + 2.0 and goal[1] == spec.y_max - 2.0
    np.testing.assert_allclose(data[:, 3], torch.linalg.norm(
        final.x0[:, :2] - torch.as_tensor(goal, dtype=final.x0.dtype), dim=-1).numpy())


def test_summarize_matches_jax():
    got, want = evaluate.summarize(QUALITY), j_evaluate.summarize(QUALITY)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            assert g[k] == w[k], k
    for _, data in evaluate.load_experiment_data(QUALITY):
        assert evaluate.collision_ratio(data) == j_evaluate.collision_ratio(data)
        assert (evaluate.goal_ratio_excluding_collisions(data)
                == j_evaluate.goal_ratio_excluding_collisions(data))


def test_plots_render(tmp_path):
    pytest.importorskip("matplotlib")
    evaluate.plot_graph(QUALITY, str(tmp_path))
    evaluate.plot_graph_qp_solver(QUALITY, str(tmp_path))
    for name in ("plot_collision_rate_seperate.svg", "plot_goal_reached_rate_seperate.svg",
                 "plot_qp_iter.svg"):
        assert os.path.getsize(tmp_path / name) > 1000, name


# ---- checkpoint / resume ----------------------------------------------------

SPEC = WorldSpec(tf=0.5, n_solv=5, n_obst=3, qp_iter=6)
OPTS = SolverOptions(qp_iter=6)


def _setup(nb=4):
    ctrl = make_rti_controller(SPEC, OPTS, dtype=torch.float64, device="cpu")
    params = default_cost_params(SPEC, dtype=torch.float64, device="cpu")
    start, goal = robot_start_goal(SPEC)
    obst, noise = mt_experiment_batch(range(nb), SPEC, "RANDOM", max_iter=3,
                                      dtype=np.float64)
    st = init_loop_state(ctrl, start, goal, batch_shape=(nb,), obst=obst)
    roll = make_batched_rollout(ctrl, goal, params, max_iter=3, use_noise_traj=True)
    noise = torch.as_tensor(noise)
    return st, lambda s: roll(s, noise)


def _assert_same(a, b):
    for x, y in zip(checkpoint._flatten(a), checkpoint._flatten(b)):
        assert x.dtype == y.dtype and x.device == y.device
        np.testing.assert_array_equal(x.numpy(), y.numpy())


def test_checkpoint_round_trip(tmp_path):
    st, chunk = _setup()
    st = chunk(st)
    path = str(tmp_path / "ck.npz")
    checkpoint.save_state(path, st, {"note": "test"})
    back, meta = checkpoint.load_state(path, st)
    assert meta == {"note": "test"} and isinstance(back, LoopState)
    assert isinstance(back.rti, RtiState)
    _assert_same(back, st)
    # leaves take the dtype of ``like``
    like32 = LoopState(*[type(f)(*[t.float() for t in f]) if isinstance(f, tuple)
                         else (f.float() if f.is_floating_point() else f) for f in st])
    back32, _ = checkpoint.load_state(path, like32)
    assert back32.x0.dtype == torch.float32 and back32.steps.dtype == torch.int32


def test_chunked_resume_is_exact(tmp_path):
    st, chunk = _setup()
    ref = st
    for _ in range(4):
        ref = chunk(ref)
    path = str(tmp_path / "roll.npz")
    checkpoint.rollout_with_checkpoints(chunk, st, 2, path)       # then "crash"
    resumed = checkpoint.rollout_with_checkpoints(chunk, st, 4, path, resume=True)
    _assert_same(resumed, ref)
    assert checkpoint.load_state(path, st)[1]["chunk"] == 4


def test_checkpoint_shape_mismatch_rejected(tmp_path):
    st, _ = _setup(nb=4)
    path = str(tmp_path / "ck.npz")
    checkpoint.save_state(path, st)
    other, _ = _setup(nb=3)
    with pytest.raises(ValueError, match="shape"):
        checkpoint.load_state(path, other)
    with pytest.raises(ValueError, match="leaves"):
        checkpoint.load_state(path, st.rti)


def test_rti_state_checkpoints_cross_between_packages(tmp_path):
    rng = np.random.default_rng(0)
    x, u = rng.standard_normal((4, 6, 5)), rng.standard_normal((4, 5, 2))
    j_path, t_path = str(tmp_path / "jax.npz"), str(tmp_path / "torch.npz")
    j_checkpoint.save_state(j_path, JRtiState(jnp.asarray(x), jnp.asarray(u)), {"by": "jax"})
    like = RtiState(torch.zeros(4, 6, 5, dtype=torch.float64),
                    torch.zeros(4, 5, 2, dtype=torch.float64))
    got, meta = checkpoint.load_state(j_path, like)
    assert meta == {"by": "jax"}
    np.testing.assert_array_equal(got.x_traj.numpy(), x)
    np.testing.assert_array_equal(got.u_traj.numpy(), u)
    checkpoint.save_state(t_path, RtiState(torch.as_tensor(x), torch.as_tensor(u)),
                          {"by": "torch"})
    back, meta = j_checkpoint.load_state(
        t_path, JRtiState(jnp.zeros((4, 6, 5)), jnp.zeros((4, 5, 2))))
    assert meta == {"by": "torch"}
    np.testing.assert_array_equal(np.asarray(back.x_traj), x)
    np.testing.assert_array_equal(np.asarray(back.u_traj), u)


# ---- the commands ---------------------------------------------------------------

def _small_runs(monkeypatch):
    """Every run of the sweep commands: 2 ticks, one scenario."""
    monkeypatch.setattr(experiments, "run_experiment",
                        functools.partial(experiments.run_experiment, max_iter=2,
                                          scenarios=("RANDOM",)))


def test_cli_sweep_and_evaluate(tmp_path, monkeypatch, capsys):
    _small_runs(monkeypatch)
    monkeypatch.setattr(experiments, "run_horizon_sweep",
                        functools.partial(experiments.run_horizon_sweep,
                                          tf_values=(0.5, 1.0), n_obst_values=(2, 3)))
    out = tmp_path / "sweep"
    cli.main(["sweep", "--device", "cpu", "--runs", "2", "--out", str(out)])
    pairs = _pairs(out)
    assert sorted((s["TF"], s["N_OBST"]) for s, _ in pairs) == [
        (0.5, 2), (0.5, 3), (1.0, 2), (1.0, 3)]
    assert all(s["backend"] == "fused" and s["device"] == "cpu" for s, _ in pairs)
    capsys.readouterr()
    plots = tmp_path / "plots"
    pytest.importorskip("matplotlib")
    cli.main(["evaluate", "--data", str(out), "--out", str(plots)])
    rows = capsys.readouterr().out.strip().splitlines()
    assert rows == [str(r) for r in evaluate.summarize(str(out))]
    assert (plots / "plot_collision_rate_seperate.svg").exists()


def test_cli_qp_sweep_and_evaluate(tmp_path, monkeypatch, capsys):
    _small_runs(monkeypatch)
    monkeypatch.setattr(experiments, "run_qp_iter_sweep",
                        functools.partial(experiments.run_qp_iter_sweep, qp_iters=(2, 3)))
    out = tmp_path / "qp"
    cli.main(["qp-sweep", "--device", "cpu", "--runs", "2", "--backend", "torch",
              "--out", str(out)])
    pairs = _pairs(out)
    assert [s["QP_ITER"] for s, _ in pairs] == [2, 3]
    assert all(s["backend"] == "torch" and d.shape == (2, 6) for s, d in pairs)
    pytest.importorskip("matplotlib")
    cli.main(["evaluate", "--qp", "--data", str(out), "--out", str(tmp_path / "plots")])
    assert (tmp_path / "plots" / "plot_qp_iter.svg").exists()


def test_cli_sim_matches_jax_radau(capsys):
    cli.main(["sim", "--steps", "12", "--device", "cpu"])
    text = capsys.readouterr().out.replace("[", " ").replace("]", " ")
    got = np.array(text.split(), dtype=float).reshape(-1, 2)
    step = jax.jit(lambda x, u: j_irk(j_dynamics, x, u, 0.1, stages=3, newton_iter=3,
                                      tableau="radau_iia"))
    x = jnp.array([0.0, 0.0, np.pi / 4, 0.0, 0.0])
    want = [np.asarray(x[:2])]
    for i in range(12):
        x = step(x, jnp.array([1.0, 0.5]) if i < 10 else jnp.zeros(2))
        want.append(np.asarray(x[:2]))
    np.testing.assert_allclose(got, np.stack(want), rtol=0, atol=1e-5)


def test_cli_sweep_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is valid")
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["sweep", "--runs", "1"])


def test_cli_backend_auto_resolves_by_device(tmp_path, monkeypatch):
    """``--backend auto`` is ``torch`` on the CPU and ``fused`` on a CUDA
    device (decided from the device's name; no card needed); the default
    stays ``fused``, and the sweep's artifacts name the resolved backend."""
    assert cli.resolve_backend("auto", "cpu") == "torch"
    for name in ("cuda", "cuda:0", torch.device("cuda", 1)):
        assert cli.resolve_backend("auto", name) == "fused"
    assert cli.resolve_backend("riccati", "cpu") == "riccati"
    assert cli.build_parser().parse_args(["sweep"]).backend == "fused"
    _small_runs(monkeypatch)
    monkeypatch.setattr(experiments, "run_qp_iter_sweep",
                        functools.partial(experiments.run_qp_iter_sweep, qp_iters=(2,)))
    out = tmp_path / "qp"
    cli.main(["qp-sweep", "--device", "cpu", "--runs", "2", "--backend", "auto",
              "--out", str(out)])
    assert [s["backend"] for s, _ in _pairs(out)] == ["torch"]
