"""``doa_mpc_tpu_torch.sim.parity`` against ``scripts/parity_seedmatch.py``:
the options it builds for every committed leg of the round-5 matrix, the
paired RANDOM+EDGE batch against the two cells run apart and against JAX's
rows, and the files ``summarize`` writes, all on the CPU at tiny sizes."""

import glob
import importlib
import json
import os
import sys

import numpy as np
import pytest
import torch

import doa_mpc_tpu.sim.closed_loop as j_closed_loop
import doa_mpc_tpu.sim.compat_rng as j_compat_rng
import doa_mpc_tpu.solver.sqp_rti as j_sqp_rti
from doa_mpc_tpu_torch.sim import parity

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARITY = os.path.join(REPO, "results", "parity_r5")
LEGS = sorted(os.path.relpath(os.path.dirname(p), PARITY)
              for p in glob.glob(os.path.join(PARITY, "**", "summary.json"), recursive=True))

# the flags each TPU run was given beyond what its summary.json records
# (results/parity_r5/forensics.md; the directory names of qp_budget/)
EXTRA_FLAGS = {
    "prod_rk4_qp6": ["--qp-iter-override", "6"],
    "prod_fixedbug": ["--qp-iter-override", "6", "--fix-pred-bug"],
    "qp_budget/qp6": ["--qp-iter-override", "6"],
    "qp_budget/qp4": ["--qp-iter-override", "4"],
}


def _jax_flags(meta):
    """The JAX replay script's command line that writes ``meta``."""
    flags = ["--backend", meta["backend"], "--integrator", meta["integrator"],
             "--fail-mu", repr(meta["fail_mu_tol"]), "--fail-stat", repr(meta["fail_stat_tol"])]
    for on, flag in ((meta["status4"], "--status4"), (not meta["slack_scale_dt"], "--slack-unscaled"),
                     (not meta["cost_scale_dt"], "--cost-unscaled"),
                     (meta["cost_scale_dt"] and not meta["lm_scale_dt"], "--lm-raw"),
                     (meta["f64"], "--f64")):
        flags += [flag] if on else []
    if meta["slack_mult"]:
        flags += ["--slack-mult", repr(meta["slack_mult"])]
    if meta["seeds"]:
        flags += ["--seeds", str(meta["seeds"])]
    return flags


class _Built(Exception):
    """Raised where the JAX replay script would start the cell's rollout."""


def _jax_build(monkeypatch, tmp_path, cells, argv):
    """Run ``parity_seedmatch.main`` on ``argv`` up to its first cell's
    rollout (the reference CSVs are not in the repository, and nothing
    after the options matters here); returns the spec, options, dtype,
    cost parameters and backend it built."""
    monkeypatch.syspath_prepend(os.path.join(REPO, "scripts"))
    seedmatch = importlib.import_module("parity_seedmatch")
    got = {}

    def controller(spec, opts, dtype):
        got.update(spec=spec, opts=opts, dtype=dtype)
        return object()

    def rollout(ctrl, goal, params, max_iter, backend, use_noise_traj):
        got.update(params=params, backend=backend, max_iter=max_iter)
        raise _Built

    with monkeypatch.context() as mp:
        mp.setenv("JAX_PLATFORMS", "cpu")
        mp.setattr(sys, "argv", ["parity_seedmatch.py", "--out", str(tmp_path)] + argv)
        mp.setattr(seedmatch, "load_reference_cells", lambda: cells)
        mp.setattr(np, "loadtxt", lambda *a, **k: np.zeros((100, 6)))
        mp.setattr(j_sqp_rti, "make_rti_controller", controller)
        mp.setattr(j_compat_rng, "mt_experiment_batch", lambda *a, **k: (None, np.zeros(1)))
        mp.setattr(j_closed_loop, "init_loop_state", lambda *a, **k: None)
        mp.setattr(j_closed_loop, "make_batched_rollout", rollout)
        with pytest.raises(_Built):
            seedmatch.main()
    return got


@pytest.mark.parametrize("name", LEGS)
def test_leg_options_match_parity_seedmatch(name, monkeypatch, tmp_path):
    """For every committed leg and cell, the port's settings from the leg's
    meta build the WorldSpec, SolverOptions, dtype, slack scale and backend
    that the JAX replay script builds from the flags the TPU run was given."""
    leg = parity.load_leg(os.path.join(PARITY, name))
    assert leg.name == name and len(leg.cells) in (2, 10)
    s = parity.leg_settings(leg)
    assert s.status4 == leg.meta["status4"] and s.f64 == leg.meta["f64"]
    assert s.backend == parity.BACKEND_OF[leg.meta["backend"]]
    assert (s.qp_iter_override, s.fix_pred_bug) == {
        "prod_rk4_qp6": (6, False), "prod_fixedbug": (6, True), "qp_budget/qp6": (6, False),
        "qp_budget/qp4": (4, False)}.get(name, (None, False))
    jax_cells = [{k: v for k, v in c.items() if k != "tpu"} for c in leg.cells]
    for c in leg.cells:
        assert c["tpu"].shape == (100, 7)
        want = _jax_build(monkeypatch, tmp_path, jax_cells,
                          _jax_flags(leg.meta) + EXTRA_FLAGS.get(name, []) + ["--only", c["stamp"]])
        spec, opts = parity.cell_config(c, s)
        for f in ("tf", "n_solv", "n_obst", "qp_iter"):
            assert getattr(spec, f) == getattr(want["spec"], f), f
        for f in parity.SolverOptions.__dataclass_fields__:
            assert getattr(opts, f) == getattr(want["opts"], f), (c["stamp"], f)
        assert opts.compat_brake_bug == opts.init_guess_when_error == leg.meta["status4"]
        assert s.f64 == (np.dtype(want["dtype"]) == np.float64)
        assert parity.BACKEND_OF[want["backend"]] == s.backend and want["max_iter"] == s.max_iter
        ours = parity.cost_params(spec, s, dtype=torch.float64, device="cpu")
        assert float(ours.slack_scale) == float(want["params"].slack_scale)
    assert len(parity.plan(leg.cells, s)) == {10: 5, 2: 1}[len(leg.cells)] - (
        2 if s.qp_iter_override and len(leg.cells) == 10 else 0)


def _small_cells():
    base = dict(tf=0.6, n_solv=6, n_obst=3, qp_iter=4, interpolate=False, ref_hit=0.5,
                ref_reached=0.5, ref_oob=0.0, ref_runs=3)
    return [dict(base, stamp="20990101_000001", scenario="RANDOM"),
            dict(base, stamp="20990101_000002", scenario="EDGE")]


def test_paired_batch_equals_cells_run_apart():
    """One batch of RANDOM + EDGE rows gives, bit for bit, the rows and final
    states of the two cells run apart (f64, CPU, IRK, status-4 armed)."""
    s = parity.Settings(status4=True, f64=True, max_iter=6)
    cells = _small_cells()
    (group,) = parity.plan(cells, s)
    assert group == cells
    rows, final, _ = parity.run_group(group, s, 3, device="cpu")
    assert set(rows) == {"RANDOM", "EDGE"} and final.x0.shape == (6, 5)
    for i, c in enumerate(cells):
        alone, fin_alone, _ = parity.run_group([c], s, 3, device="cpu")
        np.testing.assert_array_equal(rows[c["scenario"]], alone[c["scenario"]])
        np.testing.assert_array_equal(final.x0[3 * i:3 * i + 3].numpy(), fin_alone.x0.numpy())
        np.testing.assert_array_equal(final.rti.u_traj[3 * i:3 * i + 3].numpy(),
                                      fin_alone.rti.u_traj.numpy())
        assert rows[c["scenario"]].shape == (3, 7) and np.isfinite(rows[c["scenario"]]).all()


@pytest.mark.parametrize("settings", [dict(), dict(status4=True, slack_unscaled=True)],
                         ids=["plain", "status4_slackraw"])
def test_paired_rows_match_jax(settings):
    """The rows of a paired RANDOM + EDGE run (``run_group``, through the
    port's ``run_scenario_batch``) against JAX's ``run_scenario_batch`` on
    each cell's compat_rng worlds alone (``xla``, f64, IRK): the discrete
    columns and the resets exactly, margin and distance to 1e-6."""
    import dataclasses

    import jax.numpy as jnp
    from doa_mpc_tpu.config import SolverOptions as JOptions, WorldSpec as JSpec
    from doa_mpc_tpu.config import default_cost_params as j_params
    from doa_mpc_tpu.sim.experiments import run_scenario_batch as j_run

    s = parity.Settings(f64=True, max_iter=6, **settings)
    cells = _small_cells()
    rows, _, _ = parity.run_group(cells, s, 3, device="cpu")
    fired = 0
    for c in cells:
        spec, opts = parity.cell_config(c, s)
        jspec = JSpec(tf=spec.tf, n_solv=spec.n_solv, n_obst=spec.n_obst, qp_iter=spec.qp_iter)
        jopts = JOptions(**dataclasses.asdict(opts))
        jparams = j_params(jspec, dtype=jnp.float64)
        want, fin = j_run(jspec, jopts, c["scenario"], n_runs=3, max_iter=s.max_iter,
                          dtype=jnp.float64, params=jparams, backend="xla",
                          return_state=True, compat_rng=True)
        got = rows[c["scenario"]]
        np.testing.assert_array_equal(got[:, [0, 1, 4, 5]], want[:, [0, 1, 4, 5]])
        np.testing.assert_allclose(got[:, [2, 3]], want[:, [2, 3]], rtol=0, atol=1e-6)
        np.testing.assert_array_equal(got[:, 6], np.asarray(fin.resets, np.float64))
        fired += int(got[:, 6].sum())
    assert (fired > 0) == s.status4


def test_summarize_writes_the_jax_schema(tmp_path):
    """``python -m doa_mpc_tpu_torch.sim.parity`` on a two-cell leg made
    here: a 7-column CSV per cell and a summary.json holding every key the
    JAX replay script writes (taken from a committed leg), the per-seed comparison
    taken against the leg's TPU CSV, and a rerun of one cell merged in."""
    leg_dir = tmp_path / "tiny_leg"
    leg_dir.mkdir()
    with open(os.path.join(PARITY, "v0_baseline", "summary.json")) as f:
        jax_summary = json.load(f)
    meta = {k: v for k, v in jax_summary.items() if k != "cells"}
    meta.update(integrator="rk4", status4=False)
    rng = np.random.default_rng(0)
    tpu = {}
    for c in _small_cells():
        tpu[c["scenario"]] = np.column_stack([rng.integers(0, 2, (3, 2)), rng.random((3, 3)),
                                              rng.integers(0, 2, (3, 1)), rng.integers(0, 5, (3, 1))])
        np.savetxt(leg_dir / f"{c['stamp']}_{c['scenario']}_ours.csv", tpu[c["scenario"]],
                   delimiter=";")
    with open(leg_dir / "summary.json", "w") as f:
        json.dump(dict(meta, cells=_small_cells()), f)
    out = tmp_path / "out"
    summary = parity.main(["--leg", str(leg_dir), "--device", "cpu", "--max-iter", "3",
                           "--out", str(out)])
    written = json.load(open(out / "summary.json"))
    assert set(jax_summary) <= set(written) and written["leg"] == "tiny_leg"
    assert written["integrator"] == "rk4" and written["backend"] == "fused"
    assert len(written["cells"]) == 2
    for cell in written["cells"]:
        assert set(jax_summary["cells"][0]) <= set(cell)
        data = np.loadtxt(out / f"{cell['stamp']}_{cell['scenario']}_ours.csv", delimiter=";")
        ref = tpu[cell["scenario"]]
        assert data.shape == (3, 7) and np.isfinite(data).all()
        assert cell["agree_hit"] == (data[:, 0] == ref[:, 0]).mean()
        assert cell["hit_we_only"] == ((data[:, 0] == 1) & (ref[:, 0] == 0)).sum()
        assert cell["tpu_resets_mean"] == ref[:, 6].mean() and cell["runs"] == 3
        assert cell["hit_gap"] == cell["hit"] - 0.5 and cell["wall_s"] > 0
        assert cell["batch"] == [parity.cell_id(c) for c in _small_cells()]
        assert cell["batch_rows"] == 6
    assert written["aggregate"]["seeds"] == 6 and summary["cells"] == written["cells"]
    assert (out / "summary.md").read_text().count("| 20990101_") == 2
    parity.main(["--leg", str(leg_dir), "--device", "cpu", "--max-iter", "2", "--only", "EDGE",
                 "--out", str(out)])
    merged = json.load(open(out / "summary.json"))["cells"]
    assert [c["scenario"] for c in merged] == ["RANDOM", "EDGE"]
    assert merged[0] == written["cells"][0] and merged[1] != written["cells"][1]
    assert merged[1]["batch"] == ["20990101_000002_EDGE"] and merged[1]["batch_rows"] == 3
