"""Batched Monte-Carlo experiment harness (``doa_mpc_tpu/sim/experiments.py``).

All seeds of a configuration run as one batched closed-loop rollout, on one
device or sharded over a ``parallel.mesh.DataMesh`` (several devices and
processes; process 0 alone writes). The artifacts keep the reference's
schema:

- ``<stamp>_experiment_data.csv``: one row per seed, ``;``-delimited, columns
  (hit, reached_goal, min_margin, final_dist, steps, out_of_bounds);
- ``<stamp>_experiment_spec.json``: the configuration dictionary, plus
  provenance keys (``engine``, ``device``, ...).

The reference's configuration sweeps (TF x N_OBST and the QP iteration
budget) are loops over fresh ``WorldSpec``/``SolverOptions`` values, each
written as one CSV/JSON pair per scenario.
"""

from __future__ import annotations

import json
import os
import time
from datetime import datetime
from typing import Iterable, Sequence

import numpy as np
import torch

from doa_mpc_tpu_torch.config import (
    CostParams, SolverOptions, WorldSpec, default_cost_params, resolve_device,
)
from doa_mpc_tpu_torch.parallel import distributed, mesh as pmesh
from doa_mpc_tpu_torch.sim.closed_loop import (
    init_loop_state, make_batched_rollout, metrics_of,
)
from doa_mpc_tpu_torch.sim.obstacles import ObstacleState, robot_start_goal
from doa_mpc_tpu_torch.solver.sqp_rti import make_rti_controller


def run_scenario_batch(spec: WorldSpec, opts: SolverOptions, scenario: str | Sequence[str],
                       n_runs: int = 100, max_iter: int = 400,
                       seed: int = 0, dtype=torch.float32,
                       params: CostParams | None = None,
                       mesh=None, start_goal_margin: float = 1.0,
                       backend: str = "fused", return_state: bool = False,
                       compat_rng: bool = False, device="cuda"):
    """Run ``n_runs`` seeded scenarios in one batched rollout on ``device``.

    The robot starts at (X_MIN + margin, Y_MIN + margin) heading pi/4 and
    aims at (X_MAX - margin, Y_MAX - margin), ``margin`` being
    ``start_goal_margin``. Returns a (n_runs, 6) float64 metrics array in
    the reference CSV column order, and with ``return_state`` also the final
    ``LoopState``. ``compat_rng`` replays the reference's MT19937 worlds and
    noise (row i uses ``np.random.seed(i)``); otherwise worlds and noise come from
    a ``torch.Generator`` seeded with ``seed``. With ``compat_rng``,
    ``scenario`` may be a sequence: its scenarios' worlds and noise are
    concatenated into one rollout, ``n_runs`` rows each in its order (the
    scenario only places the obstacles; ``sim.parity`` runs a cell's
    RANDOM and EDGE seeds so). ``backend`` is one of
    ``sim.closed_loop.BACKENDS`` ('fused', 'torch', 'riccati', 'zero').

    With ``mesh`` (``parallel.mesh.make_data_mesh``) the rows run on the
    mesh's devices (``device`` is not used): every process builds the
    whole batch's start from the generator on its first mesh device, keeps
    its block of rows (``parallel.distributed.host_shard_bounds``) and runs
    it sharded over its devices, each tick's noise drawn for the whole
    batch; the metric rows are then gathered, so every process returns all
    ``n_runs`` rows, equal to the unsharded run's on the same device type.
    ``return_state`` then returns this process's rows only, on its first
    mesh device. ``compat_rng`` does not combine with ``mesh``."""
    if compat_rng and mesh is not None:
        raise ValueError("compat_rng does not support mesh sharding")
    if not compat_rng and not isinstance(scenario, str):
        raise ValueError("a sequence of scenarios needs compat_rng")
    dev = mesh.devices[0] if mesh is not None else resolve_device(device)
    ctrl = make_rti_controller(spec, opts, dtype=dtype, device=dev)
    params = params or default_cost_params(spec, dtype=dtype, device=dev)
    start, goal = robot_start_goal(spec, margin=start_goal_margin)

    if mesh is not None:
        gen = torch.Generator(device=dev).manual_seed(seed)
        state = init_loop_state(ctrl, start, goal, scenario, batch_shape=(n_runs,),
                                generator=gen)
        lo, hi = distributed.host_shard_bounds(n_runs)
        shards = distributed.make_global_batch(pmesh.tree_map(lambda a: a[lo:hi], state), mesh)
        rollout = pmesh.make_sharded_rollout(ctrl, goal, params, mesh, max_iter=max_iter,
                                             backend=backend, generator=gen)
        shards, _stats = rollout(shards)
        rows = torch.cat([_metric_rows(s).cpu() for s in shards])
        data = distributed.gather_rows(rows).numpy()
        if return_state:
            return data, pmesh.tree_map(lambda *a: torch.cat([x.to(dev) for x in a]), *shards)
        return data

    if compat_rng:
        from doa_mpc_tpu_torch.sim.compat_rng import mt_experiment_batch
        scenarios = [scenario] if isinstance(scenario, str) else list(scenario)
        streams = [mt_experiment_batch(range(n_runs), spec, s, max_iter=max_iter,
                                       dtype=np.float64 if dtype == torch.float64 else np.float32)
                   for s in scenarios]
        obst = ObstacleState(*(np.concatenate([o[i] for o, _ in streams]) for i in range(2)))
        noise = np.concatenate([n for _, n in streams], axis=1)
        state = init_loop_state(ctrl, start, goal, batch_shape=(len(scenarios) * n_runs,),
                                obst=obst)
        rollout = make_batched_rollout(ctrl, goal, params, max_iter=max_iter,
                                       backend=backend, use_noise_traj=True)
        final = rollout(state, torch.as_tensor(noise, device=dev))
    else:
        gen = torch.Generator(device=dev).manual_seed(seed)
        state = init_loop_state(ctrl, start, goal, scenario, batch_shape=(n_runs,),
                                generator=gen)
        rollout = make_batched_rollout(ctrl, goal, params, max_iter=max_iter,
                                       backend=backend, generator=gen)
        final = rollout(state)

    data = _metric_rows(final).cpu().numpy()
    if return_state:
        return data, final
    return data


def _metric_rows(state) -> torch.Tensor:
    """The (B, 6) float64 rows of the reference CSV."""
    return torch.stack([a.to(torch.float64) for a in metrics_of(state)], dim=1)


def _fresh_stamp(out_dir: str) -> str:
    """The reference's ``%Y%m%d_%H%M%S`` file stamp, not yet taken in
    ``out_dir``: two short runs within one second would otherwise overwrite
    each other's pair, so the second waits for the next second."""
    while True:
        stamp = datetime.now().strftime("%Y%m%d_%H%M%S")
        if not os.path.exists(os.path.join(out_dir, f"{stamp}_experiment_spec.json")):
            return stamp
        time.sleep(0.05)


def run_experiment(spec: WorldSpec | None = None,
                   opts: SolverOptions | None = None,
                   scenarios: Sequence[str] = ("RANDOM", "EDGE"),
                   n_runs: int = 100, max_iter: int = 400,
                   out_dir: str = "test_data/new",
                   dtype=torch.float32, mesh=None, verbose: bool = True,
                   backend: str = "fused", compat_rng: bool = False, device="cuda"):
    """Per scenario, run the seeded batch and write CSV + spec JSON;
    ``verbose`` prints each scenario's size and rates. With ``mesh`` the
    batch runs sharded (:func:`run_scenario_batch`) and only process 0
    creates ``out_dir``, writes and prints."""
    spec = spec or WorldSpec()
    opts = opts or SolverOptions(qp_iter=spec.qp_iter)
    dev = mesh.devices[0] if mesh is not None else resolve_device(device)
    write = distributed.is_host0()
    if write:
        os.makedirs(out_dir, exist_ok=True)
    results = {}
    for s in scenarios:
        if verbose and write:
            where = dev if mesh is None else f"{mesh.size} shard(s)"
            print(f"{s}: solving {n_runs} scenarios (N={spec.n_solv}, "
                  f"M={spec.n_obst}, qp_iter={opts.qp_iter}) on {where}")
        data = run_scenario_batch(spec, opts, s, n_runs=n_runs, max_iter=max_iter,
                                  dtype=dtype, mesh=mesh, backend=backend,
                                  compat_rng=compat_rng, device=dev)
        results[s] = data
        if not write:
            continue
        stamp = _fresh_stamp(out_dir)
        np.savetxt(os.path.join(out_dir, f"{stamp}_experiment_data.csv"), data,
                   delimiter=";")
        exp = {
            "slack": True, "random_move": True,
            "init_guess": opts.init_guess_when_error,
            "scenario": s, "TF": spec.tf, "N_SOLV": spec.n_solv,
            "N_OBST": spec.n_obst, "QP_ITER": opts.qp_iter,
            "engine": "doa_mpc_tpu_torch", "integrator": opts.integrator,
            "dtype": str(dtype).replace("torch.", ""),
            "compat_pred_bug": opts.compat_pred_bug,
            "compat_rng": compat_rng,
            "fail_mu_tol": opts.fail_mu_tol,
            "fail_stat_tol": opts.fail_stat_tol,
            "backend": backend,
            "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                       else str(dev)),
        }
        if opts.init_guess == "interpolate":
            exp["interpolate_init"] = True
        with open(os.path.join(out_dir, f"{stamp}_experiment_spec.json"), "w") as f:
            json.dump(exp, f)
        if verbose:
            print(f"  collision={data[:, 0].mean():.2%} "
                  f"reached={data[:, 1].mean():.2%} "
                  f"oob={data[:, 5].mean():.2%} "
                  f"median_steps={np.median(data[:, 4]):.0f}")
    return results


def run_horizon_sweep(tf_values: Iterable[float] = (0.5, 1, 1.5, 2, 2.5, 3),
                      n_obst_values: Iterable[int] = (5, 10, 15, 20, 25, 30),
                      **kw):
    """The reference's TF x N_OBST sweep: one :func:`run_experiment` per
    point with N = int(tf * 10) and the default (IRK) solver options;
    ``kw`` goes to :func:`run_experiment`."""
    out = {}
    for tf in tf_values:
        for m in n_obst_values:
            spec = WorldSpec(tf=float(tf), n_solv=int(tf * 10), n_obst=int(m))
            out[(tf, m)] = run_experiment(spec=spec, **kw)
    return out


def run_qp_iter_sweep(qp_iters: Iterable[int] = (25, 50, 100, 150), **kw):
    """The reference's QP iteration-budget sweep: one :func:`run_experiment`
    per budget, default world and (IRK) solver options otherwise."""
    out = {}
    for it in qp_iters:
        spec = WorldSpec(qp_iter=int(it))
        opts = SolverOptions(qp_iter=int(it))
        out[it] = run_experiment(spec=spec, opts=opts, **kw)
    return out
