"""Replay cells of a committed parity leg with the JAX package on the CPU.

``scripts/parity_seedmatch.py`` holds each cell to the reference's own
CSVs, which are not in the repository. This script runs the same
rollout (the same options, built as that script builds them, on the
reference's exact MT19937 worlds and noise) and holds each seed to the
leg's committed ``<stamp>_<scenario>_ours.csv`` instead. With ``--f64``
it is the double-precision witness for a cell whose f32 runs disagree:

    JAX_PLATFORMS=cpu python scripts/parity_jax_cell.py \
        --leg results/parity_r5/v0_baseline --only 225145 --f64 --out DIR

writes ``<stamp>_<scenario>_ours.csv`` (7 columns, the 7th the status-4
analogue's firings) and ``summary.json`` (rates, resets, the seeds that
fail at most ticks, per-seed agreement with the leg's CSV, wall seconds).
The leg's settings (status-4, the cost-scaling knobs, the integrator)
come from its ``summary.json``; the backend is ``xla``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--leg", required=True)
    ap.add_argument("--only", default=None)
    ap.add_argument("--f64", action="store_true")
    ap.add_argument("--seeds", type=int, default=None)
    ap.add_argument("--max-iter", type=int, default=400)
    ap.add_argument("--qp-iter-override", type=int, default=None)
    ap.add_argument("--stall", type=int, default=300,
                    help="a seed with at least this many resets counts as stalled")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)

    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    jax.config.update("jax_platforms", "cpu")
    if args.f64:
        jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    from doa_mpc_tpu.config import SolverOptions, WorldSpec, default_cost_params
    from doa_mpc_tpu.sim.closed_loop import init_loop_state, make_batched_rollout, metrics_of
    from doa_mpc_tpu.sim.compat_rng import mt_experiment_batch
    from doa_mpc_tpu.sim.obstacles import robot_start_goal

    from doa_mpc_tpu.solver.sqp_rti import make_rti_controller

    with open(os.path.join(args.leg, "summary.json")) as f:
        meta = json.load(f)
    cells = [c for c in meta["cells"]
             if not args.only or args.only in c["stamp"] or args.only in c["scenario"]]
    dtype = jnp.float64 if args.f64 else jnp.float32
    os.makedirs(args.out, exist_ok=True)
    out = []
    for c in cells:
        ref = np.loadtxt(os.path.join(args.leg, f"{c['stamp']}_{c['scenario']}_ours.csv"),
                         delimiter=";", ndmin=2)[:args.seeds]
        spec = WorldSpec(tf=c["tf"], n_solv=c["n_solv"], n_obst=c["n_obst"], qp_iter=c["qp_iter"])
        opts = SolverOptions(
            qp_iter=args.qp_iter_override or c["qp_iter"], integrator=meta["integrator"],
            compat_pred_bug=True, cost_scale_dt=meta["cost_scale_dt"],
            slack_scale_dt=meta["slack_scale_dt"], lm_scale_dt=meta["lm_scale_dt"],
            init_guess_when_error=meta["status4"], compat_brake_bug=meta["status4"],
            fail_mu_tol=meta["fail_mu_tol"], fail_stat_tol=meta["fail_stat_tol"],
            init_guess="interpolate" if c["interpolate"] else "current")
        ctrl = make_rti_controller(spec, opts, dtype=dtype)
        params = default_cost_params(spec, dtype=dtype)
        if meta["slack_mult"]:
            import dataclasses
            params = dataclasses.replace(params, slack_scale=params.slack_scale * meta["slack_mult"])
        start, goal = robot_start_goal(spec)
        obst, noise = mt_experiment_batch(range(len(ref)), spec, c["scenario"],
                                          max_iter=args.max_iter,
                                          dtype=np.float64 if args.f64 else np.float32)
        t0 = time.time()
        st0 = init_loop_state(jax.random.PRNGKey(0), ctrl, jnp.asarray(start, dtype), goal,
                              batch_shape=(len(ref),), obst=obst)
        fin = jax.jit(make_batched_rollout(ctrl, goal, params, max_iter=args.max_iter,
                                           backend="xla", use_noise_traj=True))(
            st0, jnp.asarray(noise))
        m = jax.vmap(metrics_of)(fin)
        data = np.stack([np.asarray(a, np.float64) for a in
                         (m.hit, m.reached, m.min_margin, m.dist, m.steps, m.oob, fin.resets)],
                        axis=1)
        wall = time.time() - t0
        np.savetxt(os.path.join(args.out, f"{c['stamp']}_{c['scenario']}_ours.csv"), data,
                   delimiter=";")
        both = (data[:, 1] == 1) & (ref[:, 1] == 1)
        row = dict(stamp=c["stamp"], scenario=c["scenario"], qp_iter=opts.qp_iter,
                   f64=bool(args.f64), runs=len(data), hit=float(data[:, 0].mean()),
                   reached=float(data[:, 1].mean()), resets_mean=float(data[:, 6].mean()),
                   stalled=np.flatnonzero(data[:, 6] >= args.stall).tolist(),
                   csv_hit=float(ref[:, 0].mean()), csv_reached=float(ref[:, 1].mean()),
                   csv_resets_mean=float(ref[:, 6].mean()),
                   csv_stalled=np.flatnonzero(ref[:, 6] >= args.stall).tolist(),
                   agree_hit=float((data[:, 0] == ref[:, 0]).mean()),
                   agree_reached=float((data[:, 1] == ref[:, 1]).mean()),
                   coreached_resets=float(data[both, 6].mean()) if both.any() else None,
                   csv_coreached_resets=float(ref[both, 6].mean()) if both.any() else None,
                   wall_s=wall)
        out.append(row)
        print(json.dumps(row), flush=True)
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(dict(leg=args.leg, engine="doa_mpc_tpu (JAX, CPU, xla)", cells=out), f, indent=1)


if __name__ == "__main__":
    main()
