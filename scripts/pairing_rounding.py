"""Where a seed-matched cell's rows first round differently when it runs
behind the other scenario's rows (``doa_mpc_tpu_torch.sim.parity`` pairs a
RANDOM and an EDGE cell into one batch).

Both batches, the cell alone (B = n) and the cell behind n rows of the
other scenario (B = 2n), tick in lockstep on the cell's compat_rng worlds
and noise until the first tick whose carried state (x0, the warm start,
the obstacles) differs in a row of the cell. At that tick, from the
states before it (equal in those rows), each step of the tick is run at
both batch sizes, and the script prints, per step, the rows equal bit for
bit and the largest difference:

    python scripts/pairing_rounding.py --leg results/parity_r5/v1_nostatus4 --only 220136

It runs on a card (``--device cuda``, the default); on the CPU every row
stays equal.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from doa_mpc_tpu_torch.config import resolve_device  # noqa: E402
from doa_mpc_tpu_torch.ops.ip_fused import UNICYCLE_QP_STRUCTURE, solve_ocp_qp_fused  # noqa: E402
from doa_mpc_tpu_torch.ops.ocp_qp import OcpQp  # noqa: E402
from doa_mpc_tpu_torch.sim import parity  # noqa: E402
from doa_mpc_tpu_torch.sim.closed_loop import init_loop_state, make_batched_tick  # noqa: E402
from doa_mpc_tpu_torch.sim.compat_rng import mt_experiment_batch  # noqa: E402
from doa_mpc_tpu_torch.sim.obstacles import (  # noqa: E402
    ObstacleState, predict_trajectory, robot_start_goal,
)
from doa_mpc_tpu_torch.solver.sqp_rti import make_rti_controller  # noqa: E402


def pairing_rounding(s, cell, dev, n_runs=100, max_ticks=60):
    """The first tick at which ``cell``'s rows differ behind ``n_runs`` rows
    of the other scenario, and per step of that tick the rows equal bit for
    bit and the largest difference, as one line."""
    spec, opts = parity.cell_config(cell, s)
    dtype = torch.float64 if s.f64 else torch.float32
    other = "RANDOM" if cell["scenario"] == "EDGE" else "EDGE"
    worlds = [mt_experiment_batch(range(n_runs), spec, sc, max_iter=max_ticks,
                                  dtype=np.float64 if s.f64 else np.float32)
              for sc in (other, cell["scenario"])]
    obst = ObstacleState(*(np.concatenate([w[0][i] for w in worlds]) for i in range(2)))
    noise = torch.as_tensor(np.concatenate([w[1] for w in worlds], axis=1), device=dev)
    ctrl = make_rti_controller(spec, opts, dtype=dtype, device=dev)
    params = parity.cost_params(spec, s, dtype, dev)
    start, goal = robot_start_goal(spec)
    goal_t = torch.as_tensor(goal, dtype=dtype, device=dev)
    sizes = (n_runs, 2 * n_runs)
    tick = make_batched_tick(ctrl, goal, params, backend=s.backend)

    def rows_equal(v):
        a, p = v[n_runs].reshape(n_runs, -1), v[2 * n_runs][n_runs:].reshape(n_runs, -1)
        return int((a == p).all(1).sum()), float((a.double() - p.double()).abs().max())

    def carried(state, b):
        return torch.cat([a.reshape(b, -1) for a in (state.x0, *state.rti, state.obst.pos)], 1)

    st = {b: init_loop_state(ctrl, start, goal, batch_shape=(b,),
                             obst=ObstacleState(*(a[-b:] for a in obst))) for b in sizes}
    for t in range(max_ticks):
        nxt = {b: tick(st[b], noise=noise[t, -b:]) for b in sizes}
        if rows_equal({b: carried(nxt[b], b) for b in sizes})[0] < n_runs:
            break
        st = nxt
    else:
        return f"the state equal in every row for {max_ticks} ticks"
    pred = {b: predict_trajectory(st[b].obst, spec, spec.n_solv,
                                  compat_pred_bug=opts.compat_pred_bug).movedim(0, 1)
            for b in sizes}
    qps = {b: OcpQp(*[a.contiguous() for a in ctrl.build_qp(st[b].rti, st[b].x0, goal_t,
                                                           pred[b], params)]) for b in sizes}
    sol = {b: solve_ocp_qp_fused(qps[b], iters=opts.qp_iter, structure=UNICYCLE_QP_STRUCTURE)
           for b in sizes}
    u0 = {b: st[b].rti.u_traj[:, 0] + sol[b].du[:, 0] for b in sizes}
    steps = {
        "state before it": {b: carried(st[b], b) for b in sizes},
        "linearization (Phi, A, B)": {b: torch.cat([a.reshape(b, -1) for a in ctrl.lin(
            st[b].rti.x_traj[:, :-1], st[b].rti.u_traj)], 1) for b in sizes},
        "build_qp": {b: torch.cat([a.reshape(b, -1) for a in qps[b]], 1) for b in sizes},
        "K1 (dx, du, s)": {b: torch.cat([sol[b].dx.reshape(b, -1), sol[b].du.reshape(b, -1),
                                         sol[b].s.reshape(b, -1)], 1) for b in sizes},
        "plant step": {b: ctrl.integrate(st[b].x0, u0[b]) for b in sizes},
        "state after it": {b: carried(nxt[b], b) for b in sizes}}
    return f"first differing tick {t + 1}; at it, rows equal (max|diff|): " + "; ".join(
        f"{name} {n}/{n_runs} ({d:.2e})" for name, (n, d) in
        ((name, rows_equal(v)) for name, v in steps.items()))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--leg", default="results/parity_r5/v1_nostatus4")
    ap.add_argument("--only", default="220136", help="the cell's stamp")
    ap.add_argument("--max-ticks", type=int, default=60)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    leg = parity.load_leg(args.leg)
    s = parity.leg_settings(leg)
    (cell,) = parity.select(leg.cells, args.only)
    dev = resolve_device(args.device)
    card = (subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True).stdout
            .strip().splitlines()[0] if dev.type == "cuda" else "cpu")
    line = pairing_rounding(s, cell, dev, n_runs=parity.runs_of(leg, s),
                            max_ticks=args.max_ticks)
    print(f"{leg.name} {parity.cell_id(cell)} ({s.integrator}, {s.backend}, "
          f"{'f64' if s.f64 else 'f32'}) behind the other scenario: {line}; card={card}",
          flush=True)


if __name__ == "__main__":
    main()
