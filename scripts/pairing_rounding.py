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

With an IRK leg it then runs the IRK step at that tick (on the card one
launch of kernel K3, ``ops/integrators.py``, ``irk_step_fused``; on the CPU
its plain version) at both of its call sites (the plant step over the B
rows, the linearization over the B*N stage points, with D), and prints the
rows equal and the largest difference. The step gets the same inputs in
the cell's rows at both batch sizes (the alone run's), so a row that
differs shows that the step rounds it differently, not that it inherited a
difference.

``--ranks 2`` runs the campaign cell of ``chip_smoke.py`` phase 14
(TF 2.0, N 20, M 5, 6 IP iterations, ``fused``, f32, RANDOM, 100 seeds x
400 ticks, seed 0) with ``--integrator`` through ``run_scenario_batch``
unsharded and as the ``experiment --distributed`` command on that many gloo
ranks on the card, and prints the rows the two give equal.

It runs on a card (``--device cuda``, the default). Every op of the tick
computes a row from that row alone (the IRK step is kernel K3, whose
lanes split a row's outputs, never a sum), so on the card as on the CPU
the state stays equal in every row and IRK rows do not depend on the
batch; the script finds the op that breaks that, should one come to.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import socket
import subprocess
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from doa_mpc_tpu_torch.config import SolverOptions, WorldSpec, resolve_device  # noqa: E402
from doa_mpc_tpu_torch.ops import integrators  # noqa: E402
from doa_mpc_tpu_torch.ops.ip_fused import UNICYCLE_QP_STRUCTURE, solve_ocp_qp_fused  # noqa: E402
from doa_mpc_tpu_torch.ops.ocp_qp import OcpQp  # noqa: E402
from doa_mpc_tpu_torch.sim import parity  # noqa: E402
from doa_mpc_tpu_torch.sim.closed_loop import init_loop_state, make_batched_tick  # noqa: E402
from doa_mpc_tpu_torch.sim.compat_rng import mt_experiment_batch  # noqa: E402
from doa_mpc_tpu_torch.sim.experiments import run_scenario_batch  # noqa: E402
from doa_mpc_tpu_torch.sim.obstacles import (  # noqa: E402
    ObstacleState, predict_trajectory, robot_start_goal,
)
from doa_mpc_tpu_torch.solver.sqp_rti import make_rti_controller  # noqa: E402


def step_alone_and_paired(opts, h, alone, paired, sensitivities):
    """The IRK step of one call site as the tick runs it (kernel K3 on the
    card, ``integrators.irk_step_fused``; its plain version on the CPU) on
    the cell's rows alone (``alone``: x, u of n rows) and behind the other
    rows (``paired``: x, u with the cell's rows last, which are set to the
    alone run's first). Returns the rows whose Phi (and D) are equal bit for
    bit, and the largest difference."""
    n = alone[0].shape[0]
    paired = [torch.cat([p[:-n], a]) for p, a in zip(paired, alone)]
    x = alone[0]
    A, b = integrators._tableau_tensors(opts.irk_tableau, opts.irk_stages, x.dtype, x.device)
    step = integrators.irk_step_fused if x.device.type == "cuda" else integrators.irk_step_ref
    ra, rp = (step(*xu, A, b, h, opts.irk_newton_iter, 1, sensitivities)
              for xu in (alone, paired))
    ra, rp = (ra, rp) if sensitivities else ((ra,), (rp,))
    a = torch.cat([v.reshape(n, -1).to(torch.float64) for v in ra], 1)
    p = torch.cat([v[-n:].reshape(n, -1).to(torch.float64) for v in rp], 1)
    return int((a == p).all(1).sum()), float((a - p).abs().max())


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
    line = f"first differing tick {t + 1}; at it, rows equal (max|diff|): " + "; ".join(
        f"{name} {n}/{n_runs} ({d:.2e})" for name, (n, d) in
        ((name, rows_equal(v)) for name, v in steps.items()))
    if opts.integrator != "irk":
        return line
    h = spec.tf / spec.n_solv
    N = spec.n_solv
    sites = {"plant step": ({b: st[b].x0 for b in sizes}, u0, n_runs, False),
             "linearization": ({b: st[b].rti.x_traj[:, :-1].reshape(b * N, -1) for b in sizes},
                               {b: st[b].rti.u_traj.reshape(b * N, -1) for b in sizes},
                               n_runs * N, True)}
    for site, (xs, us, rows, sens) in sites.items():
        n, d = step_alone_and_paired(opts, h, (xs[n_runs], us[n_runs]),
                                     (xs[2 * n_runs], us[2 * n_runs]), sens)
        line += (f"\nIRK step (K3{' with D' if sens else ''}) at tick {t + 1}, {site} ({rows} "
                 f"rows alone, {2 * rows} paired; on equal inputs): rows equal {n}/{rows} "
                 f"(max|diff| {d:.2e})")
    return line


def sharded_rows(integrator, ranks, dev, out_dir, n_runs=100, max_iter=400):
    """The rows of ``chip_smoke.py`` phase 14's campaign cell with
    ``integrator``: unsharded through ``run_scenario_batch`` and as the
    ``experiment --distributed`` command on ``ranks`` gloo ranks on the card
    (each on ``cuda:0``). Returns a line with the rows equal."""
    import numpy as np

    spec = WorldSpec(tf=2.0, n_solv=20, n_obst=5, qp_iter=6)
    ref = run_scenario_batch(spec, SolverOptions(qp_iter=6, integrator=integrator), "RANDOM",
                             n_runs=n_runs, max_iter=max_iter, dtype=torch.float32,
                             backend="fused", device=dev)
    repo = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    cmd = [sys.executable, "-m", "doa_mpc_tpu_torch", "experiment", "--distributed",
           "--device", dev.type, "--runs", str(n_runs), "--max-iter", str(max_iter), "--qp-iter", "6",
           "--integrator", integrator, "--scenarios", "RANDOM", "--out", out_dir]
    procs = [subprocess.Popen(cmd, cwd=repo, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True, env=dict(os.environ, MASTER_ADDR="localhost",
                                                  MASTER_PORT=str(port), WORLD_SIZE=str(ranks),
                                                  RANK=str(r), LOCAL_RANK=str(r)))
             for r in range(ranks)]
    try:
        outs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = [(r, p.returncode, [ln for ln in o.splitlines() if "Error" in ln][-1:])
              for r, (p, o) in enumerate(zip(procs, outs)) if p.returncode != 0]
    if failed:
        return (f"campaign cell ({integrator}) on {ranks} gloo ranks: ranks failed (rank, exit "
                f"code, last error line): {failed}")
    (csv,) = [f for f in os.listdir(out_dir) if f.endswith("_experiment_data.csv")]
    got = np.loadtxt(os.path.join(out_dir, csv), delimiter=";")
    return (f"campaign cell ({integrator}, fused, f32, RANDOM, {n_runs} seeds x {max_iter} ticks, seed 0) "
            f"on {ranks} gloo ranks: {int((got == ref).all(1).sum())} of {n_runs} rows equal to the "
            f"unsharded run, {int((got[:, [0, 1, 4, 5]] == ref[:, [0, 1, 4, 5]]).all(1).sum())} "
            f"in hit, reached, steps and oob; hit {got[:, 0].mean():.2f} / {ref[:, 0].mean():.2f}"
            f", reached {got[:, 1].mean():.2f} / {ref[:, 1].mean():.2f}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--leg", default="results/parity_r5/v1_nostatus4")
    ap.add_argument("--only", default="220136", help="the cell's stamp")
    ap.add_argument("--max-ticks", type=int, default=60)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ranks", type=int, default=0,
                    help="run the sharded check on this many gloo ranks instead")
    ap.add_argument("--integrator", choices=["irk", "rk4"],
                    help="the leg's integrator instead (the sharded check: default irk)")
    ap.add_argument("--runs", type=int, help="seeds per scenario instead of the leg's")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    card = (subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True).stdout
            .strip().splitlines()[0] if dev.type == "cuda" else "cpu")
    if args.ranks:
        with tempfile.TemporaryDirectory() as out:
            print(f"{sharded_rows(args.integrator or 'irk', args.ranks, dev, out)}; card={card}",
                  flush=True)
        return
    leg = parity.load_leg(args.leg)
    s = parity.leg_settings(leg)
    if args.integrator:
        s = dataclasses.replace(s, integrator=args.integrator)
    (cell,) = parity.select(leg.cells, args.only)
    line = pairing_rounding(s, cell, dev, n_runs=args.runs or parity.runs_of(leg, s),
                            max_ticks=args.max_ticks)
    print(f"{leg.name} {parity.cell_id(cell)} ({s.integrator}, {s.backend}, "
          f"{'f64' if s.f64 else 'f32'}) behind the other scenario: {line}; card={card}",
          flush=True)


if __name__ == "__main__":
    main()
