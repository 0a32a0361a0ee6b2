"""Command-line interface of the PyTorch port.

    python -m doa_mpc_tpu_torch experiment   # the seeded Monte-Carlo
    python -m doa_mpc_tpu_torch sweep        # TF x N_OBST grid
    python -m doa_mpc_tpu_torch qp-sweep     # QP iteration-budget sweep
    python -m doa_mpc_tpu_torch demo         # seeded visual run -> GIF
    python -m doa_mpc_tpu_torch sim          # open-loop integrator rollout
    python -m doa_mpc_tpu_torch evaluate     # aggregate rates + plots
    python -m doa_mpc_tpu_torch bench        # throughput of the batched tick

``experiment``, ``sweep`` and ``qp-sweep`` take ``--mesh`` (shard the
scenario rows over this process's devices) and ``--distributed`` (join a
``torch.distributed`` group first, see :func:`_resolve_mesh`).
"""

from __future__ import annotations

import argparse


def _spec_args(p):
    p.add_argument("--tf", type=float, default=2.0)
    p.add_argument("--n-solv", type=int, default=20)
    p.add_argument("--n-obst", type=int, default=5)
    p.add_argument("--qp-iter", type=int, default=20)
    p.add_argument("--integrator", default="rk4", choices=["rk4", "irk"])
    p.add_argument("--f64", action="store_true")


def _run_args(p):
    p.add_argument("--backend", default="fused",
                   choices=["fused", "torch", "riccati", "zero", "auto"],
                   help="QP solve: 'fused' = the whole interior-point solve in "
                        "CUDA kernel K1 (JAX 'fused'); 'torch' = the "
                        "interior-point solver with the plain PyTorch Riccati "
                        "sweep (JAX 'xla'); 'riccati' = the same solver with "
                        "each Riccati solve in CUDA kernel K2 (JAX 'pallas'); "
                        "'zero' skips the solve; 'auto' = 'fused' on a CUDA "
                        "--device, 'torch' on the CPU (as JAX's 'auto' picks "
                        "its kernel on a TPU, XLA elsewhere), so on a card it "
                        "is the default. On the CPU the kernels' plain "
                        "PyTorch versions run")
    p.add_argument("--device", default="cuda")
    p.add_argument("--distributed", action="store_true",
                   help="join a multi-process torch.distributed group (gloo; "
                        "MASTER_ADDR / MASTER_PORT / WORLD_SIZE / RANK / LOCAL_RANK, "
                        "as torchrun sets them) and shard the scenario rows over "
                        "its processes; process 0 writes the artifacts")
    p.add_argument("--mesh", action="store_true",
                   help="shard the scenario rows over this process's devices "
                        "(every local card with --device cuda); implied by "
                        "--distributed")


def _resolve_mesh(args):
    """The ``DataMesh`` that ``--distributed``/``--mesh`` ask for, or None.

    ``--distributed`` joins the process group first
    (``parallel.distributed.initialize``; a no-op without its variables).
    The mesh holds every local card for ``--device cuda`` (on a rank of a
    group, its card ``LOCAL_RANK``), else the one device named. Launch
    recipe, one process per card:

        torchrun --nproc-per-node 4 -m doa_mpc_tpu_torch experiment --distributed ...
    """
    if not (args.distributed or args.mesh):
        return None
    from doa_mpc_tpu_torch.parallel.distributed import initialize
    from doa_mpc_tpu_torch.parallel.mesh import make_data_mesh

    if args.distributed:
        initialize()
    return make_data_mesh(None if args.device == "cuda" else [args.device])


def resolve_backend(name: str, device) -> str:
    """``--backend``: ``auto`` becomes ``fused`` on a CUDA device and
    ``torch`` elsewhere; any other name stays."""
    if name != "auto":
        return name
    import torch
    return "fused" if torch.device(device).type == "cuda" else "torch"


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="doa_mpc_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("experiment", help="seeded Monte-Carlo (experiments.py)")
    _spec_args(p)
    p.add_argument("--runs", type=int, default=100)
    p.add_argument("--max-iter", type=int, default=400)
    p.add_argument("--out", default="test_data/new")
    p.add_argument("--scenarios", nargs="+", default=["RANDOM", "EDGE"])
    p.add_argument("--compat-rng", action="store_true",
                   help="replay the reference's exact MT19937 worlds and "
                        "obstacle noise per seed")
    _run_args(p)

    p = sub.add_parser("sweep", help="TF x N_OBST sweep")
    p.add_argument("--runs", type=int, default=100)
    p.add_argument("--out", default="test_data/sweep")
    _run_args(p)

    p = sub.add_parser("qp-sweep", help="QP_ITER sweep")
    p.add_argument("--runs", type=int, default=100)
    p.add_argument("--out", default="test_data/qp_sweep")
    _run_args(p)

    p = sub.add_parser("demo", help="seeded visual run -> GIF (demo.py)")
    _spec_args(p)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--scenario", default="RANDOM")
    p.add_argument("--max-iter", type=int, default=400)
    p.add_argument("--gif", default="demo.gif")
    p.add_argument("--device", default="cuda")

    p = sub.add_parser("sim", help="open-loop integrator rollout (robot_sim.py)")
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--device", default="cuda")

    p = sub.add_parser("evaluate", help="aggregate rates + plots")
    p.add_argument("--data", default="test_data/new")
    p.add_argument("--out", default=".")
    p.add_argument("--qp", action="store_true",
                   help="QP_ITER plot instead of horizon plots")

    p = sub.add_parser("bench", help="throughput of the batched fused tick (one JSON line)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--batch", type=int, default=4096)
    p.add_argument("--n-solv", type=int, default=20)
    p.add_argument("--n-obst", type=int, default=5)
    p.add_argument("--qp-iter", type=int, default=6)
    p.add_argument("--chains", type=int, default=20)
    p.add_argument("--chain-ticks", type=int, default=10)
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    if "backend" in args:
        args.backend = resolve_backend(args.backend, args.device)

    if args.cmd == "experiment":
        import torch
        from doa_mpc_tpu_torch.config import SolverOptions, WorldSpec
        from doa_mpc_tpu_torch.sim.experiments import run_experiment

        spec = WorldSpec(tf=args.tf, n_solv=args.n_solv, n_obst=args.n_obst,
                         qp_iter=args.qp_iter)
        opts = SolverOptions(qp_iter=args.qp_iter, integrator=args.integrator)
        dtype = torch.float64 if args.f64 else torch.float32
        run_experiment(spec=spec, opts=opts, scenarios=args.scenarios,
                       n_runs=args.runs, max_iter=args.max_iter, out_dir=args.out,
                       dtype=dtype, mesh=_resolve_mesh(args), backend=args.backend,
                       compat_rng=args.compat_rng, device=args.device)
    elif args.cmd == "sweep":
        from doa_mpc_tpu_torch.sim.experiments import run_horizon_sweep
        run_horizon_sweep(n_runs=args.runs, out_dir=args.out, verbose=True,
                          mesh=_resolve_mesh(args), backend=args.backend,
                          device=args.device)
    elif args.cmd == "qp-sweep":
        from doa_mpc_tpu_torch.sim.experiments import run_qp_iter_sweep
        run_qp_iter_sweep(n_runs=args.runs, out_dir=args.out, verbose=True,
                          mesh=_resolve_mesh(args), backend=args.backend,
                          device=args.device)
    elif args.cmd == "demo":
        _demo(args)
    elif args.cmd == "sim":
        _sim(args)
    elif args.cmd == "evaluate":
        from doa_mpc_tpu_torch.sim.evaluate import (
            plot_graph, plot_graph_qp_solver, summarize)
        for row in summarize(args.data):
            print(row)
        if args.qp:
            plot_graph_qp_solver(args.data, args.out)
        else:
            plot_graph(args.data, args.out)
    elif args.cmd == "bench":
        import json
        from doa_mpc_tpu_torch import bench
        print(json.dumps(bench.measure(
            device=args.device, batch=args.batch, n_solv=args.n_solv, n_obst=args.n_obst,
            qp_iter=args.qp_iter, chains=args.chains, chain_ticks=args.chain_ticks)),
            flush=True)
    if args.cmd in ("experiment", "sweep", "qp-sweep"):
        from doa_mpc_tpu_torch.parallel.distributed import shutdown
        shutdown()


def demo_rollout(args):
    """The ``demo`` command's run without its GIF: one robot (B=1) in a world
    drawn from a generator seeded with ``--seed``, ``--max-iter`` ticks of
    :func:`sim.closed_loop.make_rollout` with ``collect`` (its solves in
    kernel K2 on the card). Returns (spec, start, goal, final state,
    (x0, obst_pos, pred_x) stacks)."""
    import torch
    from doa_mpc_tpu_torch.config import (
        SolverOptions, WorldSpec, default_cost_params, resolve_device)
    from doa_mpc_tpu_torch.sim.closed_loop import init_loop_state, make_rollout
    from doa_mpc_tpu_torch.sim.obstacles import robot_start_goal
    from doa_mpc_tpu_torch.solver.sqp_rti import make_rti_controller

    dev = resolve_device(args.device)
    spec = WorldSpec(tf=args.tf, n_solv=args.n_solv, n_obst=args.n_obst,
                     qp_iter=args.qp_iter)
    opts = SolverOptions(qp_iter=args.qp_iter, integrator=args.integrator)
    dtype = torch.float64 if args.f64 else torch.float32
    ctrl = make_rti_controller(spec, opts, dtype=dtype, device=dev)
    params = default_cost_params(spec, dtype=dtype, device=dev)
    start, goal = robot_start_goal(spec)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    st = init_loop_state(ctrl, start, goal, args.scenario, batch_shape=(1,), generator=gen)
    rollout = make_rollout(ctrl, goal, params, max_iter=args.max_iter, collect=True,
                           generator=gen)
    final, traj = rollout(st)
    return spec, start, goal, final, traj


def _demo(args):
    """Seeded visual run: prints the outcome, writes the GIF up to the
    tick that reached the goal."""
    from doa_mpc_tpu_torch.sim.closed_loop import metrics_of
    from doa_mpc_tpu_torch.utils.viz import VisDynamicRobotEnv

    spec, start, goal, fin, (xs, obs, pred) = demo_rollout(args)
    m = metrics_of(fin)
    steps = int(m.steps[0])
    print(f"reached={bool(m.reached[0])} hit={bool(m.hit[0])} "
          f"min_margin={float(m.min_margin[0]):.3f} steps={steps}")
    t = steps + 1
    vis = VisDynamicRobotEnv(spec, xs[:t, 0].cpu().numpy(), obs[:t, 0].cpu().numpy(),
                             pred_traj=pred[:t, 0, :, :2].cpu().numpy(),
                             start=start, goal=goal)
    vis.save_animation(args.gif, every=2)
    print(f"wrote {args.gif}")


def _sim(args):
    """Open-loop rollout (robot_sim.py): a fixed control sequence through the
    3-stage Radau IIA integrator with 3 Newton iterations, in float32 as the
    JAX command runs it; prints the (x, y) trajectory."""
    import numpy as np
    import torch
    from doa_mpc_tpu_torch.config import resolve_device
    from doa_mpc_tpu_torch.models.unicycle import dynamics
    from doa_mpc_tpu_torch.ops.integrators import irk_step

    dev = resolve_device(args.device)
    u_traj = np.zeros((args.steps, 2))
    u_traj[:10] = [1.0, 0.5]
    x = torch.tensor([0.0, 0.0, np.pi / 4, 0.0, 0.0], dtype=torch.float32, device=dev)
    xs = [x]
    for i in range(args.steps):
        x = irk_step(dynamics, x, torch.as_tensor(u_traj[i], dtype=x.dtype, device=dev), 0.1,
                     stages=3, newton_iter=3, tableau="radau_iia")
        xs.append(x)
    print(torch.stack(xs).cpu().numpy()[:, :2])


if __name__ == "__main__":
    main()
