"""Command-line interface of the PyTorch port.

    python -m doa_mpc_tpu_torch experiment   # the seeded Monte-Carlo

Only ``experiment`` is ported so far (ROADMAP item 9 lists the others).
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


def main(argv=None):
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
    p.add_argument("--backend", default="fused",
                   choices=["fused", "torch", "riccati", "zero"],
                   help="QP solve: 'fused' = the whole interior-point solve in "
                        "CUDA kernel K1 (JAX 'fused'); 'torch' = the "
                        "interior-point solver with the plain PyTorch Riccati "
                        "sweep (JAX 'xla'); 'riccati' = the same solver with "
                        "each Riccati solve in CUDA kernel K2 (JAX 'pallas'); "
                        "'zero' skips the solve. On the CPU the kernels' plain "
                        "PyTorch versions run")
    p.add_argument("--device", default="cuda")

    args = parser.parse_args(argv)

    import torch
    from doa_mpc_tpu_torch.config import SolverOptions, WorldSpec
    from doa_mpc_tpu_torch.sim.experiments import run_experiment

    spec = WorldSpec(tf=args.tf, n_solv=args.n_solv, n_obst=args.n_obst,
                     qp_iter=args.qp_iter)
    opts = SolverOptions(qp_iter=args.qp_iter, integrator=args.integrator)
    dtype = torch.float64 if args.f64 else torch.float32
    run_experiment(spec=spec, opts=opts, scenarios=args.scenarios,
                   n_runs=args.runs, max_iter=args.max_iter, out_dir=args.out,
                   dtype=dtype, backend=args.backend,
                   compat_rng=args.compat_rng, device=args.device)


if __name__ == "__main__":
    main()
