#!/usr/bin/env python3
"""Device kernels and device busy time per batched control tick, by
``torch.profiler``, for the rk4 and IRK controllers on one GPU.

    python3 scripts/tick_profile.py [--batch 4096 1] [--ticks 10] [--tree DIR]
                                    [--integrators rk4 irk] [--backends fused zero]

For each integrator (rk4, and the default IRK: 4-stage Gauss-Legendre, 3
Newton iterations) and each backend (``fused``, and ``zero``, which leaves
only the tick's glue), at N=20, M=5, 6 IP iterations, f32 (``chip_smoke.py``
phase 5's cell), at each ``--batch``, it runs 5 warm-up ticks, times
``--ticks`` ticks with CUDA events, then profiles the same number of ticks
after one warm-up cycle of the profiler. It imports ``doa_mpc_tpu_torch``
from ``--tree`` (default: this checkout), so a ``git archive`` of another
commit unpacked into a gitignored directory is measured the same way; to
compare two trees, run it in turns in one call (parent, change, change,
parent). It prints one JSON line with the card's name and power limit:

- ``tick_ms``: CUDA-event time per tick (no profiler running);
- ``kernels_per_tick``: device kernels the profiler saw, per tick;
- ``busy_ms_per_tick``: the sum of their device times, per tick;
- ``top``: the kernels with the most device time (name, ms per tick,
  launches per tick), for the IRK ``fused`` tick.

Keys are ``<integrator>_<backend>_B<batch>``. The full record goes to
``chiprun_out/tick_profile_<tree>.json``. A diagnostic: it is not part of
``chip_smoke.py``.
"""

import argparse
import importlib.util
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, nargs="+", default=[4096])
    ap.add_argument("--ticks", type=int, default=10)
    ap.add_argument("--tree", default=REPO)
    ap.add_argument("--integrators", nargs="+", default=["rk4", "irk"])
    ap.add_argument("--backends", nargs="+", default=["fused", "zero"])
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    if not torch.cuda.is_available():
        sys.exit("tick_profile: needs a CUDA device")
    # this checkout's timing, whichever tree the package comes from
    spec_ = importlib.util.spec_from_file_location("chip_smoke",
                                                   os.path.join(REPO, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(chip_smoke)
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    from doa_mpc_tpu_torch.config import SolverOptions, WorldSpec, default_cost_params
    from doa_mpc_tpu_torch.sim.closed_loop import init_loop_state, make_batched_tick
    from doa_mpc_tpu_torch.sim.obstacles import robot_start_goal
    from doa_mpc_tpu_torch.solver.sqp_rti import make_rti_controller
    from doa_mpc_tpu_torch.utils.profiling import device_label

    dev = torch.device("cuda", 0)
    spec = WorldSpec(tf=2.0, n_solv=20, n_obst=5, qp_iter=6)
    params = default_cost_params(spec, dtype=torch.float32, device=dev)
    start, goal = robot_start_goal(spec)
    name = os.path.relpath(tree, REPO) if tree != REPO else "."
    out = {"card": device_label(dev), "tree": name, "ticks": args.ticks}
    for integrator, nb in [(i, b) for i in args.integrators for b in args.batch]:
        ctrl = make_rti_controller(
            spec, SolverOptions(qp_iter=6, integrator=integrator, compat_pred_bug=True),
            dtype=torch.float32, device=dev)
        for backend in args.backends:
            gen = torch.Generator(device=dev).manual_seed(0)
            tick = make_batched_tick(ctrl, goal, params, backend=backend, generator=gen)
            state = [init_loop_state(ctrl, start, goal, batch_shape=(nb,),
                                     generator=gen)]

            def step():
                state[0] = tick(state[0])

            tick_ms = chip_smoke.time_ms(torch, step, reps=args.ticks, warmup=5)
            cycles = []
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                         schedule=schedule(wait=0, warmup=1, active=1),
                         on_trace_ready=lambda p: cycles.append(p.events())) as prof:
                for _ in range(2):
                    for _ in range(args.ticks):
                        step()
                    torch.cuda.synchronize()
                    prof.step()
            # the profiler's own step annotation also carries the CUDA device type
            kernels = [e for e in cycles[-1] if e.device_type == torch.autograd.DeviceType.CUDA
                       and not e.name.startswith("ProfilerStep")]
            by_name = {}
            for e in kernels:
                n, us = by_name.get(e.name, (0, 0.0))
                by_name[e.name] = (n + 1, us + e.device_time_total)
            rec = {"tick_ms": tick_ms, "kernels_per_tick": len(kernels) / args.ticks,
                   "busy_ms_per_tick": sum(e.device_time_total for e in kernels) / 1e3 / args.ticks}
            if (integrator, backend) == ("irk", "fused"):
                rec["top"] = [(name[:80], us / 1e3 / args.ticks, n / args.ticks) for name, (n, us)
                              in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]]
            out[f"{integrator}_{backend}_B{nb}"] = rec
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    tag = name.replace(os.sep, "_").strip("._") or "this"
    with open(os.path.join(REPO, "chiprun_out", f"tick_profile_{tag}.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
