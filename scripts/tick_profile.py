#!/usr/bin/env python3
"""Device kernels and device busy time per batched control tick, by
``torch.profiler``, for the rk4 and IRK controllers on one GPU.

    python3 scripts/tick_profile.py [--batch 4096] [--ticks 10]

For each integrator (rk4, and the default IRK: 4-stage Gauss-Legendre, 3
Newton iterations) and each backend (``fused``, and ``zero``, which leaves
only the tick's glue), at N=20, M=5, 6 IP iterations, f32 (``chip_smoke.py``
phase 5's cell), it runs 5 warm-up ticks, times ``--ticks`` ticks with CUDA
events, then profiles the same number of ticks after one warm-up cycle of
the profiler. It prints one JSON line with the card's name and power limit:

- ``tick_ms``: CUDA-event time per tick (no profiler running);
- ``kernels_per_tick``: device kernels the profiler saw, per tick;
- ``busy_ms_per_tick``: the sum of their device times, per tick;
- ``top``: the kernels with the most device time (name, ms per tick,
  launches per tick), for the IRK ``fused`` tick.

The full record goes to ``chiprun_out/tick_profile.json``. A diagnostic: it
is not part of ``chip_smoke.py``.
"""

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--ticks", type=int, default=10)
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    if not torch.cuda.is_available():
        sys.exit("tick_profile: needs a CUDA device")
    sys.path.insert(0, REPO)
    import chip_smoke
    from doa_mpc_tpu_torch.config import SolverOptions, WorldSpec, default_cost_params
    from doa_mpc_tpu_torch.sim.closed_loop import init_loop_state, make_batched_tick
    from doa_mpc_tpu_torch.sim.obstacles import robot_start_goal
    from doa_mpc_tpu_torch.solver.sqp_rti import make_rti_controller

    dev = torch.device("cuda", 0)
    spec = WorldSpec(tf=2.0, n_solv=20, n_obst=5, qp_iter=6)
    params = default_cost_params(spec, dtype=torch.float32, device=dev)
    start, goal = robot_start_goal(spec)
    out = {"card": chip_smoke.card_name(), "batch": args.batch, "ticks": args.ticks}
    for integrator in ("rk4", "irk"):
        ctrl = make_rti_controller(
            spec, SolverOptions(qp_iter=6, integrator=integrator, compat_pred_bug=True),
            dtype=torch.float32, device=dev)
        for backend in ("fused", "zero"):
            gen = torch.Generator(device=dev).manual_seed(0)
            tick = make_batched_tick(ctrl, goal, params, backend=backend, generator=gen)
            state = [init_loop_state(ctrl, start, goal, batch_shape=(args.batch,),
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
            out[f"{integrator}_{backend}"] = rec
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "tick_profile.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
