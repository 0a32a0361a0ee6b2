#!/usr/bin/env python3
"""Readings that the check's limits are set from, for one cell, in one
process (set-up paid once):

    python3 mpcbench/calibrate.py --workload <cell> --seeds 1 2 ... \
        --control-seeds 1 2 3 --fault-seeds 4 5 6 --out FILE

For each of ``--seeds`` it runs the cell's traffic from fresh worlds until
every tick the check compares has happened (the cell's own batch and load,
no timed window) and prints the numbers compared, as the program gives
them: their largest over the seeds is the lower reading. For each of
``--control-seeds`` it puts the reference computed in bfloat16 in the
program's place on the same inputs: the smallest of those numbers is the
upper reading. For each of ``--fault-seeds`` it runs the program with its
solve's answer altered on 5% of the rows (``system.rows_altered``). The
numbers use the per-row tolerances of the cell's limits file; with
``--out FILE`` the readings go to ``FILE`` (JSON) and every compared row's
gaps to ``FILE`` with ``.npz`` in place of its suffix, from which the
tolerances are set. Not part of a benchmark run.
"""

import argparse
import contextlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:1] = [ROOT]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from mpcbench import check, generator, harness, system

    bench = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cell, config, mix, lim = harness.cell_files(bench, args.workload)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        sys.exit("calibrate: no CUDA device")
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    sysm = system.System(config, device, random_move=mix["noise"])
    out = {"workload": args.workload, "limits": lim, "program": [], "control": [], "fault": []}
    rows = {}
    runs = [(s, False) for s in sorted(set(args.seeds) | set(args.control_seeds))] \
        + [(s, True) for s in args.fault_seeds]
    for seed, fault in runs:
        traffic = generator.Traffic(mix, config, seed, device)
        loop = generator.Loop(sysm, mix, traffic, capture=generator.check_ticks(mix, seed))
        loop.begin()
        t0 = time.perf_counter()
        with system.rows_altered() if fault else contextlib.nullcontext():
            generator.finish_captures(loop, limit_s=600.0)
        sync()
        t1 = time.perf_counter()
        sides = ["fault"] if fault else \
            [s for s, among in (("program", args.seeds), ("control", args.control_seeds))
             if seed in among]
        for side in sides:
            captured, starts = loop.captured, loop.starts
            if side == "control":
                captured, starts = check.control_outputs(captured, starts, config, device)
            t2 = time.perf_counter()
            g = check.row_gaps(captured, starts, config, device)
            numbers = check.numbers(g, lim["row_tol"])
            rec = dict(seed=seed, numbers=numbers, ticks_s=t1 - t0,
                       check_s=time.perf_counter() - t2,
                       correct=check.verdict(numbers, lim["limits"]))
            out[side].append(rec)
            rows.update({f"{side}_{seed}_{k}": v.numpy() for k, v in g.items()})
            print(side, json.dumps(rec), flush=True)
    for side, agg in (("program", max), ("control", min), ("fault", min)):
        if out[side]:
            out[side + "_reading"] = {k: agg(r["numbers"][k] for r in out[side])
                                      for k in check.NUMBERS}
            print(side + "_reading", json.dumps(out[side + "_reading"]), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
        np.savez_compressed(os.path.splitext(args.out)[0] + ".npz", **rows)


if __name__ == "__main__":
    main()
