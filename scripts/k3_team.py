#!/usr/bin/env python3
"""Kernel K3 (``doa_mpc_tpu_torch/csrc/irk_step.cu``) built with each team
size, timed on the IRK tick's two shapes, on one GPU.

    python3 scripts/k3_team.py [--teams 1 2 4 8 16 32] [--reps 20]

For each team size (lanes per row, the source's ``IRK_TEAM``) it builds the
source with nvcc (the package's flags plus ``-DIRK_TEAM=<n>``) into
``chiprun_out/k3_team/``, and times one launch (CUDA events behind a spin,
``chip_smoke.kernel_device_ms``) at the linearization's shape (81,920 rows,
f32, 4-stage Gauss-Legendre, 3 Newton iterations, with D) and the plant's
(4,096 rows, without D), on states like the controller's (N(0, s) per
coordinate, seed 0), in f32 and f64. It checks that every team size gives
the same bits as the package's build (lanes split a row's outputs, never a
sum) and prints one JSON line with the card's name and power limit, each
team's times, and ptxas's registers and spills.
"""

import argparse
import ctypes
import importlib.util
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--teams", type=int, nargs="+", default=[1, 2, 4, 8, 16, 32])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("k3_team: needs a CUDA device")
    sys.path.insert(0, REPO)
    spec_ = importlib.util.spec_from_file_location("chip_smoke",
                                                   os.path.join(REPO, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(chip_smoke)
    from doa_mpc_tpu_torch.ops import cuda_build, integrators
    from doa_mpc_tpu_torch.utils.profiling import device_label

    dev = torch.device("cuda", 0)
    out_dir = os.path.join(REPO, "chiprun_out", "k3_team")
    os.makedirs(out_dir, exist_ok=True)

    def build(team):
        lib = os.path.join(out_dir, f"libirk_step_team{team}.so")
        cmd = [cuda_build.nvcc(), *cuda_build.NVCC_FLAGS, f"-DIRK_TEAM={team}", "-o", lib,
               integrators.KERNEL_SOURCE]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            sys.exit(f"nvcc failed for team {team}:\n{res.stderr[-4000:]}")
        with open(lib[:-3] + ".log", "w") as f:
            f.write(res.stdout + res.stderr)
        return integrators.bind_library(ctypes.CDLL(lib)), cuda_build.ptxas_report(lib)

    rng = np.random.default_rng(0)
    cases = {}
    for name, rows, sens in (("lin", 81920, True), ("plant", 4096, False)):
        for dtype in (torch.float32, torch.float64):
            x = torch.tensor(rng.standard_normal((rows, 5)) * np.array([3, 3, 1, 2, 1]),
                             dtype=dtype, device=dev)
            u = torch.tensor(rng.standard_normal((rows, 2)), dtype=dtype, device=dev)
            A, b = integrators._tableau_tensors("gauss_legendre", 4, dtype, dev)
            ref = integrators.irk_step_fused(x, u, A, b, 0.1, 3, 1, sens)
            cases[(name, str(dtype).removeprefix("torch."))] = (x, u, A, b, sens, ref)

    out = {"card": device_label(dev), "reps": args.reps,
           "package_team": integrators.plan(4, True, torch.float32).team, "teams": {}}
    with ThreadPoolExecutor(max_workers=len(args.teams)) as pool:   # one nvcc per team
        built = list(pool.map(build, args.teams))
    for team, (so, ptxas) in zip(args.teams, built):
        rec = {"ptxas": [ln for ln in ptxas if "registers" in ln or "spill" in ln]}
        for (name, dt), (x, u, A, b, sens, ref) in cases.items():
            integrators.plan(4, sens, x.dtype, lib=so)     # its shared-memory limit
            fn = so.irk_step_f32 if x.dtype == torch.float32 else so.irk_step_f64
            phi = torch.empty_like(x)
            D = torch.empty((x.shape[0], 5, 7), dtype=x.dtype, device=dev) if sens else None
            stream = torch.cuda.current_stream(dev).cuda_stream

            def call():
                rc = fn(x.data_ptr(), u.data_ptr(), A.data_ptr(), b.data_ptr(), 0.1, 3, 1,
                        phi.data_ptr(), D.data_ptr() if sens else None, x.shape[0], 4, stream)
                if rc != 0:
                    sys.exit(f"team {team}: launch failed with {rc}")

            ms = chip_smoke.kernel_device_ms(torch, call, args.reps)
            same = (torch.equal(phi, ref[0] if sens else ref)
                    and (not sens or torch.equal(D, ref[1])))
            rec[f"{name}_{dt}"] = {"rows": x.shape[0], "with_D": sens, "ms": ms,
                                   "same_bits_as_package": same}
        out["teams"][team] = rec
        print(f"team {team}: " + json.dumps(rec), flush=True)
    with open(os.path.join(REPO, "chiprun_out", "k3_team.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out), flush=True)
    if not all(v["same_bits_as_package"] for rec in out["teams"].values()
               for k, v in rec.items() if k != "ptxas"):
        sys.exit("k3_team: a team size changed the bits")


if __name__ == "__main__":
    main()
