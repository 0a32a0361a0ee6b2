#!/usr/bin/env python3
"""Time kernel K2 (``csrc/riccati.cu``) of one tree of the port on one GPU.

    python3 scripts/k2_timing.py [--tree DIR]

Imports ``doa_mpc_tpu_torch`` from ``--tree`` (default: this checkout), so a
``git archive`` of another commit unpacked into a gitignored directory is
timed the same way, with this checkout's ``chip_smoke.py`` timing and inputs
(phases 6 and 8: seeded LQRs with SPD costs, N=20, f32). It checks the
kernel against its plain version, then prints one JSON line, with the
card's name and power limit:

- ``device_ms_*``: K2's device time per launch from ``torch.profiler`` (50
  launches at B=4096, 20 at B=1; the kernel alone, whatever else the tree's
  wrapper launches; ``profiled_*`` is how many of the launches the
  profiler saw, and the time is per launch seen);
- ``events_ms_*``: the device time per wrapper call from ``chip_smoke.py``'s
  ``kernel_device_ms`` (CUDA events behind a spin kernel; the kernel alone
  where the wrapper launches nothing else);
- ``wrapper_ms_*``: the wrapper's time per call with CUDA events (50 calls).

To compare two trees, run it in turns in one call on one card (parent,
change, change, parent).
"""

import argparse
import importlib.util
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def profiled_kernel_ms(torch, fn, name, reps):
    """(device time per launch seen, launches seen) of the kernel whose name
    contains ``name``, from ``torch.profiler`` over ``reps`` calls of ``fn``,
    after a warm-up cycle of the profiler (the first launches after it
    starts may be missing from its trace)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    cycles = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: cycles.append(p.key_averages())) as prof:
        for _ in range(2):
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            prof.step()
    evs = [e for e in cycles[-1] if name in e.key]
    count = sum(e.count for e in evs)
    us = sum(getattr(e, "self_device_time_total", 0) for e in evs)
    return (us / 1e3 / count if count else None), f"{count}/{reps}"


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=REPO)
    a = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.exit("k2_timing: needs a CUDA device")
    # this checkout's chip_smoke.py, whichever tree the package comes from
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    sys.path.insert(0, os.path.abspath(a.tree))
    from doa_mpc_tpu_torch.ops import riccati_fused
    from doa_mpc_tpu_torch.utils.profiling import device_label

    dev = torch.device("cuda", 0)
    lqr = [x.float() for x in cs.seeded_lqrs(torch, dev)]
    lqr1 = [x[:1].contiguous() for x in lqr]
    solve = riccati_fused.riccati_solve_fused

    # the answer first: a faster kernel that is wrong is no result
    got, want = solve(*lqr), riccati_fused.riccati_solve_fused_ref(*lqr)
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    if not err <= 1e-2:
        sys.exit(f"k2_timing: kernel vs plain max|err| {err}")
    dev_4096, seen_4096 = profiled_kernel_ms(torch, lambda: solve(*lqr), "riccati_kernel", 50)
    dev_1, seen_1 = profiled_kernel_ms(torch, lambda: solve(*lqr1), "riccati_kernel", 20)
    print(json.dumps({
        "tree": os.path.relpath(os.path.abspath(a.tree), REPO),
        "device_ms_B4096": dev_4096, "profiled_B4096": seen_4096,
        "device_ms_B1": dev_1, "profiled_B1": seen_1,
        "events_ms_B4096": cs.kernel_device_ms(torch, lambda: solve(*lqr), 50),
        "events_ms_B1": cs.kernel_device_ms(torch, lambda: solve(*lqr1), 20),
        "wrapper_ms_B4096": cs.time_ms(torch, lambda: solve(*lqr), reps=50, warmup=3),
        "wrapper_ms_B1": cs.time_ms(torch, lambda: solve(*lqr1), reps=50, warmup=3),
        "max_abs_err_vs_plain": err, "N": cs.N, "dtype": "float32",
        "card": device_label(dev)}), flush=True)


if __name__ == "__main__":
    main()
