#!/usr/bin/env python3
"""Benchmark of ``doa_mpc_tpu_torch`` on one NVIDIA GPU: one run of one cell.

    python3 mpcbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout that holds ``BENCHMARK.json``. It builds
the cell's configuration of the program, warms it up at the cell's shapes,
drives its traffic for ``--seconds`` (the measured window), checks the
compared ticks against the plain reference, and prints one JSON line last
on standard output: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer metrics read
from a profiled segment after the window), ``device``, and last ``check``:
each number compared beside its limit, which also end standard error.
Set-up's parts go to standard error first. It exits non-zero without a
result when there is no CUDA device, too few of them, or when JAX or the
JAX package got loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the checkout's root, not this folder, first on the path: the harness's
# module names must not shadow the standard library's
sys.path[:1] = [ROOT]


def _clean(obj):
    """Non-finite floats as strings, so the line stays strict JSON."""
    if isinstance(obj, float) and not math.isfinite(obj):
        return str(obj)
    if isinstance(obj, dict):
        return {k: _clean(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_clean(v) for v in obj]
    return obj


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every build and kernel cache in the checkout, at fixed paths (the
    # program builds its kernels into doa_mpc_tpu_torch/_build/)
    cache = os.path.join(ROOT, ".mpcbench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")

    import torch

    from mpcbench import harness

    bench = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cell = harness.find(bench["workloads"], args.workload, "workload")
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"mpcbench: cell {args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    t_imp = time.perf_counter()
    from mpcbench import system  # noqa: F401  (imports the program)
    parts = {"import_torch_s": t_imp - T_START, "import_program_s": time.perf_counter() - t_imp}

    result, lines = harness.run_cell(bench, args.workload, args.seed, args.seconds,
                                     bool(args.trace), device, T_START, parts,
                                     torch.cuda.synchronize)
    found = harness.forbidden_modules()
    if found:
        print(f"mpcbench: the run loaded {', '.join(found)}; the benchmark runs the "
              "PyTorch port only", file=sys.stderr)
        return 3
    result["card"] = _card()
    result["check"] = result.pop("check")
    print(json.dumps(_clean(result)), flush=True)
    print("\n".join(lines), file=sys.stderr, flush=True)
    return 0


def _card() -> str:
    """nvidia-smi's name and power limit of the card (its speed under load
    depends on the limit)."""
    import subprocess
    try:
        out = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


if __name__ == "__main__":
    sys.exit(main())
