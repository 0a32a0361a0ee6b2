"""Shared helpers of the benchmark's CPU tests: every cell shrunk to a size
the CPU runs in seconds (fewer rows and IP iterations, short rollouts),
driven through the harness on the program's plain path."""

import copy
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

from mpcbench import harness  # noqa: E402

BENCH = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
WORKLOADS = [w["name"] for w in BENCH["workloads"]]


def tiny(cell, config, mix, limits, rows=4, qp_iter=4):
    """The cell at a CPU size; the limits stay the cell's own."""
    config, mix = copy.deepcopy(config), copy.deepcopy(mix)
    config["solver"]["qp_iter"] = min(config["solver"]["qp_iter"], qp_iter)
    mix["scenarios"] = {k: min(v, rows) for k, v in mix["scenarios"].items()}
    mix["check"] = {"ticks": 3, "within": 6}
    mix["warm_ticks"] = 1
    mix["rollout_ticks"] = 5
    return cell, config, mix, limits


def run_tiny(monkeypatch, workload, seed=2**31 + 12345, seconds=1.0, **kw):
    """One harness run of the shrunk cell on the CPU."""
    orig = harness.cell_files
    monkeypatch.setattr(harness, "cell_files", lambda b, w: tiny(*orig(b, w), **kw))
    return harness.run_cell(BENCH, workload, seed, seconds, False, torch.device("cpu"),
                            time.perf_counter(), {}, lambda: None)
