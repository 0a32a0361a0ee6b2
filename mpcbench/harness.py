"""The benchmark's runner: finds a cell's configuration, traffic mix, limits
and per-layer readers by name, runs set-up, the measured window, the check
and (with ``trace``) a profiled segment, and builds the result.

Everything that belongs to one configuration, mix, cell or metric is a file
of its own, found by the name ``BENCHMARK.json`` gives:
``configs/<config>.json``, ``traffic/<traffic>.json``,
``limits/<workload>.json`` (the check's limits and per-row tolerances),
``metrics/<metric>.py`` (a ``read(trace)``
that returns the value, or None where the trace holds nothing to read).
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import sys
import time


HERE = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN = ("jax", "jaxlib", "flax", "doa_mpc_tpu")


def load_json(path):
    with open(path) as f:
        return json.load(f)


def find(entries, name, what):
    for e in entries:
        if e["name"] == name:
            return e
    raise SystemExit(f"mpcbench: no {what} named {name!r} in BENCHMARK.json")


def cell_files(bench: dict, workload: str):
    """(cell, config, mix, limits) of a workload, each found by name;
    ``limits`` is the whole limits file (``limits``, ``row_tol``)."""
    cell = find(bench["workloads"], workload, "workload")
    entry = find(bench["configs"], cell["config"], "config")
    config = load_json(os.path.join(os.path.dirname(HERE), entry["file"]))
    mix = load_json(os.path.join(HERE, "traffic", cell["traffic"] + ".json"))
    limits = load_json(os.path.join(HERE, "limits", workload + ".json"))
    return cell, config, mix, limits


def metrics_for(bench: dict, section: str, workload: str) -> list:
    """The metrics of ``section`` that this cell reports."""
    return [m for m in bench[section] if workload in m.get("workloads", [workload])]


def reader(name: str):
    """``metrics/<name>.py``'s ``read``."""
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("mpcbench_metric_" + name.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def end_to_end(name: str, window: dict, setup_s: float):
    """An end-to-end metric from the window: solves per second over the
    whole window, every row of every tick over its seconds, resets
    included; the set-up seconds."""
    if name == "solves_per_s":
        return window["solves"] / window["window_s"]
    if name == "setup_s":
        return setup_s
    raise ValueError(f"no end-to-end metric {name!r}")


def forbidden_modules() -> list:
    """Modules loaded in this process whose top-level name is JAX's or the
    JAX package's, compared whole (``doa_mpc_tpu_torch`` is not
    ``doa_mpc_tpu``)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run_cell(bench, workload, seed, seconds, trace, device, t_start, parts, sync):
    """One run of a cell; returns (result dict, check lines). ``parts``
    holds the set-up seconds spent before this call (imports)."""
    import torch

    from mpcbench import check, generator, system

    cell, config, mix, lim = cell_files(bench, workload)
    limits = lim["limits"]
    if device.type == "cuda":
        parts.update(system.load_kernels(config))
    t1 = time.perf_counter()
    sysm = system.System(config, device, random_move=mix["noise"])
    traffic = generator.Traffic(mix, config, seed, device)
    loop = generator.Loop(sysm, mix, traffic, capture=generator.check_ticks(mix, seed))
    t2 = time.perf_counter()
    loop.reset()
    sync()
    t_worlds = time.perf_counter()
    for _ in range(mix["warm_ticks"]):
        loop.step()
    sync()
    t3 = time.perf_counter()
    parts.update(controller_s=t2 - t1, worlds_s=t_worlds - t2, warm_s=t3 - t_worlds)
    setup_s = t3 - t_start
    print("mpcbench setup " + json.dumps(dict(setup_s=setup_s, **parts)), file=sys.stderr,
          flush=True)

    window = generator.run_window(loop, seconds, sync)
    generator.finish_captures(loop)
    tr = None
    if trace:
        from mpcbench import trace as trace_mod
        tr = trace_mod.profile_segment(loop, mix["trace_ticks"], config, sync)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

    captured, starts = loop.captured, loop.starts
    del loop, sysm
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t4 = time.perf_counter()
    numbers = check.compare(captured, starts, config, device, lim["row_tol"])
    check_s = time.perf_counter() - t4
    correct = check.verdict(numbers, limits)
    failed = sum(int((~torch.isfinite(c["out"]["x0"]).all(1)).sum()) for c in captured)

    metrics = {}
    if trace:
        for m in metrics_for(bench, "per_layer", workload):
            v = reader(m["name"])(tr)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in metrics_for(bench, "end_to_end", workload):
            metrics[m["name"]] = {"value": end_to_end(m["name"], window, setup_s),
                                  "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": cell["chips"], "memory_peak_bytes": int(peak)}
    if tr is not None:
        dev.update(busy_s=tr.busy_s(), window_s=tr.window_s)
    result = {"correct": bool(correct), "attempted": int(window["solves"]),
              "failed": failed, "metrics": metrics, "device": dev}
    if tr is not None:
        result["breakdown"] = tr.breakdown()
    result["window"] = {"seconds": window["window_s"], "ticks": window["ticks"],
                        "compared_ticks": [c["n"] for c in captured], "check_s": check_s}
    result["check"] = {k: {"value": numbers.get(k, math.nan), "limit": limits[k]}
                       for k in check.NUMBERS}
    lines = [f"check {k} {numbers.get(k, math.nan)!r} limit {limits[k]!r}" for k in check.NUMBERS]
    return result, lines
