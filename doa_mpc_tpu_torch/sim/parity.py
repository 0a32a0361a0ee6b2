"""Seed-matched parity replay (``scripts/parity_seedmatch.py``).

A leg of the round-5 parity matrix, ``results/parity_r5/<leg>/``, holds a
``summary.json`` (the settings of the JAX run and its cells) and, per cell,
the per-seed CSV the JAX package wrote on a TPU,
``<stamp>_<scenario>_ours.csv``: the reference's six columns (hit,
reached, min_margin, final_dist, steps, out_of_bounds) and a seventh, the
status-4 analogue's firings (``resets``). :func:`replay` runs the cells
again through this port on the reference's exact MT19937 worlds and noise
(``sim/compat_rng.py``), so row i of every cell replays seed i; and
:func:`summarize` writes the JAX replay script's schema, holding each seed to the
TPU CSV (the reference's own CSVs are not in the repository; its rates are
the cells' ``ref_hit``/``ref_reached``).

Cells whose settings coincide but for the scenario (the RANDOM and EDGE
cells of one TF, N, M, IP budget and initial guess) run as one batch through
``sim.experiments.run_scenario_batch`` (its ``compat_rng`` path, the
scenarios' worlds and noise concatenated): with the worlds pinned, the
scenario only places the obstacles. A paired row equals the row run alone
bit for bit, on the CPU and on a card, rk4 and IRK alike: every op of the
tick computes a row from that row alone, whatever the batch (the IRK Newton
solve is kernel K3, one thread per row). Each cell's record says which
cells shared its run and how many rows the run had (``batch``,
``batch_rows``).

    python -m doa_mpc_tpu_torch.sim.parity --leg results/parity_r5/v0_baseline --out DIR

replays the leg as the TPU run did (the defaults come from its
``summary.json`` and :data:`LEG_EXTRAS`); the JAX replay script's flags override
them, ``--device cpu`` runs the kernels' plain versions.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
from typing import NamedTuple

import numpy as np
import torch

from doa_mpc_tpu_torch.config import SolverOptions, WorldSpec, default_cost_params, resolve_device
from doa_mpc_tpu_torch.sim.experiments import run_scenario_batch
from doa_mpc_tpu_torch.utils.profiling import device_label

# the JAX backends and their counterparts here
BACKEND_OF = {"fused": "fused", "xla": "torch", "pallas": "riccati"}

# what a leg's summary.json does not record, by the leg's path under
# results/parity_r5: the IP budget the run used in place of each cell's own
# (--qp-iter-override) and the forecast typo fixed (--fix-pred-bug); from
# results/parity_r5/forensics.md ("IP-iteration budget re-validation",
# "Production configuration", "The framework's own quality headline")
LEG_EXTRAS = {
    "prod_rk4_qp6": dict(qp_iter_override=6),
    "prod_fixedbug": dict(qp_iter_override=6, fix_pred_bug=True),
    "qp_budget/qp6": dict(qp_iter_override=6),
    "qp_budget/qp4": dict(qp_iter_override=4),
}


@dataclasses.dataclass(frozen=True)
class Settings:
    """How a leg is replayed: the JAX replay script's flags, the backend named as
    in this port (``sim.closed_loop.BACKENDS``)."""

    backend: str = "fused"
    integrator: str = "irk"
    fail_mu: float = 1e-7
    fail_stat: float = 1e-4
    status4: bool = False
    slack_unscaled: bool = False
    cost_unscaled: bool = False
    lm_raw: bool = False
    slack_mult: float | None = None
    f64: bool = False
    qp_iter_override: int | None = None
    fix_pred_bug: bool = False
    seeds: int | None = None
    max_iter: int = 400


class Leg(NamedTuple):
    """A committed leg: its name (path under results/parity_r5), its
    ``summary.json`` without the cells, and the cells, each with its TPU
    per-seed rows under ``"tpu"`` ((runs, 7) float64)."""

    name: str
    meta: dict
    cells: list


class CellResult(NamedTuple):
    """One replayed cell: the leg's cell record, this run's rows for it."""

    cell: dict
    rows: np.ndarray      # (n, 7): the reference's six columns and resets
    wall_s: float         # the seconds of the run that held the cell
    batch: tuple = ()     # the cells of that run (cell_id), this one among them
    batch_rows: int = 0   # the rows of that run


def cell_id(cell: dict) -> str:
    """``<stamp>_<scenario>``, as the cell's CSV is named."""
    return f"{cell['stamp']}_{cell['scenario']}"


def leg_name(leg_dir: str) -> str:
    """``v0_baseline``, ``qp_budget/qp4``: the path under ``parity_r5``
    (the last component where there is none)."""
    parts = os.path.normpath(os.path.abspath(leg_dir)).split(os.sep)
    if "parity_r5" in parts[:-1]:
        return "/".join(parts[len(parts) - parts[::-1].index("parity_r5"):])
    return parts[-1]


def load_leg(leg_dir: str) -> Leg:
    """Read a leg's ``summary.json`` and its cells' TPU CSVs."""
    with open(os.path.join(leg_dir, "summary.json")) as f:
        summ = json.load(f)
    cells = []
    for c in summ.pop("cells"):
        tpu = np.loadtxt(os.path.join(leg_dir, f"{c['stamp']}_{c['scenario']}_ours.csv"),
                         delimiter=";", ndmin=2)
        cells.append(dict(c, tpu=tpu))
    return Leg(leg_name(leg_dir), summ, cells)


def leg_settings(leg: Leg, **overrides) -> Settings:
    """The settings the TPU run of ``leg`` used: its ``summary.json`` meta,
    then :data:`LEG_EXTRAS`, then ``overrides`` (None leaves a value)."""
    m = leg.meta
    base = dict(backend=BACKEND_OF[m["backend"]], integrator=m["integrator"],
                fail_mu=m["fail_mu_tol"], fail_stat=m["fail_stat_tol"], status4=m["status4"],
                slack_unscaled=not m["slack_scale_dt"], cost_unscaled=not m["cost_scale_dt"],
                lm_raw=m["cost_scale_dt"] and not m["lm_scale_dt"],
                slack_mult=m["slack_mult"], f64=m["f64"], seeds=m["seeds"])
    base.update(LEG_EXTRAS.get(leg.name, {}))
    base.update({k: v for k, v in overrides.items() if v is not None})
    return Settings(**base)


def cell_config(cell: dict, s: Settings):
    """The cell's ``WorldSpec`` and ``SolverOptions``, built as
    ``parity_seedmatch.py`` builds them."""
    spec = WorldSpec(tf=cell["tf"], n_solv=cell["n_solv"], n_obst=cell["n_obst"],
                     qp_iter=cell["qp_iter"])
    opts = SolverOptions(
        qp_iter=s.qp_iter_override or cell["qp_iter"], integrator=s.integrator,
        compat_pred_bug=not s.fix_pred_bug, cost_scale_dt=not s.cost_unscaled,
        slack_scale_dt=not s.slack_unscaled, lm_scale_dt=not (s.lm_raw or s.cost_unscaled),
        init_guess_when_error=s.status4, compat_brake_bug=s.status4,
        fail_mu_tol=s.fail_mu, fail_stat_tol=s.fail_stat,
        init_guess="interpolate" if cell["interpolate"] else "current")
    return spec, opts


def cost_params(spec: WorldSpec, s: Settings, dtype, device):
    """The default cost, its slack penalty scaled by ``slack_mult``."""
    params = default_cost_params(spec, dtype=dtype, device=device)
    if s.slack_mult:
        params = dataclasses.replace(params, slack_scale=params.slack_scale * s.slack_mult)
    return params


def plan(cells: list, s: Settings) -> list:
    """The cells grouped into runs: cells whose ``WorldSpec`` (but for its
    ``qp_iter``, which the options carry) and ``SolverOptions`` coincide
    share one run, in the order of their first cell."""
    groups = {}
    for c in cells:
        spec, opts = cell_config(c, s)
        groups.setdefault((spec.replace(qp_iter=opts.qp_iter), opts), []).append(c)
    return list(groups.values())


def run_group(cells: list, s: Settings, n_runs: int, device="cuda"):
    """Run one entry of :func:`plan` as one batch of ``n_runs`` seeds per
    scenario (``run_scenario_batch`` with ``compat_rng``). Returns
    ``({scenario: (n_runs, 7) rows}, final LoopState, seconds)``; the
    seconds span the whole call."""
    dev = resolve_device(device)
    spec, opts = cell_config(cells[0], s)
    dtype = torch.float64 if s.f64 else torch.float32
    scenarios = list(dict.fromkeys(c["scenario"] for c in cells))
    t0 = time.time()
    data, final = run_scenario_batch(
        spec, opts, scenarios, n_runs=n_runs, max_iter=s.max_iter, dtype=dtype,
        params=cost_params(spec, s, dtype, dev), backend=s.backend, return_state=True,
        compat_rng=True, device=dev)
    rows = np.column_stack([data, final.resets.cpu().numpy().astype(np.float64)])
    wall = time.time() - t0
    return ({sc: rows[i * n_runs:(i + 1) * n_runs] for i, sc in enumerate(scenarios)},
            final, wall)


def select(cells: list, only: str | None) -> list:
    """The cells whose stamp or scenario contains ``only`` (all without)."""
    return [c for c in cells if not only or only in c["stamp"] or only in c["scenario"]]


def runs_of(leg: Leg, s: Settings) -> int:
    """Seeds per cell: the TPU CSVs' rows, or the first ``s.seeds``."""
    n = min(len(c["tpu"]) for c in leg.cells)
    return min(n, s.seeds) if s.seeds else n


def replay(leg: Leg, s: Settings, cells: list | None = None, device="cuda",
           each_run=None) -> list:
    """Run ``cells`` (default: all the leg's), one batch per entry of
    :func:`plan`; returns a :class:`CellResult` per cell. ``each_run``, a
    context-manager factory, is entered with each run's cells around the
    run (a caller counts kernel launches per run so)."""
    n_runs = runs_of(leg, s)
    out = []
    for group in plan(leg.cells if cells is None else cells, s):
        with (each_run or contextlib.nullcontext)(group):
            rows, _, wall = run_group(group, s, n_runs, device)
        batch = tuple(cell_id(c) for c in group)
        out += [CellResult(c, rows[c["scenario"]], wall, batch, n_runs * len(rows))
                for c in group]
    return out


def _mcnemar_z(b: int, c: int) -> float:
    return abs(b - c) / np.sqrt(b + c) if b + c else 0.0


def cell_stats(res: CellResult) -> dict:
    """The JAX replay script's cell record (``parity_seedmatch.py``), its per-seed
    comparisons taken against the TPU CSV, plus ``tpu_hit``,
    ``tpu_reached``, ``tpu_resets_mean``, ``wall_s`` and the run's
    ``batch`` and ``batch_rows``."""
    data = res.rows
    c = {k: v for k, v in res.cell.items()
         if k in ("stamp", "scenario", "tf", "n_solv", "n_obst", "qp_iter", "interpolate",
                  "ref_hit", "ref_reached", "ref_oob", "ref_runs")}
    tpu = res.cell["tpu"][:len(data)]
    hit, reached, oob = data[:, 0].mean(), data[:, 1].mean(), data[:, 5].mean()
    hit_we = int(((data[:, 0] == 1) & (tpu[:, 0] == 0)).sum())
    hit_tpu = int(((data[:, 0] == 0) & (tpu[:, 0] == 1)).sum())
    both = (data[:, 1] == 1) & (tpu[:, 1] == 1)

    def co(a, col):
        return float(a[both, col].mean()) if both.any() else None

    return dict(
        c, hit=float(hit), reached=float(reached), oob=float(oob),
        reached_gap=float(reached - c["ref_reached"]), hit_gap=float(hit - c["ref_hit"]),
        agree_reached=float((data[:, 1] == tpu[:, 1]).mean()),
        agree_hit=float((data[:, 0] == tpu[:, 0]).mean()),
        reached_we_only=int(((data[:, 1] == 1) & (tpu[:, 1] == 0)).sum()),
        reached_ref_only=int(((data[:, 1] == 0) & (tpu[:, 1] == 1)).sum()),
        hit_we_only=hit_we, hit_ref_only=hit_tpu, hit_mcnemar_z=float(_mcnemar_z(hit_we, hit_tpu)),
        coreached_steps_ours=co(data, 4), coreached_steps_ref=co(tpu, 4),
        coreached_margin_ours=co(data, 2), coreached_margin_ref=co(tpu, 2),
        resets_mean=float(data[:, 6].mean()), resets_max=int(data[:, 6].max()),
        runs=len(data), seedmatched=True,
        tpu_hit=float(tpu[:, 0].mean()), tpu_reached=float(tpu[:, 1].mean()),
        tpu_resets_mean=float(tpu[:, 6].mean()), wall_s=float(res.wall_s),
        batch=list(res.batch), batch_rows=int(res.batch_rows))


def aggregate(stats: list) -> dict:
    """Over every seed of the cells: rates, per-seed agreement with the TPU
    CSVs, the pooled hit McNemar z and the mean resets."""
    n = np.array([r["runs"] for r in stats], dtype=np.float64)

    def mean(k):
        return float(np.dot(n, [r[k] for r in stats]) / n.sum())

    b, c = sum(r["hit_we_only"] for r in stats), sum(r["hit_ref_only"] for r in stats)
    return dict(seeds=int(n.sum()), hit_mcnemar_z=float(_mcnemar_z(b, c)),
                **{k: mean(k) for k in ("hit", "reached", "tpu_hit", "tpu_reached", "agree_hit",
                                        "agree_reached", "resets_mean", "tpu_resets_mean")})


def summarize(leg: Leg, s: Settings, results: list, out_dir: str, device: str) -> dict:
    """Write each cell's ``<stamp>_<scenario>_ours.csv`` (7 columns),
    ``summary.json`` (the JAX replay script's meta and cell records, merged with
    the cells an earlier run wrote there, plus ``leg``, ``engine``,
    ``device``, the settings the meta lacks and ``aggregate``) and
    ``summary.md`` into ``out_dir``; returns the summary."""
    os.makedirs(out_dir, exist_ok=True)
    for r in results:
        np.savetxt(os.path.join(out_dir, f"{r.cell['stamp']}_{r.cell['scenario']}_ours.csv"),
                   r.rows, delimiter=";")
    spath = os.path.join(out_dir, "summary.json")
    merged = {}
    if os.path.exists(spath):
        with open(spath) as f:
            merged = {(r["stamp"], r["scenario"]): r for r in json.load(f).get("cells", [])}
    merged.update({(r.cell["stamp"], r.cell["scenario"]): cell_stats(r) for r in results})
    rows = sorted(merged.values(), key=lambda r: (r["stamp"], r["scenario"]))
    summary = {
        "backend": s.backend, "integrator": s.integrator, "seedmatched": True,
        "fail_mu_tol": s.fail_mu, "fail_stat_tol": s.fail_stat, "status4": s.status4,
        "slack_scale_dt": not s.slack_unscaled, "cost_scale_dt": not s.cost_unscaled,
        "lm_scale_dt": not (s.lm_raw or s.cost_unscaled), "slack_mult": s.slack_mult,
        "f64": s.f64, "seeds": s.seeds, "qp_iter_override": s.qp_iter_override,
        "fix_pred_bug": s.fix_pred_bug, "max_iter": s.max_iter, "leg": leg.name,
        "engine": "doa_mpc_tpu_torch", "device": device,
        "aggregate": aggregate(rows), "cells": rows}
    with open(spath, "w") as f:
        json.dump(summary, f, indent=1)
    with open(os.path.join(out_dir, "summary.md"), "w") as f:
        f.write(f"# Seed-matched parity of leg {leg.name} (exact MT19937 worlds + noise)\n\n"
                f"doa_mpc_tpu_torch, backend={s.backend}, integrator={s.integrator}, "
                f"{'f64' if s.f64 else 'f32'}, device {device}; row i of each cell uses the "
                "reference's np.random.seed(i) streams verbatim; per-seed agreement, "
                "discordant counts and McNemar z against the TPU CSV; \"batch\" is the rows "
                "of the run that held the cell (the cells of one setting run together; a row "
                "does not depend on it).\n\n"
                "| cell | scenario | TF | qp | init | ours hit | TPU hit | ref hit | "
                "ours reached | TPU reached | ref reached | agree hit | agree reached | "
                "hit z | resets ours / TPU | batch | wall s |\n"
                "|---|---|---|---|---|---|---|---|---|---|---|---|---|---|---|---|---|\n")
        for r in rows:
            f.write(f"| {r['stamp']} | {r['scenario']} | {r['tf']} | {r['qp_iter']} | "
                    f"{'interp' if r['interpolate'] else 'current'} | {r['hit']:.1%} | "
                    f"{r['tpu_hit']:.1%} | {r['ref_hit']:.1%} | {r['reached']:.1%} | "
                    f"{r['tpu_reached']:.1%} | {r['ref_reached']:.1%} | {r['agree_hit']:.0%} | "
                    f"{r['agree_reached']:.0%} | {r['hit_mcnemar_z']:.2f} | "
                    f"{r['resets_mean']:.2f} / {r['tpu_resets_mean']:.2f} | {r['batch_rows']} | "
                    f"{r['wall_s']:.1f} |\n")
    return summary


def main(argv=None):
    """The JAX replay script's flags (defaults from the leg), plus ``--leg`` and
    ``--device``."""
    ap = argparse.ArgumentParser(prog="python -m doa_mpc_tpu_torch.sim.parity")
    ap.add_argument("--leg", required=True,
                    help="a leg's directory, e.g. results/parity_r5/v0_baseline")
    ap.add_argument("--max-iter", type=int, default=400)
    ap.add_argument("--backend", choices=["fused", "torch", "riccati"],
                    help="default: the leg's (fused -> fused, xla -> torch, pallas -> riccati)")
    ap.add_argument("--integrator", choices=["irk", "rk4"])
    ap.add_argument("--fail-mu", type=float)
    ap.add_argument("--fail-stat", type=float)
    ap.add_argument("--only", help="only the cells whose stamp or scenario contains this")
    ap.add_argument("--f64", action="store_true", default=None)
    ap.add_argument("--qp-iter-override", type=int)
    ap.add_argument("--status4", action="store_true", default=None,
                    help="arm the status-4 analogue and the plant brake")
    ap.add_argument("--slack-mult", type=float)
    ap.add_argument("--slack-unscaled", action="store_true", default=None)
    ap.add_argument("--cost-unscaled", action="store_true", default=None)
    ap.add_argument("--lm-raw", action="store_true", default=None)
    ap.add_argument("--seeds", type=int, help="only the first K seeds of each cell")
    ap.add_argument("--fix-pred-bug", action="store_true", default=None)
    ap.add_argument("--out", help="default: parity_out/<leg>")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    leg = load_leg(args.leg)
    s = leg_settings(leg, max_iter=args.max_iter, backend=args.backend,
                     integrator=args.integrator, fail_mu=args.fail_mu, fail_stat=args.fail_stat,
                     f64=args.f64, qp_iter_override=args.qp_iter_override, status4=args.status4,
                     slack_mult=args.slack_mult, slack_unscaled=args.slack_unscaled,
                     cost_unscaled=args.cost_unscaled, lm_raw=args.lm_raw, seeds=args.seeds,
                     fix_pred_bug=args.fix_pred_bug)
    out = args.out or os.path.join("parity_out", leg.name)
    dev = resolve_device(args.device)
    device = device_label(dev)
    print(f"leg {leg.name}: {s} on {device}", flush=True)
    results = replay(leg, s, select(leg.cells, args.only), device=dev)
    summary = summarize(leg, s, results, out, device)
    for r in summary["cells"]:
        print(f"{r['stamp']} {r['scenario']:6s} TF={r['tf']} qp={r['qp_iter']:3d}"
              f"{' interp' if r['interpolate'] else ''} | ours hit/reach "
              f"{r['hit']:.1%}/{r['reached']:.1%} | TPU {r['tpu_hit']:.1%}/{r['tpu_reached']:.1%}"
              f" | ref {r['ref_hit']:.1%}/{r['ref_reached']:.1%} | agree "
              f"{r['agree_hit']:.0%}/{r['agree_reached']:.0%} z={r['hit_mcnemar_z']:.2f}"
              f" | resets {r['resets_mean']:.2f} (TPU {r['tpu_resets_mean']:.2f})"
              f" | {r['wall_s']:.1f} s", flush=True)
    a = summary["aggregate"]
    print(f"{a['seeds']} seeds: hit {a['hit']:.3f} (TPU {a['tpu_hit']:.3f}) reached "
          f"{a['reached']:.3f} (TPU {a['tpu_reached']:.3f}); agreement hit {a['agree_hit']:.3f} "
          f"reached {a['agree_reached']:.3f}; hit McNemar z {a['hit_mcnemar_z']:.2f}; resets "
          f"{a['resets_mean']:.2f} (TPU {a['tpu_resets_mean']:.2f}); wrote {out}", flush=True)
    return summary


if __name__ == "__main__":
    main()
