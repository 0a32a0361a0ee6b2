"""The comparison that decides ``correct``.

Closed-loop rows are chaotic: a rounding difference in one tick's solve
moves a row's whole later path, so no reference can replay a window's
rows from their start. The reference therefore follows the program tick by
tick from the program's own state: for each tick the check compares (drawn
from the seed), it runs the plain reference (:mod:`mpcbench.reference.tick`,
float64) on the loop state the program's tick received, with the same
noise, goal and cost, and compares the tick's output, every row. The start
of the window's first fresh batch is compared by itself (the reference
builds it from the same worlds).

Numbers compared (each against the cell's limit, ``limits/<cell>.json``):

- ``start_gap_max``: the fresh batch's state, widest gap over rows;
- ``world_gap_max``: the obstacles after the tick (positions and
  velocities), widest gap over rows;
- ``state_gap_p90``: the plant state after the tick (the row's widest
  component gap), 90th percentile over the compared rows;
- ``plan_gap_p50``: the shifted warm start (state and control horizons),
  median over the rows: its far stages are loosely determined, and f32
  solves leave a tenth of the rows 1e-2 or more from the float64 one;
- ``metric_gap_p90``: the running metrics (min margin, distance to goal,
  steps, resets; a flag that differs counts 1), 90th percentile;
- ``rows_off_pct``: a wrong answer in a minority of rows, which the
  percentiles above let through: the share of the compared rows whose
  plant-state gap passes the cell's per-row tolerance ``row_tol["state"]``
  or whose plan gap passes ``row_tol["plan"]`` (``limits/<cell>.json``),
  among the rows that the configuration's precision determines. In a few
  rows a tick the QP is so ill-conditioned that the reference itself, run
  in the configuration's precision (float32), lands as far from its float64
  answer; those rows are not counted as off, since at that precision no
  answer is closer.

The control puts the reference itself, computed in bfloat16, in the
program's place (:func:`control_outputs`).
"""

from __future__ import annotations

import math

import torch

from mpcbench.reference import tick as ref

NUMBERS = ("start_gap_max", "world_gap_max", "state_gap_p90", "plan_gap_p50",
           "metric_gap_p90", "rows_off_pct")
FLAGS = ("done", "reached", "oob")


def _to(d: dict, dtype) -> dict:
    return {k: v.to(dtype) if v.is_floating_point() else v for k, v in d.items()}


def _gap(a, b):
    """Per-row widest absolute gap of two (B, ...) float tensors, in float64;
    equal infinities give 0, a NaN or a lone infinity gives inf."""
    a, b = a.double().reshape(a.shape[0], -1), b.double().reshape(b.shape[0], -1)
    g = (a - b).abs()
    g = torch.where(a == b, torch.zeros_like(g), g)
    g = torch.where(torch.isnan(g), torch.full_like(g, math.inf), g)
    return g.amax(1)


def tick_gaps(out: dict, want: dict) -> dict:
    """Per-row gaps of one tick's output against the reference's."""
    metric = torch.stack([_gap(out["min_margin"], want["min_margin"]),
                          _gap(out["dist"], want["dist"]),
                          _gap(out["steps"], want["steps"]),
                          _gap(out["resets"], want["resets"])]
                         + [(out[f] != want[f]).double() for f in FLAGS], 1).amax(1)
    return dict(world=torch.maximum(_gap(out["pos"], want["pos"]), _gap(out["vel"], want["vel"])),
                state=_gap(out["x0"], want["x0"]),
                plan=torch.maximum(_gap(out["x_traj"], want["x_traj"]),
                                   _gap(out["u_traj"], want["u_traj"])),
                metric=metric)


def start_gap(out: dict, want: dict) -> torch.Tensor:
    return torch.stack([_gap(out[k], want[k]) if out[k].is_floating_point()
                        else (out[k] != want[k]).double() for k in ref.STATE_KEYS], 1).amax(1)


class Case:
    """What a check needs of the configuration, on the device it runs on."""

    def __init__(self, config, device, dtype=torch.float64):
        if config["backend"] != "fused":
            raise NotImplementedError("the reference solves as the fused backend (K1) does")
        self.world, self.solver = config["world"], config["solver"]
        kw = dict(dtype=dtype, device=device)
        self.params = {k: torch.tensor(v, **kw) for k, v in config["cost"].items()}
        self.goal = torch.tensor(config["goal"], **kw)
        self.start = torch.tensor(config["start"], **kw)
        self.dtype = dtype

    def tick(self, c: dict) -> dict:
        """The reference's output for one captured tick."""
        dt = self.dtype
        noise = None if c["noise"] is None else c["noise"].to(dt)
        return ref.tick(_to(c["inp"], dt), self.goal, self.params, noise, self.world,
                        self.solver)

    def start_state(self, s: dict) -> dict:
        return ref.init_state(self.start, self.goal, s["pos"].to(self.dtype),
                              s["vel"].to(self.dtype), self.world)


def control_outputs(captured, starts, config, device):
    """The control: the reference in bfloat16 put in the program's place, as
    (captured, starts) with its outputs in place of the program's."""
    case = Case(config, device, torch.bfloat16)
    return ([dict(c, out=case.tick(c)) for c in captured],
            [dict(s, out=case.start_state(s)) for s in starts])


def row_gaps(captured, starts, config, device) -> dict:
    """Per-row gaps of the program's captured ticks and starts against the
    reference: ``world``, ``state``, ``plan``, ``metric`` over every compared
    row of every compared tick, ``state_ref``/``plan_ref`` of the reference
    run in the configuration's precision on the same rows, ``start`` over
    the fresh batch's rows (float64, on the CPU); empty where nothing was
    captured."""
    case = Case(config, device)
    own = Case(config, device, getattr(torch, config["dtype"]))
    gaps = {k: [] for k in ("world", "state", "plan", "metric", "state_ref", "plan_ref")}
    for c in captured:
        want = case.tick(c)
        for k, v in tick_gaps(c["out"], want).items():
            gaps[k].append(v.cpu())
        for k, v in tick_gaps(own.tick(c), want).items():
            if k in ("state", "plan"):
                gaps[k + "_ref"].append(v.cpu())
    sg = [start_gap(s["out"], case.start_state(s)).cpu() for s in starts]
    if not gaps["state"] or not sg:
        return {}
    return dict({k: torch.cat(v) for k, v in gaps.items()}, start=torch.cat(sg))


def numbers(g: dict, row_tol: dict) -> dict:
    """The numbers compared, from the per-row gaps."""
    if not g:
        return {}

    def q(v, p):
        return float(torch.quantile(v, p)) if torch.isfinite(v).all() else math.inf

    determined = (g["state_ref"] <= row_tol["state"]) & (g["plan_ref"] <= row_tol["plan"])
    off = determined & ((g["state"] > row_tol["state"]) | (g["plan"] > row_tol["plan"]))
    return dict(start_gap_max=float(g["start"].max()),
                world_gap_max=float(g["world"].max()),
                state_gap_p90=q(g["state"], 0.9),
                plan_gap_p50=q(g["plan"], 0.5),
                metric_gap_p90=q(g["metric"], 0.9),
                rows_off_pct=100.0 * float(off.double().mean()))


def compare(captured, starts, config, device, row_tol) -> dict:
    """The numbers compared, from the program's captured ticks and starts."""
    return numbers(row_gaps(captured, starts, config, device), row_tol)


def verdict(nums: dict, limits: dict) -> bool:
    """Every number present, finite and within its limit."""
    return all(k in nums and math.isfinite(nums[k]) and nums[k] <= limits[k]
               for k in NUMBERS)
