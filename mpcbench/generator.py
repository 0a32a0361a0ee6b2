"""The one traffic generator: reads a traffic mix (``traffic/<name>.json``)
and drives the system's tick with inputs drawn from ``--seed``, as a
Monte-Carlo campaign does: all rows in one batch, ``rollout_ticks`` ticks
from fresh worlds, then fresh worlds again.

``scenarios`` gives the rows of each scenario, in order: RANDOM places
obstacles uniformly in the obstacle box, EDGE on the goal corner (7, 7),
CENTER at the origin; velocities are uniform within the obstacle speed
limit. With ``noise`` each tick's obstacle velocities get a standard-normal
draw, which the generator makes and hands to the tick. Every draw comes
from one ``torch.Generator`` on the device, seeded with ``--seed``: the
same seed gives the same worlds and noise, in the same order.

``check`` says which ticks the check compares: ``ticks`` of them, drawn from
the seed among the first ``within`` ticks of the window, and the first
fresh start of the window.
"""

from __future__ import annotations

import time

import numpy as np
import torch


def clone(d: dict) -> dict:
    return {k: v.clone() for k, v in d.items()}


class Traffic:
    """Inputs drawn from the seed on the device."""

    def __init__(self, mix: dict, config: dict, seed: int, device):
        self.mix, self.world = mix, config["world"]
        self.device = torch.device(device)
        self.dtype = torch.float64 if config["dtype"] == "float64" else torch.float32
        self.gen = torch.Generator(device=self.device).manual_seed(int(seed))
        self.rows = sum(mix["scenarios"].values())

    def _uniform(self, shape, lo, hi):
        u = torch.rand(shape, generator=self.gen, dtype=self.dtype, device=self.device)
        return lo + (hi - lo) * u

    def worlds(self):
        """Obstacle positions and velocities, (rows, M, 2) each."""
        w, m = self.world, self.world["n_obst"]
        lo = (w["y_min"] + 2.0) + 1.0 + 3.0 * w["r_robot"]
        hi = -(w["y_min"] + 2.0)
        pos = []
        for scenario, n in self.mix["scenarios"].items():
            if scenario == "RANDOM":
                pos.append(self._uniform((n, m, 2), lo, hi))
            elif scenario in ("EDGE", "CENTER"):
                at = 7.0 if scenario == "EDGE" else 0.0
                pos.append(torch.full((n, m, 2), at, dtype=self.dtype, device=self.device))
            else:
                raise ValueError(f"unknown scenario {scenario!r}")
        v = w["v_max_obst"]
        return torch.cat(pos), self._uniform((self.rows, m, 2), -v, v)

    def noise(self):
        if not self.mix["noise"]:
            return None
        return torch.randn((self.rows, self.world["n_obst"], 2), generator=self.gen,
                           dtype=self.dtype, device=self.device)


def check_ticks(mix: dict, seed: int) -> set:
    """The window ticks the check compares, drawn from the seed."""
    rng = np.random.default_rng([int(seed), 1])
    c = mix["check"]
    return set(rng.choice(c["within"], size=c["ticks"], replace=False).tolist())


class Loop:
    """Drives the system's tick with one mix's traffic. ``step`` runs one
    tick (with the fresh worlds that fall due) and returns the solves it
    completed (its rows); ticks whose window index is in ``capture`` keep
    their input and output for the check."""

    def __init__(self, system, mix: dict, traffic: Traffic, capture=()):
        self.sys, self.mix, self.traffic = system, mix, traffic
        self.rows = traffic.rows
        self.capture = set(capture)
        self.captured, self.starts = [], []
        self.n = 0               # ticks run since begin()
        self.st = None
        self.span = mix["rollout_ticks"]
        self.t = self.span       # ticks into the current rollout

    def begin(self):
        """Start counting window ticks; the first step starts fresh worlds."""
        self.n, self.t = 0, self.span
        self.captured, self.starts = [], []

    def reset(self):
        """Fresh worlds and a fresh batch of the program's loop state."""
        pos, vel = self.traffic.worlds()
        self.st = self.sys.init(pos, vel)
        if not self.starts:
            self.starts.append(dict(pos=pos.clone(), vel=vel.clone(),
                                    out=clone(self.sys.as_dict(self.st))))
        self.t = 0

    def step(self) -> int:
        if self.t >= self.span:
            self.reset()
        noise = self.traffic.noise()
        keep = self.n in self.capture
        if keep:
            inp = clone(self.sys.as_dict(self.st))
        self.st = self.sys.tick(self.st, noise)
        if keep:
            self.captured.append(dict(n=self.n, inp=inp, out=clone(self.sys.as_dict(self.st)),
                                      noise=None if noise is None else noise.clone()))
        self.n += 1
        self.t += 1
        return self.rows

    def pending(self) -> bool:
        return len(self.captured) < len(self.capture) or not self.starts


def run_window(loop: Loop, seconds: float, sync) -> dict:
    """Ticks for ``seconds`` of host time from fresh worlds, then a device
    synchronize; returns the solves, the ticks and the window's seconds."""
    loop.begin()
    sync()
    t0 = time.perf_counter()
    solves = 0
    while time.perf_counter() - t0 < seconds:
        solves += loop.step()
    sync()
    return dict(solves=solves, ticks=loop.n, window_s=time.perf_counter() - t0)


def finish_captures(loop: Loop, limit_s: float = 60.0) -> None:
    """Run on past the window until every tick the check compares has
    happened (at most ``limit_s`` seconds)."""
    t0 = time.perf_counter()
    while loop.pending() and loop.n <= max(loop.capture, default=0) \
            and time.perf_counter() - t0 < limit_s:
        loop.step()
