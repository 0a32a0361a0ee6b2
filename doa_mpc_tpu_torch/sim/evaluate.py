"""Experiment evaluation: aggregate rates and plots (``doa_mpc_tpu/sim/evaluate.py``).

It reads the spec-JSON + CSV pairs that :mod:`doa_mpc_tpu_torch.sim.experiments`
writes (the reference's schema) and computes the reference's collision and
goal ratios. The plot files keep the reference's names
(``plot_collision_rate_seperate.svg`` etc., typo and all). Only numpy is
needed; matplotlib is imported inside the plot functions.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Tuple

import numpy as np


def load_experiment_data(data_dir: str) -> List[Tuple[dict, np.ndarray]]:
    """(spec_dict, data_array) for each ``*_spec.json`` in ``data_dir``,
    sorted by file name."""
    out = []
    for fname in sorted(os.listdir(data_dir)):
        if fname.endswith("_spec.json"):
            with open(os.path.join(data_dir, fname)) as f:
                spec = json.load(f)
            csv = os.path.join(data_dir, fname[: -len("_spec.json")] + "_data.csv")
            out.append((spec, np.loadtxt(csv, delimiter=";")))
    return out


def collision_ratio(data: np.ndarray) -> float:
    """Mean of column 0 (hit)."""
    return float(np.sum(data, axis=0)[0] / data.shape[0])


def goal_ratio_excluding_collisions(data: np.ndarray) -> float:
    """Percent of runs that reached the goal without colliding."""
    d = data.copy()
    d[d[:, 0] != 0, 1] = 0
    return float(100.0 * np.sum(d, axis=0)[1] / d.shape[0])


def summarize(data_dir: str) -> List[Dict]:
    """One row of rates per CSV/JSON pair in ``data_dir``."""
    rows = []
    for spec, data in load_experiment_data(data_dir):
        rows.append({
            "scenario": spec.get("scenario"),
            "TF": spec.get("TF"), "N_SOLV": spec.get("N_SOLV"),
            "N_OBST": spec.get("N_OBST"), "QP_ITER": spec.get("QP_ITER"),
            "collision": collision_ratio(data),
            "reached": float(data[:, 1].mean()),
            "reached_no_collision_pct": goal_ratio_excluding_collisions(data),
            "oob": float(data[:, 5].mean()),
            "median_steps": float(np.median(data[:, 4])),
            "n": int(data.shape[0]),
        })
    return rows


def _plt():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def plot_graph(data_dir: str, out_dir: str = "."):
    """Collision and goal rate against the horizon, colored by N_OBST, one
    panel per scenario (EDGE, RANDOM)."""
    plt = _plt()
    from matplotlib.cm import ScalarMappable

    os.makedirs(out_dir, exist_ok=True)
    pairs = load_experiment_data(data_dir)
    for value_fn, ylabel, fname in [
        (lambda d: 100 * collision_ratio(d), "Ratio of collision (%)",
         "plot_collision_rate_seperate.svg"),
        (goal_ratio_excluding_collisions, "Ratio of goal reached (%)",
         "plot_goal_reached_rate_seperate.svg"),
    ]:
        data_dict = {}
        for spec, data in pairs:
            data_dict[(spec["TF"], spec["N_OBST"], spec["scenario"])] = value_fn(data)
        fig, ax = plt.subplots(1, 2, constrained_layout=True, sharey=True, figsize=(8, 5))
        fig.supxlabel("Horizon")
        fig.supylabel(ylabel)
        for key, val in data_dict.items():
            a = ax[0] if key[2] == "EDGE" else ax[1]
            a.scatter(key[0], val, c=key[1], cmap="brg", vmin=5, vmax=30)
        for a, title in zip(ax, ("EDGE", "RANDOM")):
            a.set_axisbelow(True)
            a.grid(color="gray", linestyle="dashed")
            a.set_title(title)
        sm = ScalarMappable(norm=plt.Normalize(5, 30), cmap="brg")
        sm.set_array([])
        cbar = fig.colorbar(sm, ax=ax[1])
        cbar.ax.set_title("N_OBST")
        fig.savefig(os.path.join(out_dir, fname))
        plt.close(fig)


def plot_graph_qp_solver(data_dir: str, out_dir: str = "."):
    """Collision and goal rate against QP_ITER."""
    plt = _plt()
    os.makedirs(out_dir, exist_ok=True)
    pairs = load_experiment_data(data_dir)
    coll = {s["QP_ITER"]: 100 * collision_ratio(d) for s, d in pairs}
    goal = {s["QP_ITER"]: 100 * float(d[:, 1].mean()) for s, d in pairs}
    fig, ax = plt.subplots(2)
    ax[0].scatter(list(coll.keys()), list(coll.values()))
    ax[0].set_ylabel("Ratio of collision (%)")
    ax[1].scatter(list(goal.keys()), list(goal.values()))
    ax[1].set_xlabel("QP_ITER")
    ax[1].set_ylabel("Ratio of goal reached (%)")
    for a in ax:
        a.set_axisbelow(True)
        a.grid(color="gray", linestyle="dashed")
    fig.savefig(os.path.join(out_dir, "plot_qp_iter.svg"))
    plt.close(fig)
