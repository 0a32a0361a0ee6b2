"""Train the DDPG subgoal policy, then evaluate it against the fixed-goal
controller on matched resets (``scripts/rl_train_eval.py``).

1. ``rl/train.py::train`` runs ``--episodes`` episodes of ``--batch``
   scenarios, every draw from one generator seeded with ``--seed``, and
   records the learning curve.
2. :func:`evaluate` runs the greedy policy and the "subgoal = final goal"
   baseline (the plain fixed-goal controller as a constant policy) through
   the same env for ``--eval-episodes`` episodes each. Episode e of either
   arm draws its worlds and every tick's obstacle noise from a generator
   seeded from ``(seed + 1000, e)`` alone, and neither policy draws from
   it, so row i of episode e is the same world in both arms however many
   steps earlier episodes took.
3. :func:`paired` gives the matched-reset McNemar statistics, and
   :func:`main` writes ``history.json``, ``eval.json`` and ``summary.md``
   with the JAX script's keys and layout.

    python -m doa_mpc_tpu_torch.rl.train_eval --episodes 24 --out results/rl_h100/r4
    python -m doa_mpc_tpu_torch.rl.train_eval --device cpu --batch 2 --max-steps 2 ...
"""

from __future__ import annotations

import argparse
import json
import os
import re
import time
from typing import NamedTuple

import numpy as np
import torch

from doa_mpc_tpu_torch.config import SolverOptions, WorldSpec, resolve_device
from doa_mpc_tpu_torch.rl.ddpg import DDPG, DDPGConfig
from doa_mpc_tpu_torch.rl.env import SubgoalEnv
from doa_mpc_tpu_torch.rl.train import train
from doa_mpc_tpu_torch.sim.obstacles import robot_start_goal
from doa_mpc_tpu_torch.utils.profiling import device_label


def episode_generator(device, seed: int, episode: int) -> torch.Generator:
    """The generator of evaluation episode ``episode``, seeded from
    ``(seed, episode)`` alone."""
    state = np.random.SeedSequence((seed, episode)).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state))


def evaluate(env: SubgoalEnv, policy, generator_seed: int, episodes: int = 3):
    """Greedy closed-loop evaluation of ``policy`` (obs -> (B, 2) subgoals,
    drawing nothing from the env's generator). Returns the aggregates over
    the episodes, one row per episode and the per-scenario outcome vectors
    (``reached``, ``hit``; episode after episode) for matched-reset
    pairing."""
    rows = []
    per_row = {"reached": [], "hit": []}
    for ep in range(episodes):
        st, obs = env.reset(episode_generator(env.device, generator_seed, ep))
        for _ in range(env.max_steps):
            st, obs, _, done = env.step(st, policy(obs))
            if bool(done.all()):
                break
        hit = (st.loop.min_margin <= 0.0).cpu().numpy()
        reached = (st.prev_dist <= env.spec.tol).cpu().numpy()
        per_row["reached"].append(reached)
        per_row["hit"].append(hit)
        rows.append({
            "reached": float(reached.mean()),
            "hit": float(hit.mean()),
            "mean_final_dist": float(st.prev_dist.cpu().numpy().mean()),
            "mean_env_steps": float(st.t.cpu().numpy().mean()),
        })
    agg = {k: float(np.mean([r[k] for r in rows])) for k in rows[0]}
    agg["episodes"] = episodes
    agg["batch"] = env.batch
    vecs = {k: np.concatenate(v) for k, v in per_row.items()}
    return agg, rows, vecs


def paired(name: str, pol, base, better_when_true: bool) -> dict:
    """Matched-reset McNemar statistics of two outcome vectors (row i of
    both is the same world), with the Wald interval of the paired
    difference of rates."""
    pol = np.asarray(pol).astype(bool)
    base = np.asarray(base).astype(bool)
    b = int((pol & ~base).sum())     # policy-only successes/failures
    c = int((~pol & base).sum())
    z = abs(b - c) / np.sqrt(b + c) if (b + c) else 0.0
    n = len(pol)
    delta = pol.mean() - base.mean()
    # var of the paired delta: (b + c - (b - c)^2 / n) / n^2
    se = np.sqrt(max(b + c - (b - c) ** 2 / n, 0.0)) / n
    return {"metric": name, "n": n,
            "policy_rate": float(pol.mean()),
            "baseline_rate": float(base.mean()),
            "delta": float(delta),
            "delta_ci95": [float(delta - 1.96 * se), float(delta + 1.96 * se)],
            "discordant_policy_only": b, "discordant_baseline_only": c,
            "mcnemar_z": float(z),
            "significant_2sigma": bool(z > 2.0),
            "policy_better": bool((delta > 0) == better_when_true)}


def _mean(xs) -> float:
    return float(np.mean(xs)) if len(xs) else float("nan")


def _steps(n: int, sec: float) -> str:
    return f"{n} env steps" + (f", {1e3 * sec / n:.1f} ms/step" if n else "")


def layout(out: str) -> dict:
    """The keys of the three files in ``out``: each JSON file's keys, nested
    (a list of objects by the union of their keys, an empty list as
    ``[]``), and ``summary.md``'s heading
    and table lines, each table line by its first cell. Two runs' files of
    the same schema give the same layout."""
    def keys(x):
        if isinstance(x, dict):
            return {k: keys(v) for k, v in x.items()}
        if isinstance(x, list) and all(isinstance(item, dict) for item in x):
            merged = {}
            for item in x:
                merged.update(keys(item))
            return [merged] if x else []
        return None

    res = {}
    for name in ("history.json", "eval.json"):
        with open(os.path.join(out, name)) as f:
            res[name] = keys(json.load(f))
    with open(os.path.join(out, "summary.md")) as f:
        res["summary.md"] = [re.split(r"\s*\|\s*", ln)[1] if ln.startswith("|") else ln.strip()
                         for ln in f if ln.startswith(("#", "|"))]
    return res


class Run(NamedTuple):
    env: SubgoalEnv
    agent: DDPG
    history: list   # history.json's "episodes"
    result: dict    # eval.json


def main(argv=None) -> Run:
    """The JAX script's flags and defaults (but ``--out``), plus
    ``--device``."""
    ap = argparse.ArgumentParser(prog="python -m doa_mpc_tpu_torch.rl.train_eval")
    ap.add_argument("--episodes", type=int, default=40)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--k-ticks", type=int, default=10)
    ap.add_argument("--max-steps", type=int, default=40)
    ap.add_argument("--qp-iter", type=int, default=10)
    ap.add_argument("--eval-episodes", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="rl_out",
                    help="the JAX script writes results/rl_r4 by default, the committed "
                         "TPU run, which this default leaves alone")
    ap.add_argument("--scenario", default="RANDOM", choices=["RANDOM", "CENTER", "EDGE"],
                    help="world scenario for train AND eval. EDGE piles every obstacle on "
                         "the goal corner, where the fixed-goal baseline struggles")
    ap.add_argument("--n-obst", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    card = device_label(dev)
    os.makedirs(args.out, exist_ok=True)
    spec = WorldSpec(tf=2.0, n_solv=20, n_obst=args.n_obst, qp_iter=args.qp_iter)
    opts = SolverOptions(qp_iter=args.qp_iter, integrator="rk4")
    env = SubgoalEnv(spec=spec, opts=opts, batch=args.batch, k_ticks=args.k_ticks,
                     max_steps=args.max_steps, scenario=args.scenario, device=dev)
    # act_limit 7.2, not the 6.0 default: the final goal sits at (7, 7), and
    # a tanh-limited policy must be able to propose it, or the terminal
    # reward is out of its reach and the comparison is rigged against it
    cfg = DDPGConfig(obs_dim=env.obs_dim, act_dim=env.act_dim, act_limit=7.2)
    agent = DDPG(cfg, device=dev)

    t0 = time.time()
    agent, history = train(env, agent, args.episodes, seed=args.seed)
    train_s = time.time() - t0
    train_steps = env.steps_taken
    print(f"trained {args.episodes} episodes x {args.batch} scenarios in {train_s:.1f} s: "
          f"{_steps(train_steps, train_s)} ({card})", flush=True)
    with open(os.path.join(args.out, "history.json"), "w") as f:
        json.dump({"episodes": history, "train_seconds": train_s,
                   "batch": args.batch, "k_ticks": args.k_ticks,
                   "max_steps": args.max_steps, "qp_iter": args.qp_iter}, f, indent=1)

    # --- matched-reset evaluation ----------------------------------------
    _, goal = robot_start_goal(spec)
    goal_actions = torch.as_tensor(goal, dtype=torch.float32, device=dev)
    goal_actions = goal_actions.expand(args.batch, 2).clone()
    arms = {}
    for name, policy in (("policy", lambda o: agent.act(o, noise=False)),
                         ("baseline", lambda o: goal_actions)):
        t0, steps0 = time.time(), env.steps_taken
        arms[name] = evaluate(env, policy, args.seed + 1000, episodes=args.eval_episodes)
        sec, steps = time.time() - t0, env.steps_taken - steps0
        print(f"evaluated the {name} arm: {args.eval_episodes} episodes in {sec:.1f} s: "
              f"{_steps(steps, sec)} ({card})", flush=True)
    (pol_agg, pol_rows, pol_vec), (base_agg, base_rows, base_vec) = arms.values()

    pairs = [paired("reached", pol_vec["reached"], base_vec["reached"], True),
             paired("hit", pol_vec["hit"], base_vec["hit"], False)]
    result = {"scenario": args.scenario, "n_obst": args.n_obst,
              "policy": pol_agg, "baseline_fixed_goal": base_agg,
              "paired_stats": pairs,
              "policy_episodes": pol_rows, "baseline_episodes": base_rows,
              "note": "identical reset generator sequence for both arms: episode e draws "
                      "its worlds and noise from (seed + 1000, e)"}
    with open(os.path.join(args.out, "eval.json"), "w") as f:
        json.dump(result, f, indent=1)

    first = _mean([h["reward"] for h in history[:5]])
    last = _mean([h["reward"] for h in history[-5:]])
    with open(os.path.join(args.out, "summary.md"), "w") as f:
        f.write("# DDPG subgoal policy: training + matched-seed eval\n\n")
        f.write(f"{args.episodes} episodes x {args.batch} scenarios, "
                f"k_ticks={args.k_ticks}, max_steps={args.max_steps}, "
                f"qp_iter={args.qp_iter} ({train_s:.0f}s on {card})\n\n")
        f.write(f"Learning curve: mean reward first-5 episodes "
                f"{first:.1f} -> last-5 {last:.1f}\n\n")
        f.write("| arm | reached | hit | mean final dist | env steps |\n")
        f.write("|---|---|---|---|---|\n")
        for name, a in (("subgoal policy", pol_agg), ("fixed-goal baseline", base_agg)):
            f.write(f"| {name} | {a['reached']:.1%} | {a['hit']:.1%} | "
                    f"{a['mean_final_dist']:.2f} | {a['mean_env_steps']:.1f} |\n")
    print("policy   :", pol_agg, flush=True)
    print("baseline :", base_agg, flush=True)
    print(f"learning curve: first5 {first:.1f} -> last5 {last:.1f}", flush=True)
    return Run(env, agent, history, result)


if __name__ == "__main__":
    main()
