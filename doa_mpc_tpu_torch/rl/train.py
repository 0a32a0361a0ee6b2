"""DDPG subgoal training loop (``doa_mpc_tpu/rl/train.py``).

reset -> act -> env.step -> buffer -> update, batched: every env step
advances B scenarios through ``k_ticks`` MPC ticks on the device. All draws
come from one ``torch.Generator`` seeded with ``seed``.

    python -m doa_mpc_tpu_torch.rl.train --episodes 10 --batch 64
"""

from __future__ import annotations

import argparse
import time

import torch

from doa_mpc_tpu_torch.config import SolverOptions, WorldSpec
from doa_mpc_tpu_torch.rl.ddpg import DDPG, DDPGConfig, ReplayBuffer, Transition
from doa_mpc_tpu_torch.rl.env import SubgoalEnv


def train(env: SubgoalEnv, agent: DDPG, num_episodes: int,
          seed: int = 0, updates_per_step: int = 1, warmup_steps: int = 5,
          verbose: bool = True):
    """Train ``agent`` on ``env`` (both on the same device) for
    ``num_episodes``: uniform actions for the first ``warmup_steps`` env
    steps, then the noisy policy, one batch of updates per step after the
    warm-up; an episode ends when every row is done or after
    ``env.max_steps``. Returns ``(agent, history)``, history holding each
    episode's mean ``reward`` and ``reached`` share."""
    gen = torch.Generator(device=env.device).manual_seed(seed)
    agent.init(gen)
    buf = ReplayBuffer.create(agent.cfg, device=env.device)
    lim = agent.cfg.act_limit
    history = []
    total_steps = 0
    for ep in range(num_episodes):
        est, obs = env.reset(gen)
        ep_reward = torch.zeros((env.batch,), dtype=env.dtype, device=env.device)
        for _ in range(env.max_steps):
            if total_steps < warmup_steps:
                actions = -lim + 2 * lim * torch.rand((env.batch, env.act_dim), generator=gen,
                                                      device=env.device)
            else:
                actions = agent.act(obs, gen, noise=True)
            new_est, new_obs, reward, done = env.step(est, actions)
            buf.add_batch(Transition(obs=obs, act=actions, rew=reward, next_obs=new_obs,
                                     done=done.to(torch.float32)))
            ep_reward = ep_reward + reward
            est, obs = new_est, new_obs
            total_steps += 1
            if total_steps >= warmup_steps:
                for _ in range(updates_per_step):
                    agent.update(buf.sample(gen, agent.cfg.batch_size))
            if bool(done.all()):
                break
        mean_r = float(ep_reward.mean())
        reached = float((est.prev_dist <= env.spec.tol).to(torch.float64).mean())
        history.append({"episode": ep, "reward": mean_r, "reached": reached})
        if verbose:
            print(f"episode {ep}: mean_reward={mean_r:.2f} reached={reached:.2%}")
    return agent, history


def main(argv=None):
    """The JAX package's argparse surface, plus ``--device``."""
    p = argparse.ArgumentParser()
    p.add_argument("--env", default="SubgoalEnv")
    p.add_argument("--render", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--timesteps", type=int, default=40)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--n_obst", type=int, default=5)
    p.add_argument("--gamma", type=float, default=0.99)
    p.add_argument("--tau", type=float, default=0.01)
    p.add_argument("--noise_stddev", type=float, default=0.1)
    p.add_argument("--hidden_size", nargs=2, type=int, default=[128, 128])
    p.add_argument("--episodes", type=int, default=10)
    p.add_argument("--k_ticks", type=int, default=10)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    spec = WorldSpec(tf=2.0, n_solv=20, n_obst=args.n_obst, qp_iter=10)
    opts = SolverOptions(qp_iter=10, integrator="rk4")
    env = SubgoalEnv(spec=spec, opts=opts, batch=args.batch, k_ticks=args.k_ticks,
                     max_steps=args.timesteps, device=args.device)
    cfg = DDPGConfig(obs_dim=env.obs_dim, act_dim=env.act_dim,
                     hidden=tuple(args.hidden_size), gamma=args.gamma,
                     tau=args.tau, noise_std=args.noise_stddev)
    agent = DDPG(cfg, device=args.device)
    t0 = time.time()
    _, history = train(env, agent, args.episodes, seed=args.seed)
    print(f"trained {args.episodes} episodes in {time.time() - t0:.1f}s")
    return history


if __name__ == "__main__":
    main()
