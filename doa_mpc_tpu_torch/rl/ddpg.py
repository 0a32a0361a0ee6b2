"""DDPG agent for MPC subgoal proposal (``doa_mpc_tpu/rl/ddpg.py``).

Actor and critic are MLPs of ``nn.Linear`` + ReLU over ``hidden`` (the
reference's [128, 128] layout), initialized as flax's ``Dense`` is: LeCun
normal kernels (a normal truncated at two standard deviations, scaled to
variance 1 / fan_in) and zero biases. The agent keeps target copies
updated by polyak averaging, a device-resident uniform replay ring, and
one ``torch.optim.Adam`` per network (the defaults of optax's ``adam``:
betas 0.9 / 0.999, eps 1e-8 outside the square root).

The actor emits a 2-D subgoal in grid coordinates, ``act_limit * tanh``,
which the MPC closed loop takes as its per-row goal (``rl/env.py``).
"""

from __future__ import annotations

import copy
import dataclasses
import math
from typing import NamedTuple

import torch
from torch import nn

from doa_mpc_tpu_torch.config import resolve_device


@dataclasses.dataclass(frozen=True)
class DDPGConfig:
    obs_dim: int = 18          # 3 * (n_obst + 1)
    act_dim: int = 2           # (x, y) subgoal
    hidden: tuple = (128, 128)
    act_limit: float = 6.0     # subgoals within the robot box (+-6)
    gamma: float = 0.99
    tau: float = 0.01          # soft target update
    actor_lr: float = 1e-4
    critic_lr: float = 1e-3
    buffer_size: int = 100_000
    batch_size: int = 256
    noise_std: float = 0.1


class _MLP(nn.Module):
    def __init__(self, in_dim: int, hidden: tuple, out_dim: int):
        super().__init__()
        dims = (in_dim,) + tuple(hidden) + (out_dim,)
        self.layers = nn.ModuleList(nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))

    def forward(self, x):
        for layer in self.layers[:-1]:
            x = torch.relu(layer(x))
        return self.layers[-1](x)


class Actor(nn.Module):
    def __init__(self, cfg: DDPGConfig):
        super().__init__()
        self.cfg = cfg
        self.mlp = _MLP(cfg.obs_dim, cfg.hidden, cfg.act_dim)

    def forward(self, obs):
        return self.cfg.act_limit * torch.tanh(self.mlp(obs))


class Critic(nn.Module):
    def __init__(self, cfg: DDPGConfig):
        super().__init__()
        self.cfg = cfg
        self.mlp = _MLP(cfg.obs_dim + cfg.act_dim, cfg.hidden, 1)

    def forward(self, obs, act):
        return self.mlp(torch.cat([obs, act], -1))[..., 0]


@torch.no_grad()
def _lecun_init(module: nn.Module, generator: torch.Generator | None = None) -> nn.Module:
    """flax ``Dense``'s initialization of every ``nn.Linear`` in ``module``:
    kernels from a normal truncated at +-2 standard deviations, scaled to
    variance 1 / fan_in (``variance_scaling(1, "fan_in",
    "truncated_normal")``), and zero biases."""
    for layer in module.modules():
        if isinstance(layer, nn.Linear):
            # the standard deviation of the unit normal truncated to [-2, 2]
            std = math.sqrt(1.0 / layer.in_features) / 0.87962566103423978
            nn.init.trunc_normal_(layer.weight, std=std, a=-2 * std, b=2 * std,
                                  generator=generator)
            layer.bias.zero_()
    return module


class Transition(NamedTuple):
    obs: torch.Tensor
    act: torch.Tensor
    rew: torch.Tensor
    next_obs: torch.Tensor
    done: torch.Tensor


class ReplayBuffer:
    """Device-resident ring of transitions. The write position and the fill
    level are host integers, so adding and sampling never wait for the
    card."""

    def __init__(self, data: Transition):
        self.data = data
        self.ptr = 0
        self.size = 0

    @staticmethod
    def create(cfg: DDPGConfig, dtype=torch.float32, device="cuda") -> "ReplayBuffer":
        n, dev = cfg.buffer_size, resolve_device(device)
        kw = dict(dtype=dtype, device=dev)
        return ReplayBuffer(Transition(
            obs=torch.zeros((n, cfg.obs_dim), **kw), act=torch.zeros((n, cfg.act_dim), **kw),
            rew=torch.zeros((n,), **kw), next_obs=torch.zeros((n, cfg.obs_dim), **kw),
            done=torch.zeros((n,), **kw)))

    def add_batch(self, batch: Transition) -> None:
        """Write the rows of ``batch`` at the write position, wrapping
        around."""
        n = self.data.obs.shape[0]
        b = batch.obs.shape[0]
        idx = (self.ptr + torch.arange(b, device=self.data.obs.device)) % n
        for buf, new in zip(self.data, batch):
            buf[idx] = new.to(buf.dtype)
        self.ptr = (self.ptr + b) % n
        self.size = min(self.size + b, n)

    def sample(self, generator: torch.Generator | None, batch_size: int) -> Transition:
        """``batch_size`` rows drawn uniformly from the filled part."""
        idx = torch.randint(0, max(self.size, 1), (batch_size,), generator=generator,
                            device=self.data.obs.device)
        return Transition(*(a[idx] for a in self.data))


class DDPG:
    """Standard DDPG (Lillicrap et al. 2015). :meth:`init` builds the
    networks, their targets and optimizers on ``device``; the agent keeps
    them (``actor``, ``critic``, ``actor_t``, ``critic_t``)."""

    def __init__(self, cfg: DDPGConfig, device="cuda", dtype=torch.float32):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = dtype

    def init(self, generator: torch.Generator | None = None) -> "DDPG":
        kw = dict(device=self.device, dtype=self.dtype)
        self.actor = _lecun_init(Actor(self.cfg).to(**kw), generator)
        self.critic = _lecun_init(Critic(self.cfg).to(**kw), generator)
        self.actor_t = copy.deepcopy(self.actor).requires_grad_(False)
        self.critic_t = copy.deepcopy(self.critic).requires_grad_(False)
        self.opt_actor = torch.optim.Adam(self.actor.parameters(), lr=self.cfg.actor_lr)
        self.opt_critic = torch.optim.Adam(self.critic.parameters(), lr=self.cfg.critic_lr)
        return self

    @torch.no_grad()
    def act(self, obs, generator: torch.Generator | None = None, noise: bool = False):
        """The deterministic policy, plus Gaussian exploration noise of
        ``noise_std * act_limit`` with ``noise``, clipped to the action box."""
        cfg = self.cfg
        a = self.actor(obs.to(self.dtype))
        if noise:
            a = a + cfg.noise_std * cfg.act_limit * torch.randn(
                a.shape, generator=generator, dtype=a.dtype, device=a.device)
        return torch.clamp(a, -cfg.act_limit, cfg.act_limit)

    @staticmethod
    def _step(opt: torch.optim.Optimizer, net: nn.Module, loss: torch.Tensor) -> None:
        """One optimizer step on the gradient of ``loss`` with respect to
        ``net``'s parameters only (left in their ``.grad``)."""
        params = list(net.parameters())
        for p, g in zip(params, torch.autograd.grad(loss, params)):
            p.grad = g
        opt.step()

    def update(self, batch: Transition) -> dict:
        """One critic step, then one actor step against the updated critic,
        then the polyak updates of both targets. Returns the two losses as
        tensors (no host sync)."""
        cfg = self.cfg
        with torch.no_grad():
            q_next = self.critic_t(batch.next_obs, self.actor_t(batch.next_obs))
            target = batch.rew + cfg.gamma * (1.0 - batch.done) * q_next
        critic_loss = torch.mean((self.critic(batch.obs, batch.act) - target) ** 2)
        self._step(self.opt_critic, self.critic, critic_loss)

        actor_loss = -torch.mean(self.critic(batch.obs, self.actor(batch.obs)))
        self._step(self.opt_actor, self.actor, actor_loss)

        with torch.no_grad():
            for tgt, net in ((self.actor_t, self.actor), (self.critic_t, self.critic)):
                for t, p in zip(tgt.parameters(), net.parameters()):
                    t.mul_(1 - cfg.tau).add_(cfg.tau * p)
        return {"critic_loss": critic_loss.detach(), "actor_loss": actor_loss.detach()}
