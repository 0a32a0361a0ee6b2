"""The port's RL layer (``doa_mpc_tpu_torch/rl``) against the JAX package's.

- The analogues of the 5 tests of ``tests/test_rl.py``: DDPG mechanics
  and the MPC subgoal environment.
- Actor and critic carrying flax weights (``interop.ddpg_params_from_numpy``)
  match flax's ``apply`` at 1e-5 relative in float32; one ``update`` from
  the same weights and batch gives the same losses (1e-5 relative) and the
  same gradients (1e-4 relative per layer). Adam's first step is about
  lr * sign(g), so the updated parameters are compared only where the
  gradient is far from 0.
- ``SubgoalEnv.step`` against JAX's in float64 with the noise-free
  parametric tick on both, from JAX's ``reset`` state, at 1e-8.
- ``train`` and ``python -m doa_mpc_tpu_torch.rl.train`` at tiny sizes.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from doa_mpc_tpu.config import SolverOptions as JOptions, WorldSpec as JSpec
from doa_mpc_tpu.rl.ddpg import DDPG as JDDPG, DDPGConfig as JConfig
from doa_mpc_tpu.rl.ddpg import Transition as JTransition
from doa_mpc_tpu.rl.env import SubgoalEnv as JEnv
from doa_mpc_tpu.sim.closed_loop import make_parametric_tick as j_ptick
from doa_mpc_tpu_torch import interop
from doa_mpc_tpu_torch.config import SolverOptions, WorldSpec
from doa_mpc_tpu_torch.rl.ddpg import (
    DDPG, Actor, Critic, DDPGConfig, ReplayBuffer, Transition,
)
from doa_mpc_tpu_torch.rl.env import SubgoalEnv
from doa_mpc_tpu_torch.rl.train import train
from doa_mpc_tpu_torch.sim.closed_loop import make_parametric_tick

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfg():
    return DDPGConfig(obs_dim=12, act_dim=2, hidden=(32, 32), buffer_size=512, batch_size=32)


def _agent(seed=0):
    return DDPG(_cfg(), device="cpu").init(torch.Generator().manual_seed(seed))


def _small_env(cls, **kw):
    spec = dict(tf=0.5, n_solv=5, n_obst=3, qp_iter=6)
    if cls is JEnv:
        return JEnv(spec=JSpec(**spec), opts=JOptions(qp_iter=6, integrator="rk4"),
                    dtype=jnp.float64, **kw)
    return SubgoalEnv(spec=WorldSpec(**spec), opts=SolverOptions(qp_iter=6, integrator="rk4"),
                      dtype=torch.float64, device="cpu", **kw)


# ---------------------------------------------------------------------------
# the analogues of tests/test_rl.py
# ---------------------------------------------------------------------------

def test_actor_within_limits():
    cfg = _cfg()
    agent = _agent()
    obs = torch.randn((16, cfg.obs_dim), generator=torch.Generator().manual_seed(1))
    a = agent.act(obs)
    assert a.shape == (16, cfg.act_dim)
    assert float(a.abs().max()) <= cfg.act_limit + 1e-6
    a_n = agent.act(obs, torch.Generator().manual_seed(2), noise=True)
    assert float(a_n.abs().max()) <= cfg.act_limit + 1e-6
    assert not torch.allclose(a, a_n)
    # flax Dense's initialization: zero biases, LeCun-normal kernels
    # truncated at 2 standard deviations of the untruncated normal
    first = agent.actor.mlp.layers[0]
    assert torch.equal(first.bias, torch.zeros_like(first.bias))
    std = (1.0 / cfg.obs_dim) ** 0.5 / 0.87962566103423978
    assert float(first.weight.detach().abs().max()) <= 2 * std
    assert abs(float(first.weight.detach().std()) / (1.0 / cfg.obs_dim) ** 0.5 - 1.0) < 0.2


def test_replay_buffer_ring():
    cfg = _cfg()
    buf = ReplayBuffer.create(cfg, device="cpu")
    nb = 100
    tr = Transition(obs=torch.ones((nb, cfg.obs_dim)), act=torch.ones((nb, cfg.act_dim)),
                    rew=torch.arange(nb, dtype=torch.float32),
                    next_obs=torch.ones((nb, cfg.obs_dim)), done=torch.zeros((nb,)))
    for _ in range(6):
        buf.add_batch(tr)
    assert buf.size == 512
    assert buf.ptr == 600 % 512
    # the 6th batch wrapped around: rows 0..87 hold its rewards 12..99
    np.testing.assert_array_equal(buf.data.rew[:88].numpy(), np.arange(12, 100))
    batch = buf.sample(torch.Generator().manual_seed(0), 32)
    assert batch.obs.shape == (32, cfg.obs_dim)
    empty = ReplayBuffer.create(cfg, device="cpu").sample(None, 4)
    assert empty.obs.shape == (4, cfg.obs_dim)


def test_update_reduces_critic_loss():
    cfg = _cfg()
    agent = _agent()
    g = torch.Generator().manual_seed(3)
    batch = Transition(obs=torch.randn((64, cfg.obs_dim), generator=g),
                       act=torch.randn((64, cfg.act_dim), generator=g),
                       rew=torch.randn((64,), generator=g),
                       next_obs=torch.randn((64, cfg.obs_dim), generator=g),
                       done=torch.zeros((64,)))
    losses = [float(agent.update(batch)["critic_loss"]) for _ in range(30)]
    assert losses[-1] < losses[0]


def test_env_step_shapes_and_rewards():
    env = _small_env(SubgoalEnv, batch=4, k_ticks=3, max_steps=5)
    st, obs = env.reset(torch.Generator().manual_seed(0))
    assert obs.shape == (4, env.obs_dim)
    assert env.obs_dim == 3 * (env.spec.n_obst + 1)
    st2, obs2, r, done = env.step(st, torch.tensor([6.0, 6.0]).expand(4, 2))
    assert obs2.shape == obs.shape and r.shape == (4,) and done.shape == (4,)
    # moving toward the goal earns progress reward (minus the 0.5 step cost)
    assert float(r.max()) > -0.5
    assert float((st2.loop.x0[:, :2] - st.loop.x0[:, :2]).abs().max()) > 0.05


def test_env_episode_terminates():
    env = _small_env(SubgoalEnv, batch=2, k_ticks=2, max_steps=3)
    st, obs = env.reset(torch.Generator().manual_seed(1))
    actions = torch.zeros((2, 2))
    for _ in range(3):
        st, obs, r, done = env.step(st, actions)
    assert bool(done.all())                     # max_steps reached
    # frozen rows: another step changes nothing and pays zero reward
    st2, _, r2, _ = env.step(st, actions)
    np.testing.assert_array_equal(r2.numpy(), 0.0)
    np.testing.assert_array_equal(st2.loop.x0.numpy(), st.loop.x0.numpy())


def test_defaults_run_on_the_card_and_raise_without_one():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is valid")
    with pytest.raises(RuntimeError, match="cuda"):
        SubgoalEnv(batch=2)
    with pytest.raises(RuntimeError, match="cuda"):
        DDPG(_cfg())
    with pytest.raises(RuntimeError, match="cuda"):
        ReplayBuffer.create(_cfg())


# ---------------------------------------------------------------------------
# the networks and one update against flax/optax
# ---------------------------------------------------------------------------

def _jax_agent(cfg, seed=0):
    """The JAX agent with the same configuration, and its initial state."""
    agent = JDDPG(JConfig(**dataclasses.asdict(cfg)))
    return agent, agent.init(jax.random.PRNGKey(seed))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _rel(a, b):
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b)) / max(np.linalg.norm(b), 1e-30))


def test_flax_weights_carried_match_flax_apply():
    cfg = _cfg()
    jagent, jst = _jax_agent(cfg)
    actor = interop.ddpg_params_from_numpy(_np(jst.actor), Actor(cfg))
    critic = interop.ddpg_params_from_numpy(_np(jst.critic), Critic(cfg))
    assert actor.mlp.layers[0].weight.dtype == torch.float32
    rng = np.random.default_rng(0)
    obs = rng.standard_normal((16, cfg.obs_dim)).astype(np.float32)
    act = rng.standard_normal((16, cfg.act_dim)).astype(np.float32)
    with torch.no_grad():
        a = actor(torch.tensor(obs)).numpy()
        q = critic(torch.tensor(obs), torch.tensor(act)).numpy()
    np.testing.assert_allclose(a, np.asarray(jagent.actor.apply(jst.actor, obs)), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(q, np.asarray(jagent.critic.apply(jst.critic, obs, act)),
                               rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="Dense layers"):
        interop.ddpg_params_from_numpy(_np(jst.actor), Actor(DDPGConfig(obs_dim=12, hidden=(8,))))


def _flax_tree(module):
    """The port's module weights as a flax parameter tree."""
    return {"params": {"_MLP_0": {
        f"Dense_{i}": {"kernel": jnp.asarray(layer.weight.detach().numpy().T),
                       "bias": jnp.asarray(layer.bias.detach().numpy())}
        for i, layer in enumerate(module.mlp.layers)}}}


def _grads_close(module, jgrads, rtol=1e-4):
    dense = jgrads["params"]["_MLP_0"]
    for i, layer in enumerate(module.mlp.layers):
        assert _rel(layer.weight.grad.numpy(), np.asarray(dense[f"Dense_{i}"]["kernel"]).T) < rtol
        assert _rel(layer.bias.grad.numpy(), np.asarray(dense[f"Dense_{i}"]["bias"])) < rtol


def test_update_matches_jax_losses_and_gradients():
    """One update from flax's initial weights: the critic loss and
    gradients against JAX's, the actor loss and gradients against JAX's
    evaluated with the port's updated critic (the actor step must see the
    updated critic), and the targets' polyak step."""
    cfg = _cfg()
    jagent, jst = _jax_agent(cfg, seed=4)
    agent = DDPG(cfg, device="cpu").init()
    for net, tgt, tree in ((agent.actor, agent.actor_t, jst.actor),
                           (agent.critic, agent.critic_t, jst.critic)):
        interop.ddpg_params_from_numpy(_np(tree), net)
        interop.ddpg_params_from_numpy(_np(tree), tgt)
    rng = np.random.default_rng(5)
    nb = 64
    bt = JTransition(obs=rng.standard_normal((nb, cfg.obs_dim)).astype(np.float32),
                     act=rng.uniform(-6, 6, (nb, cfg.act_dim)).astype(np.float32),
                     rew=rng.standard_normal(nb).astype(np.float32),
                     next_obs=rng.standard_normal((nb, cfg.obs_dim)).astype(np.float32),
                     done=(rng.uniform(size=nb) < 0.2).astype(np.float32))
    critic_before = [p.detach().clone() for p in agent.critic.parameters()]
    actor_t_before = [p.detach().clone() for p in agent.actor_t.parameters()]
    info = agent.update(Transition(*map(torch.tensor, bt)))

    def critic_loss(pc):
        q = jagent.critic.apply(pc, bt.obs, bt.act)
        q_next = jagent.critic.apply(jst.critic_t, bt.next_obs,
                                     jagent.actor.apply(jst.actor_t, bt.next_obs))
        target = bt.rew + cfg.gamma * (1.0 - bt.done) * q_next
        return jnp.mean((q - jax.lax.stop_gradient(target)) ** 2)

    lc, gc = jax.value_and_grad(critic_loss)(jst.critic)
    assert _rel(info["critic_loss"].numpy(), lc) < 1e-5
    _grads_close(agent.critic, gc)

    # Adam's first step is lr * g / (|g| + eps): where |g| is far from 0 the
    # port's updated critic equals optax's
    up, _ = jagent.opt_critic.update(gc, jagent.opt_critic.init(jst.critic), jst.critic)
    for i, layer in enumerate(agent.critic.mlp.layers):
        for name, before, new in (("kernel", critic_before[2 * i], layer.weight),
                                  ("bias", critic_before[2 * i + 1], layer.bias)):
            step = np.asarray(up["params"]["_MLP_0"][f"Dense_{i}"][name])
            g = np.asarray(gc["params"]["_MLP_0"][f"Dense_{i}"][name])
            if name == "kernel":
                step, g = step.T, g.T
            big = np.abs(g) > 1e-3
            np.testing.assert_allclose((new - before).detach().numpy()[big], step[big],
                                       rtol=1e-4, atol=1e-9)

    updated = _flax_tree(agent.critic)

    def actor_loss(pa):
        return -jnp.mean(jagent.critic.apply(updated, bt.obs, jagent.actor.apply(pa, bt.obs)))

    la, ga = jax.value_and_grad(actor_loss)(jst.actor)
    assert _rel(info["actor_loss"].numpy(), la) < 1e-5
    _grads_close(agent.actor, ga)

    for t, old, p in zip(agent.actor_t.parameters(), actor_t_before, agent.actor.parameters()):
        torch.testing.assert_close(t, (1 - cfg.tau) * old + cfg.tau * p, rtol=0, atol=1e-7)
        assert not t.requires_grad


# ---------------------------------------------------------------------------
# the environment against JAX, and training
# ---------------------------------------------------------------------------

def test_subgoal_env_step_matches_jax_f64():
    """From JAX's ``reset`` state (carried by ``env_state_from_numpy``), 3
    steps toward distinct per-row subgoals, then a step after every row is
    done; both envs' ``_tick`` is the noise-free parametric tick. Obs,
    reward, done and the plant state at 1e-8."""
    jenv = _small_env(JEnv, batch=4, k_ticks=3, max_steps=3)
    jenv._tick = j_ptick(jenv.ctrl, random_move=False)
    env = _small_env(SubgoalEnv, batch=4, k_ticks=3, max_steps=3)
    env._tick = make_parametric_tick(env.ctrl, random_move=False)
    jst, jobs = jenv.reset(jax.random.PRNGKey(0))
    st = interop.env_state_from_numpy(_np(jst), "cpu", torch.float64)
    assert st.t.dtype == torch.int32 and st.done.dtype == torch.bool
    np.testing.assert_allclose(env._obs(st).numpy(), np.asarray(jobs), rtol=0, atol=1e-12)
    jstep = jax.jit(jenv.step)
    rng = np.random.default_rng(2)
    for k in range(4):
        actions = rng.uniform(-6, 6, (4, 2))
        jst, jobs, jr, jdone = jstep(jst, jnp.asarray(actions))
        st, obs, r, done = env.step(st, torch.tensor(actions))
        for name, got, want in (("obs", obs, jobs), ("reward", r, jr),
                                ("x0", st.loop.x0, jst.loop.x0),
                                ("prev_dist", st.prev_dist, jst.prev_dist)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-8,
                                       err_msg=f"step {k}: {name}")
        np.testing.assert_array_equal(done.numpy(), np.asarray(jdone))
        np.testing.assert_array_equal(st.t.numpy(), np.asarray(jst.t))
    assert bool(done.all())
    np.testing.assert_array_equal(r.numpy(), 0.0)


def test_train_two_tiny_episodes():
    env = SubgoalEnv(spec=WorldSpec(tf=0.5, n_solv=5, n_obst=3, qp_iter=4),
                     opts=SolverOptions(qp_iter=4, integrator="rk4"), batch=3, k_ticks=2,
                     max_steps=3, device="cpu")
    cfg = DDPGConfig(obs_dim=env.obs_dim, act_dim=2, hidden=(16, 16), buffer_size=64,
                     batch_size=8)
    agent, history = train(env, DDPG(cfg, device="cpu"), 2, seed=1, warmup_steps=2,
                           verbose=False)
    assert [h["episode"] for h in history] == [0, 1]
    for h in history:
        assert np.isfinite(h["reward"]) and 0.0 <= h["reached"] <= 1.0
    assert all(bool(torch.isfinite(p).all()) for p in agent.actor.parameters())
    assert agent.opt_critic.state                       # updates ran after the warm-up


def test_train_module_runs_on_cpu():
    cmd = [sys.executable, "-m", "doa_mpc_tpu_torch.rl.train", "--device", "cpu",
           "--episodes", "1", "--batch", "2", "--timesteps", "2", "--k_ticks", "1",
           "--n_obst", "2", "--hidden_size", "8", "8"]
    res = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=REPO))
    assert res.returncode == 0, res.stderr
    assert "episode 0: mean_reward=" in res.stdout and "trained 1 episodes" in res.stdout
