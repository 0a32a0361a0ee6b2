"""The port's RL train-and-evaluate driver
(``doa_mpc_tpu_torch/rl/train_eval.py``) against ``scripts/rl_train_eval.py``.

- ``paired`` on outcome vectors rebuilt from ``results/rl_r5/eval.json``'s
  counts gives that file's ``paired_stats``, every field to 1e-12.
- ``evaluate`` against the JAX script's ``evaluate`` in float64: both envs
  tiny (B=4, N=5, M=3, 2 ticks per step, 3 steps), both ``_tick``s the
  noise-free parametric tick, the port's resets JAX's reset states
  (``interop.env_state_from_numpy``); the constant-goal policy and a
  policy carrying flax weights (``interop.ddpg_params_from_numpy``). The
  goal tolerance is 19.48 (from a distance of 19.8): within 3 steps some
  of the flax policy's rows reach and some do not, and the goal policy's
  all reach after 2. Outcome vectors equal, aggregates and episode rows at
  1e-8.
- Matched resets: two policies whose episodes end after 2 and after 4
  steps get the same reset worlds, bit for bit, and the same obstacle
  noise in the ticks both run, in every episode.
- ``python -m doa_mpc_tpu_torch.rl.train_eval --device cpu`` at a tiny size
  with ``--episodes 1`` and ``--episodes 0`` writes the three files with
  the keys of the committed ``results/rl_r5`` files; without ``--device``
  it asks for the card.
- The committed H100 replays (``results/rl_h100/``) hold their gates
  against the TPU's runs (``results/rl_r4``, ``results/rl_r5``).
"""

import importlib
import json
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
from doa_mpc_tpu.rl.env import SubgoalEnv as JEnv
from doa_mpc_tpu.sim.closed_loop import make_parametric_tick as j_ptick
from doa_mpc_tpu_torch import interop
from doa_mpc_tpu_torch.config import SolverOptions, WorldSpec
from doa_mpc_tpu_torch.rl import train_eval
from doa_mpc_tpu_torch.rl.ddpg import DDPG, DDPGConfig
from doa_mpc_tpu_torch.rl.env import SubgoalEnv
from doa_mpc_tpu_torch.sim.closed_loop import make_parametric_tick
from doa_mpc_tpu_torch.sim.obstacles import robot_start_goal

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RL_R5 = os.path.join(REPO, "results", "rl_r5")
GOAL = robot_start_goal(WorldSpec())[1]


def _spec(cls, tol):
    return cls(tf=0.5, n_solv=5, n_obst=3, qp_iter=6, tol=tol)


def _env(tol, **kw):
    env = SubgoalEnv(spec=_spec(WorldSpec, tol), opts=SolverOptions(qp_iter=6, integrator="rk4"),
                     dtype=torch.float64, device="cpu", **kw)
    env._tick = make_parametric_tick(env.ctrl, random_move=False)
    return env


# ---------------------------------------------------------------------------
# paired against the committed statistics
# ---------------------------------------------------------------------------

def _vectors(n, both, pol_only, base_only):
    """Outcome vectors of ``n`` rows with the given joint counts."""
    neither = n - both - pol_only - base_only
    pol = [True] * both + [True] * pol_only + [False] * base_only + [False] * neither
    base = [True] * both + [False] * pol_only + [True] * base_only + [False] * neither
    return np.array(pol), np.array(base)


@pytest.mark.parametrize("metric,better_when_true", [("reached", True), ("hit", False)])
def test_paired_reproduces_committed_stats(metric, better_when_true):
    with open(os.path.join(RL_R5, "eval.json")) as f:
        want = {p["metric"]: p for p in json.load(f)["paired_stats"]}[metric]
    n = want["n"]
    b, c = want["discordant_policy_only"], want["discordant_baseline_only"]
    pol_succ = round(want["policy_rate"] * n)
    assert round(want["baseline_rate"] * n) == pol_succ - b + c
    got = train_eval.paired(metric, *_vectors(n, pol_succ - b, b, c), better_when_true)
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, (bool, str)) or k in ("n", "discordant_policy_only",
                                                "discordant_baseline_only"):
            assert got[k] == v and type(got[k]) is type(v), k
        else:
            np.testing.assert_allclose(got[k], v, rtol=0, atol=1e-12, err_msg=k)


# ---------------------------------------------------------------------------
# evaluate against the JAX script's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("policy", ["goal", "flax"])
def test_evaluate_matches_jax_f64(policy, monkeypatch):
    monkeypatch.syspath_prepend(os.path.join(REPO, "scripts"))
    jscript = importlib.import_module("rl_train_eval")
    tol, episodes, batch = 19.48, 2, 4
    jenv = JEnv(spec=_spec(JSpec, tol), opts=JOptions(qp_iter=6, integrator="rk4"),
                dtype=jnp.float64, batch=batch, k_ticks=2, max_steps=3)
    jenv._tick = j_ptick(jenv.ctrl, random_move=False)
    env = _env(tol, batch=batch, k_ticks=2, max_steps=3)

    # the port's resets are the JAX script's, key for key
    key, carried = jax.random.PRNGKey(7), []
    for _ in range(episodes):
        key, kreset = jax.random.split(key)
        jst, _ = jax.jit(jenv.reset)(kreset)
        carried.append(interop.env_state_from_numpy(jax.tree.map(np.asarray, jst), "cpu",
                                                    torch.float64))
    states = iter(carried)

    def reset(generator, scenario=None):
        st = next(states)
        return st, env._obs(st)

    env.reset = reset

    if policy == "goal":
        jpol = lambda o: jnp.broadcast_to(jnp.asarray(GOAL), (batch, 2))
        pol = lambda o: torch.tensor(GOAL).expand(batch, 2)
    else:
        cfg = dict(obs_dim=env.obs_dim, act_dim=2, hidden=(16, 16), act_limit=7.2)
        jagent = JDDPG(JConfig(**cfg))
        jst = jagent.init(jax.random.PRNGKey(2))
        agent = DDPG(DDPGConfig(**cfg), device="cpu", dtype=torch.float64).init()
        interop.ddpg_params_from_numpy(jax.tree.map(np.asarray, jst.actor), agent.actor)
        jpol = lambda o: jagent.act(jst, o, noise=False)
        pol = lambda o: agent.act(o, noise=False)

    jagg, jrows, jvecs = jscript.evaluate(jenv, jpol, jax.random.PRNGKey(7), episodes=episodes)
    agg, rows, vecs = train_eval.evaluate(env, pol, 1000, episodes=episodes)
    for k in ("reached", "hit"):
        assert vecs[k].dtype == bool and vecs[k].shape == (episodes * batch,)
        np.testing.assert_array_equal(vecs[k], jvecs[k], err_msg=k)
    assert agg.keys() == jagg.keys()
    assert (agg["episodes"], agg["batch"]) == (jagg["episodes"], jagg["batch"])
    for got, want in zip([agg] + rows, [jagg] + jrows):
        assert got.keys() >= {"reached", "hit", "mean_final_dist", "mean_env_steps"}
        for k in ("reached", "hit", "mean_final_dist", "mean_env_steps"):
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-8, err_msg=k)
    if policy == "flax":
        assert 0 < vecs["reached"].sum() < len(vecs["reached"])


# ---------------------------------------------------------------------------
# matched resets
# ---------------------------------------------------------------------------

def test_arms_get_identical_resets_whatever_their_episode_lengths():
    """The goal policy's rows all reach within 2 steps (tolerance 19.3 from
    a distance of 19.8), a policy that holds the robot where it stands runs
    all 4; episode e of both arms starts from the same world and its common
    ticks draw the same obstacle noise."""
    env = _env(19.3, batch=4, k_ticks=2, max_steps=4)
    worlds, noises, steps = [], [], []
    reset, tick = env.reset, env._tick

    def recording_reset(generator, scenario=None):
        st, obs = reset(generator, scenario)
        worlds.append([t.clone() for t in (st.loop.x0, *st.loop.obst)])
        noises.append([])
        steps.append(env.steps_taken)
        return st, obs

    def recording_tick(loop, goal, params, noise=None):
        noises[-1].append(noise.clone())
        return tick(loop, goal, params, noise=noise)

    env.reset, env._tick = recording_reset, recording_tick
    episodes = 3
    goal = lambda o: torch.tensor(GOAL).expand(4, 2)
    stay = lambda o: o[:, :2] * env.spec.x_max      # the robot's own position
    train_eval.evaluate(env, goal, 5, episodes=episodes)
    train_eval.evaluate(env, stay, 5, episodes=episodes)
    steps.append(env.steps_taken)
    lengths = np.diff(steps)
    np.testing.assert_array_equal(lengths, [2] * episodes + [4] * episodes)
    for e in range(episodes):
        for a, b in zip(worlds[e], worlds[episodes + e]):
            assert torch.equal(a, b), f"episode {e}: the arms' reset worlds differ"
        assert len(noises[e]) == 2 * 2 and len(noises[episodes + e]) == 4 * 2
        for a, b in zip(noises[e], noises[episodes + e]):
            assert torch.equal(a, b), f"episode {e}: the arms' tick noise differs"
    assert not torch.equal(worlds[0][1], worlds[1][1])     # a new world per episode


# ---------------------------------------------------------------------------
# the module on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("episodes", [1, 0])
def test_module_writes_the_jax_files_on_cpu(episodes, tmp_path):
    out = str(tmp_path / "rl")
    cmd = [sys.executable, "-m", "doa_mpc_tpu_torch.rl.train_eval", "--device", "cpu",
           "--episodes", str(episodes), "--batch", "2", "--max-steps", "6", "--k-ticks", "1",
           "--n-obst", "2", "--qp-iter", "2", "--eval-episodes", "2", "--out", out]
    res = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=REPO))
    assert res.returncode == 0, res.stderr
    assert f"trained {episodes} episodes x 2 scenarios" in res.stdout
    assert "evaluated the baseline arm: 2 episodes in" in res.stdout
    trained = next(ln for ln in res.stdout.splitlines() if ln.startswith("trained"))
    assert ("ms/step" in trained) == (episodes > 0)
    got, want = train_eval.layout(out), train_eval.layout(RL_R5)
    with open(os.path.join(out, "history.json")) as f:
        hist = json.load(f)
    assert len(hist["episodes"]) == episodes
    if episodes == 0:
        assert got["history.json"]["episodes"] == []
        got["history.json"]["episodes"] = want["history.json"]["episodes"]
        with open(os.path.join(out, "summary.md")) as f:
            assert "first-5 episodes nan -> last-5 nan" in f.read()
    assert got == want
    with open(os.path.join(out, "eval.json")) as f:
        ev = json.load(f)
    assert ev["policy"]["episodes"] == 2 and ev["baseline_fixed_goal"]["batch"] == 2
    assert all(p["n"] == 4 for p in ev["paired_stats"])
    with open(os.path.join(out, "summary.md")) as f:
        assert "s on cpu)" in f.read()


# ---------------------------------------------------------------------------
# the committed H100 replays against the TPU's runs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ours,tpu,episodes", [("r4", "rl_r4", 24), ("r5_baseline", "rl_r5", 0)])
def test_committed_h100_replays_hold_their_gates(ours, tpu, episodes):
    """The fixed-goal baseline arm's reached and hit rates within 2 standard
    errors of a difference of two proportions of the TPU run's,
    2 sqrt(p (1 - p) 2 / n) with p the pooled rate (the resets cannot be
    matched seed for seed); rl_r4's learning curve rises; the files carry
    results/rl_r5's keys."""
    out = os.path.join(REPO, "results", "rl_h100", ours)
    with open(os.path.join(out, "eval.json")) as f:
        ev = json.load(f)
    with open(os.path.join(REPO, "results", tpu, "eval.json")) as f:
        ref = json.load(f)
    with open(os.path.join(out, "history.json")) as f:
        hist = json.load(f)
    base, tpu_base = ev["baseline_fixed_goal"], ref["baseline_fixed_goal"]
    assert (base["episodes"], base["batch"]) == (tpu_base["episodes"], tpu_base["batch"])
    assert len(hist["episodes"]) == episodes
    if tpu == "rl_r5":
        assert (ev["scenario"], ev["n_obst"]) == (ref["scenario"], ref["n_obst"])
    n = base["episodes"] * base["batch"]
    for k in ("reached", "hit"):
        p = (base[k] + tpu_base[k]) / 2
        assert abs(base[k] - tpu_base[k]) <= 2 * np.sqrt(p * (1 - p) * 2 / n), k
    if episodes:
        rewards = [h["reward"] for h in hist["episodes"]]
        assert np.mean(rewards[-5:]) > np.mean(rewards[:5])
    got, want = train_eval.layout(out), train_eval.layout(RL_R5)
    if not episodes:
        got["history.json"]["episodes"] = want["history.json"]["episodes"]
    assert got == want


def test_main_asks_for_the_card_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is valid")
    with pytest.raises(RuntimeError, match="cuda"):
        train_eval.main(["--episodes", "0", "--out", str(tmp_path)])
    assert not os.listdir(tmp_path)
