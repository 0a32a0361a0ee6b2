"""RL subgoal layer: DDPG agent, batched MPC subgoal env, training loop."""
