"""Host-side visualization of closed-loop runs (the port's own copy of
``doa_mpc_tpu/utils/viz.py``).

``VisDynamicRobotEnv``: animated robot circle, executed trajectory,
predicted-horizon line, obstacle circles, start/goal tolerance rings; show
interactively or save a GIF. It takes numpy arrays (the stacks of
``sim/closed_loop.make_rollout(collect=True)``, moved to the host) and
imports matplotlib only when it is constructed.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


class VisDynamicRobotEnv:
    """Animate a collected rollout.

    Args:
        spec: WorldSpec (grid bounds, radii, tolerance).
        robot_traj: (T, >=2) robot states over time.
        obst_traj: (T, M, 2) obstacle centers over time.
        pred_traj: optional (T, N+1, 2) predicted horizon per tick.
        start, goal: (2,) markers for the tolerance rings.
    """

    def __init__(self, spec, robot_traj, obst_traj, pred_traj=None,
                 start=None, goal=None, interactive: bool = False):
        import matplotlib
        if not interactive:
            # headless default; interactive=True keeps the user's GUI
            # backend so run_animation() can plt.show()
            matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        self._plt = plt
        self.spec = spec
        self.robot = np.asarray(robot_traj)
        self.obst = np.asarray(obst_traj)
        self.pred = None if pred_traj is None else np.asarray(pred_traj)
        self.T = self.robot.shape[0]

        self.fig = plt.figure()
        self.ax = plt.axes(xlim=(spec.x_min, spec.x_max),
                           ylim=(spec.y_min, spec.y_max))
        self.ax.set_aspect("equal")
        self._obst_patches = [
            plt.Circle(tuple(self.obst[0, i]), spec.r_obst, fc="r")
            for i in range(self.obst.shape[1])
        ]
        for p in self._obst_patches:
            self.ax.add_patch(p)
        self._robot_patch = plt.Circle(tuple(self.robot[0, :2]),
                                       spec.r_robot, fc="y")
        self.ax.add_patch(self._robot_patch)
        if start is not None:
            self.ax.add_patch(plt.Circle(tuple(np.asarray(start)[:2]),
                                         spec.tol, fill=False,
                                         edgecolor="orange"))
        if goal is not None:
            self.ax.add_patch(plt.Circle(tuple(np.asarray(goal)[:2]),
                                         spec.tol, fill=False, edgecolor="g"))
        (self._traj_line,) = self.ax.plot(self.robot[:, 0], self.robot[:, 1])
        (self._pred_line,) = self.ax.plot([], [], c="y")

    def _animate(self, t):
        self._robot_patch.center = tuple(self.robot[t, :2])
        for i, p in enumerate(self._obst_patches):
            p.center = tuple(self.obst[t, i])
        if self.pred is not None:
            self._pred_line.set_data(self.pred[t, :, 0], self.pred[t, :, 1])
        return [self._robot_patch] + self._obst_patches + [self._pred_line]

    def save_animation(self, filename: str, fps: int = 10,
                       every: int = 1, max_frames: Optional[int] = None):
        """Write a GIF."""
        from matplotlib import animation
        frames = range(0, self.T, every)
        if max_frames:
            frames = list(frames)[:max_frames]
        anim = animation.FuncAnimation(self.fig, self._animate,
                                       frames=frames, interval=50)
        anim.save(filename, writer=animation.PillowWriter(fps=fps))
        self._plt.close(self.fig)

    def save_frame(self, filename: str, t: int = -1):
        """Render a single frame (static inspection / CI artifacts)."""
        self._animate(t % self.T)
        self.fig.savefig(filename)
        self._plt.close(self.fig)

    def run_animation(self, interval: int = 50):
        """Interactive display.

        Requires ``interactive=True`` at construction (and a GUI matplotlib
        backend); on headless setups use :meth:`save_animation`.
        """
        from matplotlib import animation
        anim = animation.FuncAnimation(self.fig, self._animate,
                                       frames=self.T, interval=interval)
        self._plt.show()
        return anim
