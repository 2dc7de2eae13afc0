"""`Model`: the merged agent+waypoints host surface the reference's ROS node
expects.  A port of `kissmpc_tpu/io/model.py`.

`ros2interface.py:19` imports `from mpc.model import Model`, a module that
does not exist in the reference repo (SURVEY.md section 2.4 item 9).  Its
required surface is evident from use: constructed with agent kwargs plus
``waypoints`` (`ros2interface.py:28-38`), `.step()` per control tick (`:55`),
`.linear_velocity`/`.angular_velocity` read into the Twist (`:58-61`),
`.states_matrix` for the future-state markers (`:65`), `.initial_state`
assigned from odometry plus `.reset(matrices_only=True)` (`:93-107`), and
`.waypoints` / `.waypoint_index` / `.current_waypoint()` / `.update_goal`
for plan ingestion (`:171-174`).

This class provides exactly that surface as a thin mutable adapter over the
functional core: each tick builds the robot's Problem as a batch of one and
solves it by the split IPM (on the card three kernel launches per
iteration: condensation, Riccati, step), with odometry and plan updates
folded in between ticks (single-threaded by construction: the reference's odom-callback/timer race,
SURVEY.md 5.2, cannot occur because the host loop owns all mutation).  On
the card the problem build and the solve are one CUDA graph, captured at
the first tick and replayed after it (`solver/graph.py`), as the reference
jits both (`kissmpc_tpu/io/model.py:97`): the tick's numpy inputs are
copied into the graph's static inputs, and the plan, the commands and the
diagnostics come back to the host as numpy, one read per leaf: they are the
node's output.

Array-layout note: the reference keeps states/controls column-major
([3, N+1] / [2, N], `mpc/optimizer.py:62-68`); this surface preserves that
convention for drop-in compatibility while the core is time-major.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .._device import resolve_device
from ..agent import AgentParams
from ..config import MPCConfig
from ..obstacles import ObstacleSet, empty
from ..solver import graph, ipm
from ..solver.problem import problem_with_obstacles
from ..utils.profiling import annotate


class Model:
    """Host-side receding-horizon planner with the reference node's surface."""

    def __init__(
        self,
        id=1,
        initial_position=(0.0, 0.0),
        initial_orientation: float = 0.0,
        horizon: int = 7,
        planning_time_step: float = 0.8,
        linear_velocity_bounds=(-0.3, 0.3),
        angular_velocity_bounds=(-0.3, 0.3),
        state_bounds=(-20.0, 20.0),
        radius: float = 0.3,
        sensor_radius: float = 5.0,
        max_obstacles: int = 0,
        use_warm_start: bool = True,
        waypoints=None,
        dtype=torch.float32,
        device=None,
    ):
        self.id = id
        self.cfg = MPCConfig(
            horizon=horizon,
            time_step=planning_time_step,
            max_obstacles=max_obstacles,
        )
        self.params = AgentParams(
            radius=radius,
            sensor_radius=sensor_radius,
            control_bounds=(
                tuple(linear_velocity_bounds),
                tuple(angular_velocity_bounds),
            ),
            state_bounds=tuple(state_bounds),
        )
        self.dtype = dtype
        self.device = resolve_device(device)
        self.use_warm_start = use_warm_start
        self.initial_state = np.array(
            [*initial_position, initial_orientation], dtype=np.float64
        )
        self.waypoints = (
            np.asarray(waypoints, dtype=np.float64).reshape(-1, 3)
            if waypoints is not None and len(waypoints)
            else np.zeros((0, 3))
        )
        self.waypoint_index = 0
        self.goal_state = (
            self.waypoints[0] if len(self.waypoints) else self.initial_state.copy()
        )
        self._states = np.tile(self.initial_state, (horizon + 1, 1))
        self._controls = np.zeros((horizon, 2))
        self.linear_velocity = 0.0
        self.angular_velocity = 0.0
        self._obstacles: Optional[ObstacleSet] = None
        self.set_obstacles(None)

    # -- reference `Agent` surface -----------------------------------------

    @property
    def states_matrix(self) -> np.ndarray:
        """Column-major [3, N+1], the reference's layout (markers iterate
        `.T`, `ros2interface.py:66`)."""
        return self._states.T

    @property
    def controls_matrix(self) -> np.ndarray:
        return self._controls.T

    @property
    def state(self) -> np.ndarray:
        """Second column of the plan (`mpc/agent.py:70-72`)."""
        return self._states[1]

    @property
    def at_goal(self) -> bool:
        d = (
            np.linalg.norm(self.state[:2] - self.goal_state[:2])
            - self.params.radius
        )
        return bool(d - self.params.goal_radius <= 0.0)

    def current_waypoint(self):
        """Callable, as used at `ros2interface.py:174`."""
        if self.waypoint_index < len(self.waypoints):
            return self.waypoints[self.waypoint_index]
        return None

    def update_goal(self, goal) -> None:
        self.goal_state = (
            np.asarray(goal, dtype=np.float64)
            if goal is not None
            else self.initial_state.copy()
        )

    def reset(self, matrices_only: bool = False, to_initial_state: bool = True):
        base = self.initial_state if to_initial_state else self.state
        self._states = np.tile(base, (self.cfg.horizon + 1, 1))
        self._controls = np.zeros((self.cfg.horizon, 2))
        if not matrices_only:
            self.linear_velocity = 0.0
            self.angular_velocity = 0.0

    def set_obstacles(self, obstacles: Optional[ObstacleSet]) -> None:
        """Install the current obstacle population (e.g. from perception):
        an `ObstacleSet` with [K] leaves, copied into the model's buffer on
        its device (a new buffer when K changes); None clears it to
        ``max_obstacles`` empty slots."""
        if obstacles is None:
            obstacles = empty(self.cfg.max_obstacles, self.dtype, "cpu")
        new = [torch.as_tensor(x) for x in obstacles]
        held = self._obstacles
        if held is None or any(h.shape != x.shape for h, x in zip(held, new)):
            self._obstacles = ObstacleSet(
                *(x.to(self.device, self.dtype, copy=True) for x in new))
        else:
            for h, x in zip(held, new):
                h.copy_(x)

    def step(self, state_override: bool = False) -> None:
        """One control tick (`ROS2Interface.run` path, `ros2interface.py:51-61`).

        Advances the waypoint when the current one is reached (the
        environment-loop behavior of `mpc/environment.py:77-80`, which the
        reference's merged Model evidently folded in).  The tick's Problem
        (a batch of one, on the model's device) stays in ``last_problem``
        and its diagnostics, as numpy, in ``last_diagnostics``.  Spans
        (`utils/profiling.py::annotate`): ``model.step`` around it;
        ``model.inputs``, `graph.run`'s, ``model.read`` and
        ``model.advance`` inside.
        """
        with annotate("model.step"):
            if not self.use_warm_start:
                self.reset(matrices_only=True, to_initial_state=False)
            start = self.initial_state if state_override else self.state
            with annotate("model.inputs"):
                inputs = [torch.as_tensor(x, dtype=self.dtype)[None]
                          for x in (start, self.goal_state, self._states, self._controls)]
            problem, sol = graph.run(("io.Model", self.cfg, self.params, self.dtype),
                                     self._program, self.device, *inputs, *self._obstacles)
            self.last_problem = problem
            with annotate("model.read"):
                self._states = sol.states[0].cpu().numpy().astype(np.float64)
                self._controls = sol.controls[0].cpu().numpy().astype(np.float64)
                self.linear_velocity = float(self._controls[0, 0])
                self.angular_velocity = float(self._controls[0, 1])
                self.last_diagnostics = type(sol.diagnostics)(
                    *(x[0].cpu().numpy() for x in sol.diagnostics))
            with annotate("model.advance"):
                if self.at_goal and self.waypoint_index < len(self.waypoints) - 1:
                    self.waypoint_index += 1
                    self.update_goal(self.current_waypoint())

    def _program(self, start, goal, warm_states, warm_controls, *obstacles):
        """The tick on the device: the robot's Problem (a batch of one) and
        its split solve, the reference's jitted `_solve`."""
        params = self.params
        problem = problem_with_obstacles(
            self.cfg,
            start,
            goal,
            ObstacleSet(*(x[None] for x in obstacles)),
            sensor_radius=params.sensor_radius,
            control_bounds=params.control_bounds,
            state_bounds=params.state_bounds,
            inflation_radius=params.inflation_radius,
            warm_states=warm_states,
            warm_controls=warm_controls,
            dtype=self.dtype,
            device=start.device,
        )
        return problem, ipm.solve(self.cfg, problem)
