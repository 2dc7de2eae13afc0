"""Single-robot node traffic: `io.pubsub.ControlLoop.tick` over `io.Model`,
ticks back to back.

Set-up builds the node at the configuration's settings, draws from the
seed a plan (a chain of waypoints inside the state box) and a walk of
humans, publishes the plan, and warms the tick's one shape (its first tick
captures the CUDA graph, the next ones replay it).  Each timed tick gets a
fresh odometry pose, where the last command takes the robot in one timer
period, and every ``obstacle_every`` ticks the walk's humans where they
are then (the humans cross ahead of the robot, in its own frame, so they
stay in its path for the whole window, and clear of its goal); the tick
ends when the command is out.  Every tick's inputs and outputs are kept on the host; after the
window a sample of ticks drawn from the seed is solved again by the plain
reference from the same inputs.

Cell parameters (`params`): ``humans``, ``obstacle_every``,
``goal_clearance`` (m from the goal or the next waypoint to the nearest
line a human crosses on, beyond the goal), ``waypoints``,
``max_turn_deg`` (the plan's sharpest turn), ``sample`` (ticks compared).
Check parameters (`check`): ``tolerance`` on a converged plan's controls,
``command_tolerance`` on a first command, ``limits`` of the compared
numbers.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from .. import compare
from ..harness import percentile, run_window
from ..reference import config as ref_config
from ..reference import node as ref_node
from ..reference import obstacles as ref_obstacles
from .common import DTYPES, UNUSABLE_FEASIBILITY, mpc_config

HUMAN_RADIUS = 0.3
BOX_MARGIN = 8.0  # a plan turns home past half of +-(state bound - this)


def plan(seed: int, n: int, bound: float, max_turn: float) -> np.ndarray:
    """[n, 3] waypoints from the origin, 2-3.5 m apart, each hop turning
    by at most ``max_turn`` radians: at random, or, once past half of
    +-(bound - BOX_MARGIN) from the origin, toward the origin as far as
    that allows (which keeps the chain within about +-(bound - 7)).  Every
    hop draws the same numbers, so the seed alone fixes the chain."""
    rng = np.random.default_rng([seed, 2])
    soft = 0.5 * (bound - BOX_MARGIN)
    pts, p, heading = [], np.zeros(2), 0.0
    for _ in range(n):
        turn, hop = rng.uniform(-max_turn, max_turn), rng.uniform(2.0, 3.5)
        if np.hypot(*p) > soft:
            home = np.angle(np.exp(1j * (np.arctan2(-p[1], -p[0]) - heading)))
            turn = float(np.clip(home, -max_turn, max_turn))
        heading += turn
        p = p + hop * np.array([np.cos(heading), np.sin(heading)])
        pts.append([p[0], p[1], heading])
    return np.array(pts)


class Walk:
    """Humans crossing ahead of the robot: human k keeps ``ahead[k]`` m in
    front of the robot and sways across its path around ``lateral[k]`` with
    amplitude ``amp[k]`` at its own walking speed.  No human crosses between
    the robot and its goal, nor within ``clearance`` m of the goal or of the
    waypoint after it: a human who stands on the goal or between, and whom
    the robot's frame carries along, keeps the 40-iteration split IPM short
    of feasibility (PERF.md §7)."""

    def __init__(self, seed: int, n: int, clearance: float):
        rng = np.random.default_rng([seed, 3])
        self.ahead = rng.uniform(1.5, 4.0, n)
        self.lateral = rng.uniform(-0.5, 0.5, n)
        self.amp = rng.uniform(1.0, 2.5, n)
        self.rate = rng.uniform(0.4, 1.0, n) / self.amp
        self.phase = rng.uniform(-np.pi, np.pi, n)
        self.clearance = clearance

    def at(self, t: float, pose, goals) -> tuple:
        """(position [n, 2], radius, orientation, linear velocity,
        angular velocity, active), float32 numpy, at time ``t`` s, for the
        goal ``goals[0]`` and the waypoints after it ``goals[1:]``."""
        c, s = np.cos(pose[2]), np.sin(pose[2])
        # A line of crossing lies across the robot's heading, so a point's
        # distance to it is their gap along the heading.
        along = [c * (w[0] - pose[0]) + s * (w[1] - pose[1]) for w in goals]
        ahead = np.maximum(self.ahead, along[0] + self.clearance)
        for g in along[1:]:
            ahead = np.where(np.abs(ahead - g) < self.clearance, g + self.clearance, ahead)
        lat = self.lateral + self.amp * np.sin(self.rate * t + self.phase)
        vlat = self.amp * self.rate * np.cos(self.rate * t + self.phase)
        pos = np.stack([pose[0] + c * ahead - s * lat, pose[1] + s * ahead + c * lat], 1)
        heading = pose[2] + np.where(vlat >= 0, np.pi / 2, -np.pi / 2)
        n = len(self.ahead)
        f = lambda x: np.asarray(x, np.float32)  # noqa: E731
        return (f(pos), f(np.full(n, HUMAN_RADIUS)), f(heading), f(np.abs(vlat)),
                f(np.zeros(n)), f(np.ones(n)))


class Driver:
    def __init__(self, ctx):
        from kissmpc_tpu_torch import config as port_config
        from kissmpc_tpu_torch.io import ControlLoop, LatestValue, Model

        self.ctx = ctx
        c, p = ctx.config, ctx.cell["params"]
        self.dtype = DTYPES[c["dtype"]]
        self.period = 1.0 / float(c["timer_hz"])
        self.every = int(p["obstacle_every"])
        self.model = Model(
            horizon=c["horizon"], planning_time_step=c["time_step"],
            linear_velocity_bounds=tuple(c["control_bounds"][0]),
            angular_velocity_bounds=tuple(c["control_bounds"][1]),
            state_bounds=tuple(c["state_bounds"]), radius=float(c["radius"]),
            sensor_radius=float(c["sensor_radius"]), max_obstacles=c["max_obstacles"],
            use_warm_start=bool(c["use_warm_start"]), dtype=self.dtype, device=ctx.device)
        # io.Model solves by the split IPM (`ipm.solve`) whatever its config's backend.
        runs = dataclasses.replace(self.model.cfg.solver, solve_backend="split")
        if runs != mpc_config(port_config, c).solver:
            raise ValueError(f"io.Model solves with {runs}, the configuration states "
                             f"{mpc_config(port_config, c).solver}")
        self.odom, plan_slot, self.obs = LatestValue(), LatestValue(), LatestValue()
        self.commands = []
        self.loop = ControlLoop(self.model, odometry=self.odom, plan=plan_slot,
                                obstacles=self.obs,
                                on_command=lambda v, w: self.commands.append((v, w)))
        self.plan = plan(ctx.seed, int(p["waypoints"]), float(c["state_bounds"][1]),
                         np.radians(float(p["max_turn_deg"])))
        plan_slot.publish(self.plan)
        self.walk = Walk(ctx.seed, int(p["humans"]), float(p["goal_clearance"]))
        self.pose = np.zeros(3)
        # Per tick: pose, goal, obstacle set, plan and its feasibility, goal after.
        self.rec = {k: [] for k in ("pose", "goal", "obs", "states", "controls", "feas",
                                    "conv", "goal_after", "produced")}
        self.sets = []
        for i in range(3):  # the capture, then replays
            self._tick(i, warm=True)
        self.ticks = 0
        self.trace_calls = 200

    def _tick(self, i: int, warm: bool = False) -> float:
        t_sim = i * self.period
        if i % self.every == 0:
            self.sets.append(self.walk.at(t_sim, self.pose, self._goals()))
            self.obs.publish(_obstacle_set(self.sets[-1]))
        self.odom.publish(self.pose.copy())
        before = len(self.commands)
        goal = np.array(self.model.goal_state)
        t0 = time.perf_counter()
        produced = self.loop.tick()
        seconds = time.perf_counter() - t0
        produced = produced and len(self.commands) > before
        v, w = self.commands[-1] if produced else (0.0, 0.0)
        if not warm:
            r = self.rec
            r["pose"].append(self.pose.copy())
            r["goal"].append(goal)
            r["obs"].append(len(self.sets) - 1)
            r["states"].append(self.model._states)
            r["controls"].append(self.model._controls)
            r["feas"].append(float(self.model.last_diagnostics.kkt_feasibility))
            r["conv"].append(bool(self.model.last_diagnostics.converged))
            r["goal_after"].append(np.array(self.model.goal_state))
            r["produced"].append(produced)
        self.pose = self.pose + self.period * np.array(
            [v * np.cos(self.pose[2]), v * np.sin(self.pose[2]), w])
        return seconds

    def _goals(self) -> list:
        """The node's goal and the waypoint after it, if any."""
        goal = np.array(self.model.goal_state)
        nxt = _next_waypoint(self.plan, goal)
        return [goal] if nxt is None else [goal, nxt]

    def step(self, i: int) -> float:
        if i == 0:  # the window starts from a fresh robot at the origin
            self.pose, self.sets = np.zeros(3), []
        self.ticks += 1
        return self._tick(i)

    def result(self, window) -> tuple[int, int, dict]:
        r = self.rec
        failed = sum(1 for ok, f in zip(r["produced"], r["feas"])
                     if not ok or not f <= UNUSABLE_FEASIBILITY)
        return self.ticks, failed, {"node_tick_ms_p99": percentile(window.times, 99) * 1e3}

    def check(self) -> list:
        """A sample of ticks drawn from the seed, solved again by the
        reference from the inputs each tick was given."""
        t0 = time.perf_counter()
        out = node_numbers(self.ctx, self.rec, self.sets, self.plan, self.sample())
        self.ctx.log(f"reference: {len(self.sample())} of {self.ticks} ticks, "
                     f"{time.perf_counter() - t0:.3f} s")
        return out

    def sample(self) -> np.ndarray:
        """The compared ticks, drawn from the seed."""
        n = len(self.rec["pose"])
        rng = np.random.default_rng([self.ctx.seed, 4])
        return np.sort(rng.choice(n, size=min(n, int(self.ctx.cell["params"]["sample"])),
                                  replace=False))


def _obstacle_set(arrays):
    from kissmpc_tpu_torch.obstacles import ObstacleSet

    return ObstacleSet(*(torch.as_tensor(x) for x in arrays))


def node_numbers(ctx, rec, sets, plan_, sample, program=None) -> list:
    """The compared numbers of the sampled ticks: the plans' controls
    against the reference's from the same inputs on every tick the
    reference converged on, whatever flag the program reports (a
    40-iteration f32 solve near its tolerance flips its flag on rounding,
    so the flags themselves are not compared), the first command against
    the reference's on every tick whose reference plan is usable (coarser,
    for the ticks the reference does not converge on), the waypoint
    advance against the one the program's own plan calls for (exact), and
    the claim gap of the program's plans (or ``program``'s, the control's
    (states, controls, feasibility, converged) of the same ticks)."""
    c, chk = ctx.config, ctx.cell["check"]
    cfg = mpc_config(ref_config, c)
    poses = np.stack([rec["pose"][i] for i in sample])
    goals = np.stack([rec["goal"][i] for i in sample])
    obs = ref_obstacles.ObstacleSet(*(np.stack([sets[rec["obs"][i]][f] for i in sample])
                                      for f in range(6)))
    problems, ref = ref_node.ticks(cfg, c, poses, goals, obs, DTYPES[c["dtype"]])
    if program is None:
        states = np.stack([rec["states"][i] for i in sample])
        controls = np.stack([rec["controls"][i] for i in sample])
        feas = np.array([rec["feas"][i] for i in sample])
        conv = np.array([rec["conv"][i] for i in sample])
        advance = np.array([not np.allclose(rec["goal_after"][i], _after(plan_, rec, i, c))
                            for i in sample])
    else:
        states, controls, feas, conv = program
        advance = np.zeros(len(sample), bool)
    share = compare.missed_share(ref.diagnostics.converged, torch.as_tensor(controls),
                                 ref.controls, float(chk["tolerance"]))
    usable = ref.diagnostics.kkt_feasibility.double() <= UNUSABLE_FEASIBILITY
    off = compare.off_share(usable, torch.as_tensor(controls), ref.controls,
                            float(chk["command_tolerance"]))
    _log_misses(ctx, ref, conv, controls, float(chk["tolerance"]), len(sample))
    first = np.abs(np.asarray(controls, np.float64)[:, 0] - ref.controls[:, 0].double().numpy())
    ctx.log(f"node: usable reference plans on {int(usable.sum())} of {len(sample)} ticks; largest "
            f"first-command gap there {float(first.max(axis=1)[usable.numpy()].max(initial=0.0))}")
    gap = compare.claim_gap(cfg, problems, torch.as_tensor(feas), torch.as_tensor(states),
                            torch.as_tensor(controls))
    limits = chk["limits"]
    return [("missed_share", share, float(limits["missed_share"])),
            ("command_off_share", off, float(limits["command_off_share"])),
            ("advance_mismatches", float(advance.sum()), float(limits["advance_mismatches"])),
            ("claim_gap", gap, float(limits["claim_gap"]))]


def _log_misses(ctx, ref, conv, controls, tol, n):
    """How the compared ticks fell: how many the reference converged on,
    how many of those the program reports converged, and the gaps of the
    ones it missed (each the largest |control - reference's|)."""
    ref_conv = ref.diagnostics.converged.numpy()
    conv = np.asarray(conv, bool)
    gap = np.abs(np.asarray(controls, np.float64) - ref.controls.double().numpy())
    gap = gap.reshape(len(gap), -1).max(axis=1)
    missed = ref_conv & ~(gap <= tol)
    g = np.sort(gap[missed])
    ctx.log(f"node: the reference converged on {int(ref_conv.sum())} of {n} ticks, the program "
            f"on {int((ref_conv & conv).sum())} of them; {int(missed.sum())} missed "
            f"({int((missed & conv).sum())} that the program calls converged), gaps "
            f"{[float(x) for x in g[[0, len(g) // 2, -1]]] if len(g) else []}")


def _after(plan_, rec, i, config):
    """The goal after tick ``i`` as the node's rule gives it from the
    program's own plan: the next waypoint once the plan's next state is at
    the goal, the goal itself otherwise."""
    goal = rec["goal"][i]
    if ref_node.at_goal(rec["states"][i][1], goal, float(config["radius"])):
        nxt = _next_waypoint(plan_, goal)
        if nxt is not None:
            return nxt
    return goal


def _next_waypoint(plan_, goal):
    """The waypoint after ``goal`` in the plan, or None at the last one."""
    idx = [j for j, w in enumerate(plan_) if np.allclose(w, goal)]
    if not idx or idx[0] + 1 >= len(plan_):
        return None
    return plan_[idx[0] + 1]


def control(ctx, lower: str, seconds: float = 3.0) -> list:
    """The compared numbers of the reference in ``lower`` precision put in
    the program's place, on the ticks a short run of the program gives."""
    driver = Driver(ctx)
    run_window(driver.step, seconds)
    rec, sample = driver.rec, driver.sample()
    c = ctx.config
    cfg = mpc_config(ref_config, c)
    obs = ref_obstacles.ObstacleSet(*(np.stack([driver.sets[rec["obs"][i]][f] for i in sample])
                                      for f in range(6)))
    _, low = ref_node.ticks(cfg, c, np.stack([rec["pose"][i] for i in sample]),
                            np.stack([rec["goal"][i] for i in sample]), obs, DTYPES[lower])
    program = (low.states.double().numpy(), low.controls.double().numpy(),
               low.diagnostics.kkt_feasibility.double().numpy(),
               low.diagnostics.converged.numpy())
    return node_numbers(ctx, rec, driver.sets, driver.plan, sample, program=program)


def setup(ctx) -> Driver:
    return Driver(ctx)
