"""Minimal host-side pub-sub + control loop (the ROS-free I/O plane).  A
port-owned copy of `kissmpc_tpu/io/pubsub.py`.

The reference's runtime plumbing is ROS 2: topic subscriptions feeding
callbacks that mutate the model object, and a 100 Hz timer driving `run()`
(`ros2interface.py:45-61`).  That design races the odometry callback against
the control timer on shared state (SURVEY.md section 5.2).  Here the I/O
plane is explicit: single-writer `LatestValue` snapshot slots (odometry,
plan, obstacle tracks) that producers overwrite and the control loop reads
at tick boundaries: the compute plane (the solver) never sees partially
updated state.

This is deliberately transport-agnostic: a ROS 2 adapter, a socket bridge or
a test harness can all produce into the same slots.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Generic, Optional, TypeVar

from ..utils.profiling import annotate

T = TypeVar("T")


class LatestValue(Generic[T]):
    """Single-slot, last-value-wins snapshot store (thread-safe).

    Equivalent to a depth-1 ROS subscription where only the newest message
    matters (odometry, plans) — but read at well-defined points.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._value: Optional[T] = None
        self._version = 0

    def publish(self, value: T) -> None:
        with self._lock:
            self._value = value
            self._version += 1

    def read(self):
        """-> (value | None, version).  Version lets consumers detect fresh
        data without comparing payloads."""
        with self._lock:
            return self._value, self._version


class RateTimer:
    """Fixed-rate tick helper (the 100 Hz `create_timer` analogue,
    `ros2interface.py:50`), drift-free."""

    def __init__(self, period_s: float):
        self.period = period_s
        self._next = time.perf_counter() + period_s

    def sleep(self) -> int:
        """Sleep until the next tick; returns the number of missed periods
        (0 when on schedule)."""
        now = time.perf_counter()
        missed = 0
        if now > self._next:
            missed = int((now - self._next) / self.period)
            self._next += missed * self.period
        delay = self._next - now
        if delay > 0:
            time.sleep(delay)
        self._next += self.period
        return missed


class ControlLoop:
    """Single-threaded control loop binding snapshot slots to a `Model`.

    Per tick (mirroring `ROS2Interface.run`, `ros2interface.py:51-61`):
    fold in the newest odometry (-> `initial_state` + matrices reset,
    `ros2interface.py:91-107`), newest plan (-> waypoints, `:109-174`),
    newest obstacle set; skip while no waypoints (`:52`); `model.step()`;
    emit the command via the callback.
    """

    def __init__(
        self,
        model,
        *,
        odometry: LatestValue,
        plan: LatestValue,
        obstacles: Optional[LatestValue] = None,
        on_command: Optional[Callable] = None,
        on_future_states: Optional[Callable] = None,
    ):
        self.model = model
        self.odometry = odometry
        self.plan = plan
        self.obstacles = obstacles
        self.on_command = on_command
        self.on_future_states = on_future_states
        self._odom_seen = 0
        self._plan_seen = 0
        self._obs_seen = 0

    def tick(self) -> bool:
        """One control tick; returns True if a command was produced.  Its
        spans (`utils/profiling.py::annotate`): ``node.tick`` around it,
        ``node.fold`` and ``node.emit`` inside, beside the model's."""
        with annotate("node.tick"):
            with annotate("node.fold"):
                self._fold()
            if len(self.model.waypoints) == 0:
                return False
            self.model.step(state_override=self._odom_seen > 0)
            with annotate("node.emit"):
                if self.on_command is not None:
                    self.on_command(self.model.linear_velocity, self.model.angular_velocity)
                if self.on_future_states is not None:
                    self.on_future_states(self.model.states_matrix)
            return True

    def _fold(self) -> None:
        """Fold the newest odometry, plan and obstacle set into the model."""
        odom, v = self.odometry.read()
        if odom is not None and v != self._odom_seen:
            self._odom_seen = v
            self.model.initial_state = odom
            self.model.reset(matrices_only=True)

        plan, v = self.plan.read()
        if plan is not None and v != self._plan_seen:
            self._plan_seen = v
            self.model.waypoints = plan
            self.model.waypoint_index = 0
            self.model.update_goal(self.model.current_waypoint())

        if self.obstacles is not None:
            obs, v = self.obstacles.read()
            if obs is not None and v != self._obs_seen:
                self._obs_seen = v
                self.model.set_obstacles(obs)

    def run(self, rate_hz: float = 100.0, stop: Optional[Callable] = None):
        """Run until ``stop()`` returns True (or forever)."""
        timer = RateTimer(1.0 / rate_hz)
        while stop is None or not stop():
            self.tick()
            timer.sleep()


class NativeLatestValue:
    """`LatestValue` backed by the native seqlock mailbox (C++).

    Drop-in for fixed-shape numpy payloads (odometry vectors, plan arrays):
    `publish`/`read` match `LatestValue`'s contract, but the producer never
    blocks and the payload copy runs lock-free outside the GIL
    (`native/mailbox.cpp`) — the real-time analogue of the reference's
    depth-1 DDS subscriptions.  Use `create`; ``None`` means no native
    toolchain (fall back to `LatestValue`).
    """

    def __init__(self, mailbox, shape):
        self._mb = mailbox
        self._shape = tuple(shape)

    @staticmethod
    def create(shape) -> Optional["NativeLatestValue"]:
        import numpy as np

        from ..native import Mailbox  # the port's g++-built library

        size = int(np.prod(shape)) if shape else 1
        mb = Mailbox.create(size)
        return None if mb is None else NativeLatestValue(mb, shape)

    def publish(self, value) -> None:
        import numpy as np

        arr = np.asarray(value, dtype=np.float64)
        assert arr.shape == self._shape, (arr.shape, self._shape)
        self._mb.publish(arr)

    def read(self):
        flat, version = self._mb.read()
        if flat is None:
            return None, 0
        return flat.reshape(self._shape), version

    def close(self) -> None:
        self._mb.close()
