"""Frame transforms and rotations at the host boundary.  A port-owned copy
of `kissmpc_tpu/io/transforms.py` (numpy).

Replaces the reference's scipy/tf2 usage: quaternion -> yaw extraction
(`ros2interface.py:14-22`, scipy Rotation) and the map->odom rigid transform
applied to plan poses (`ros2interface.py:111-119`, tf2 `do_transform_pose`).
Closed-form numpy; no scipy, no ROS.
"""

from __future__ import annotations

import numpy as np


def yaw_from_quaternion(quat) -> float:
    """Yaw (z euler angle) from (x, y, z, w) quaternion.

    Closed form of the zyx-convention z angle — equivalent to
    ``R.from_quat(q).as_euler('xyz')[2]`` as used at `ros2interface.py:21-22`.
    """
    x, y, z, w = np.asarray(quat, dtype=np.float64)
    return float(np.arctan2(2.0 * (w * z + x * y), 1.0 - 2.0 * (y * y + z * z)))


def quaternion_from_yaw(yaw: float) -> np.ndarray:
    """(x, y, z, w) quaternion for a pure-z rotation."""
    return np.array([0.0, 0.0, np.sin(yaw / 2.0), np.cos(yaw / 2.0)])


class SE2:
    """Rigid 2-D transform (rotation + translation), the planar core of the
    tf2 map->odom transform the reference looks up per plan callback."""

    def __init__(self, x: float = 0.0, y: float = 0.0, theta: float = 0.0):
        self.translation = np.array([x, y], dtype=np.float64)
        self.theta = float(theta)

    @classmethod
    def from_translation_quaternion(cls, translation, quat) -> "SE2":
        t = np.asarray(translation, dtype=np.float64)
        return cls(t[0], t[1], yaw_from_quaternion(quat))

    @property
    def rotation(self) -> np.ndarray:
        c, s = np.cos(self.theta), np.sin(self.theta)
        return np.array([[c, -s], [s, c]])

    def apply(self, points: np.ndarray) -> np.ndarray:
        """Transform [..., 2] points."""
        p = np.asarray(points, dtype=np.float64)
        return p @ self.rotation.T + self.translation

    def apply_pose(self, pose) -> np.ndarray:
        """Transform an (x, y, yaw) pose."""
        x, y, yaw = np.asarray(pose, dtype=np.float64)
        p = self.apply(np.array([x, y]))
        return np.array([p[0], p[1], yaw + self.theta])

    def inverse(self) -> "SE2":
        c, s = np.cos(self.theta), np.sin(self.theta)
        inv_t = -(np.array([[c, s], [-s, c]]) @ self.translation)
        return SE2(inv_t[0], inv_t[1], -self.theta)

    def compose(self, other: "SE2") -> "SE2":
        t = self.apply(other.translation)
        return SE2(t[0], t[1], self.theta + other.theta)


def decimate_plan(
    poses: np.ndarray, stride: int = 25
) -> np.ndarray:
    """Decimate a dense planner path into waypoints: every ``stride``-th pose
    plus the final pose (`ros2interface.py:142-170`)."""
    poses = np.asarray(poses, dtype=np.float64).reshape(-1, 3)
    if len(poses) == 0:
        return poses
    out = list(poses[::stride])
    out.append(poses[-1])
    return np.stack(out)


def plan_changed(
    old_waypoints, new_final_pose, tolerance: float = 0.1
) -> bool:
    """Reference's plan-update gate: replace waypoints only when the final
    pose moved by more than ``tolerance`` (summed coordinate difference —
    the reference's exact, if odd, metric at `ros2interface.py:121-140`)."""
    if old_waypoints is None or len(old_waypoints) == 0:
        return True
    diff = np.asarray(old_waypoints[-1], dtype=np.float64) - np.asarray(
        new_final_pose, dtype=np.float64
    )
    return bool(abs(diff.sum()) > tolerance)
