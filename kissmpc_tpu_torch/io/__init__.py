"""The ROS-facing I/O layer of the port: a port of `kissmpc_tpu/io/`.

`Model` (the single robot the reference's ROS node drives, solved on the
card), the snapshot slots and control loop of `pubsub`, the ROS 2 adapter
(`ros2`, rclpy import-guarded), frame recording and replay into the port's
perception pipeline (`frames`), scenario recording (`replay`), and numpy
copies of `transforms` and `markers`."""

from .model import Model
from .pubsub import ControlLoop, LatestValue, RateTimer
from .transforms import (
    SE2,
    decimate_plan,
    plan_changed,
    quaternion_from_yaw,
    yaw_from_quaternion,
)

__all__ = [
    "Model",
    "ControlLoop",
    "LatestValue",
    "RateTimer",
    "SE2",
    "decimate_plan",
    "plan_changed",
    "quaternion_from_yaw",
    "yaw_from_quaternion",
]
