"""Import-guarded ROS 2 adapter, layer L5 of the reference.  A port-owned
copy of `kissmpc_tpu/io/ros2.py` over the port's `Model`.

Maps the transport-free control plane (`Model` + `ControlLoop`,
`kissmpc_tpu_torch.io.model` / `.pubsub`) onto an rclpy node with the reference
node's exact topic surface (`ros2interface.py:24-61`):

 * subscribe `nav_msgs/Path` on ``/plan`` and `nav_msgs/Odometry` on
   ``/odom`` (`ros2interface.py:45-46`);
 * publish `geometry_msgs/Twist` on ``cmd_vel`` and a
   `visualization_msgs/MarkerArray` on ``/future_states``
   (`ros2interface.py:48-49,63-89`);
 * a ``1/rate_hz`` timer driving one control tick (100 Hz,
   `ros2interface.py:50`).

Unlike the reference — whose odometry callback mutates the model the timer
is concurrently reading (the race of SURVEY.md section 5.2) — all messages
land in single-writer `LatestValue` slots and are folded in at tick
boundaries by `ControlLoop`.

rclpy is not a dependency: this module imports it lazily inside
`Ros2Interface.__init__`, so everything else in `kissmpc_tpu_torch.io`
works without ROS, and the adapter itself is contract-tested against a
fake rclpy.  ``ros2_available()`` reports whether rclpy imports.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .markers import future_states_markers
from .model import Model
from .pubsub import ControlLoop, LatestValue
from .transforms import decimate_plan, plan_changed, yaw_from_quaternion


def ros2_available() -> bool:
    try:
        import rclpy  # noqa: F401

        return True
    except ImportError:
        return False


def odometry_to_state(msg) -> np.ndarray:
    """`nav_msgs/Odometry` -> (x, y, yaw), the reference's odom ingestion
    (`ros2interface.py:91-107`, quaternion -> yaw via `:21-22`)."""
    p = msg.pose.pose.position
    q = msg.pose.pose.orientation
    return np.array(
        [p.x, p.y, yaw_from_quaternion([q.x, q.y, q.z, q.w])],
        dtype=np.float64,
    )


def path_to_waypoints(msg, stride: int = 25) -> np.ndarray:
    """`nav_msgs/Path` -> decimated waypoint array [W, 3]
    (`ros2interface.py:142-170`: every ``stride``-th pose plus the final)."""
    poses = np.array(
        [
            [
                ps.pose.position.x,
                ps.pose.position.y,
                yaw_from_quaternion(
                    [
                        ps.pose.orientation.x,
                        ps.pose.orientation.y,
                        ps.pose.orientation.z,
                        ps.pose.orientation.w,
                    ]
                ),
            ]
            for ps in msg.poses
        ],
        dtype=np.float64,
    ).reshape(-1, 3)
    return decimate_plan(poses, stride)


class Ros2Interface:
    """The reference `ROS2Interface(Node)` surface over the rebuilt core.

    Construct with an optional pre-built `Model`; reference deployment
    defaults otherwise (horizon 7, dt 0.8, bounds +-0.3,
    `ros2interface.py:28-38`), solved on ``device`` (None: the card).
    """

    def __init__(
        self,
        model: Optional[Model] = None,
        *,
        node_name: str = "kissmpc_controller",
        rate_hz: float = 100.0,
        plan_stride: int = 25,
        rclpy_module=None,
        device=None,
    ):
        # Lazy import so the package works without ROS installed; a test can
        # inject a fake module tree via ``rclpy_module``.
        if rclpy_module is None:
            import rclpy as rclpy_module  # noqa: PLC0415
        self._rclpy = rclpy_module
        from geometry_msgs.msg import Twist  # noqa: PLC0415
        from nav_msgs.msg import Odometry, Path  # noqa: PLC0415
        from visualization_msgs.msg import (  # noqa: PLC0415
            Marker,
            MarkerArray,
        )

        self._Twist = Twist
        self._Marker = Marker
        self._MarkerArray = MarkerArray

        self.model = model if model is not None else Model(
            horizon=7,
            planning_time_step=0.8,
            linear_velocity_bounds=(-0.3, 0.3),
            angular_velocity_bounds=(-0.3, 0.3),
            device=device,
        )
        self.plan_stride = plan_stride
        self.odometry = LatestValue()
        self.plan = LatestValue()
        self.obstacles = LatestValue()
        self.loop = ControlLoop(
            self.model,
            odometry=self.odometry,
            plan=self.plan,
            obstacles=self.obstacles,
            on_command=self._publish_command,
            on_future_states=self._publish_future_states,
        )

        self.node = rclpy_module.create_node(node_name)
        self.plan_sub = self.node.create_subscription(
            Path, "/plan", self._plan_callback, 10
        )
        self.odom_sub = self.node.create_subscription(
            Odometry, "/odom", self._odom_callback, 10
        )
        self.cmd_pub = self.node.create_publisher(Twist, "cmd_vel", 10)
        self.markers_pub = self.node.create_publisher(
            MarkerArray, "/future_states", 10
        )
        self.timer = self.node.create_timer(1.0 / rate_hz, self.run)

    # -- callbacks (producers: write snapshot slots only) -------------------

    def _odom_callback(self, msg) -> None:
        self.odometry.publish(odometry_to_state(msg))

    def _plan_callback(self, msg) -> None:
        waypoints = path_to_waypoints(msg, self.plan_stride)
        if len(waypoints) == 0:
            return
        # Plan-update gate: only replace when the final pose moved
        # (`ros2interface.py:121-140`).
        if plan_changed(self.model.waypoints, waypoints[-1]):
            self.plan.publish(waypoints)

    def publish_obstacles(self, obstacle_set) -> None:
        """Entry point for a perception adapter feeding `ObstacleSet`s."""
        self.obstacles.publish(obstacle_set)

    # -- tick (consumer) ----------------------------------------------------

    def run(self) -> None:
        """One control tick (`ros2interface.py:51-61` semantics)."""
        self.loop.tick()

    def _publish_command(self, v: float, omega: float) -> None:
        msg = self._Twist()
        msg.linear.x = float(v)
        msg.angular.z = float(omega)
        self.cmd_pub.publish(msg)

    def _publish_future_states(self, states_matrix) -> None:
        arr = self._MarkerArray()
        markers = []
        for m in future_states_markers(states_matrix):
            mk = self._Marker()
            mk.ns = m["ns"]
            mk.id = m["id"]
            mk.action = m["action"]
            mk.header.frame_id = m["frame_id"]
            mk.pose.position.x = m["position"][0]
            mk.pose.position.y = m["position"][1]
            mk.pose.position.z = m["position"][2]
            mk.scale.x, mk.scale.y, mk.scale.z = m["scale"]
            (
                mk.color.r,
                mk.color.g,
                mk.color.b,
                mk.color.a,
            ) = m["color"]
            markers.append(mk)
        arr.markers = markers
        self.markers_pub.publish(arr)

    def spin(self) -> None:
        """`main()` analogue (`ros2interface.py:176-182`)."""
        self._rclpy.spin(self.node)


def main() -> None:  # pragma: no cover - requires a live ROS graph
    import rclpy

    rclpy.init()
    iface = Ros2Interface()
    try:
        iface.spin()
    finally:
        iface.node.destroy_node()
        rclpy.shutdown()
