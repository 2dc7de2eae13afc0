"""Visualization marker formatting: the RViz-marker surface, transport-free.
A port-owned copy of `kissmpc_tpu/io/markers.py` (numpy).

The reference's observability is RViz markers: future plan states as green
spheres (`ros2interface.py:63-89`) and tracked humans as cylinders keyed by
track id with explicit DELETE actions for vanished tracks
(`obstacle_handling/human_tracking.py:321-358`).  This module produces the
same marker streams as plain dicts, so any transport (a ROS 2 adapter, a
websocket viewer, a test) can consume them without ROS message types.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

ADD = 0
DELETE = 2


def future_states_markers(
    states_matrix: np.ndarray,
    *,
    frame_id: str = "map",
    scale: float = 0.05,
    color=(0.0, 1.0, 1.0, 1.0),
) -> List[Dict]:
    """Plan states -> sphere markers (`ros2interface.py:63-89` shape/colors).

    Accepts either layout: [3, N+1] (reference column-major) or [N+1, 3].
    """
    arr = np.asarray(states_matrix, dtype=float)
    if arr.shape[0] == 3 and arr.shape[1] != 3:
        arr = arr.T
    r, g, b, a = color
    return [
        {
            "frame_id": frame_id,
            "ns": "future_states",
            "id": i,
            "type": "sphere",
            "action": ADD,
            "position": (float(s[0]), float(s[1]), 0.0),
            "scale": (scale, scale, scale),
            "color": (r, g, b, a),
        }
        for i, s in enumerate(arr)
    ]


class TrackMarkerPublisher:
    """Cylinder markers per confirmed track with DELETE for vanished ids
    (`human_tracking.py:321-358` semantics, as pure bookkeeping)."""

    def __init__(
        self,
        *,
        frame_id: str = "map",
        radius: float = 0.3,
        height: float = 1.7,
        color=(1.0, 0.3, 0.3, 0.9),
    ):
        self.frame_id = frame_id
        self.radius = radius
        self.height = height
        self.color = color
        self._live: set = set()

    def update(
        self,
        track_ids: Sequence[int],
        positions: np.ndarray,
        active: Optional[Sequence[bool]] = None,
    ) -> List[Dict]:
        """Current confirmed tracks -> marker list incl. DELETEs."""
        positions = np.asarray(positions, dtype=float).reshape(-1, 2)
        if active is None:
            active = [True] * len(track_ids)
        now = {
            int(tid)
            for tid, ok in zip(track_ids, active)
            if ok and int(tid) >= 0
        }
        markers: List[Dict] = []
        for tid, pos, ok in zip(track_ids, positions, active):
            if not ok or int(tid) < 0:
                continue
            markers.append(
                {
                    "frame_id": self.frame_id,
                    "ns": "humans",
                    "id": int(tid),
                    "type": "cylinder",
                    "action": ADD,
                    "position": (float(pos[0]), float(pos[1]), self.height / 2),
                    "scale": (2 * self.radius, 2 * self.radius, self.height),
                    "color": self.color,
                }
            )
        for gone in self._live - now:
            markers.append(
                {
                    "frame_id": self.frame_id,
                    "ns": "humans",
                    "id": gone,
                    "type": "cylinder",
                    "action": DELETE,
                }
            )
        self._live = now
        return markers
