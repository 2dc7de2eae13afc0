"""Perception-frame recording / replay + approximate time synchronization.
A port of `kissmpc_tpu/io/frames.py`: numpy up to the replay, which drives
the port's `perception.pipeline.step` on the device the caller names.

The reference replays recorded sensor *sessions* through `BagReader`
(`obstacle_handling/human_tracking.py:46-111`): raw image/cloud topics are
republished with wall-clock pacing and the perception node pairs them with an
`ApproximateTimeSynchronizer` (slop 0.1 s, `human_tracking.py:147-152`).

The framework-native analogue records the two sensor streams as timestamped
arrays in one compressed npz — the image stream *post-detector* (instance
masks + validity, the pipeline's actual input; the neural net stays outside
the pipeline's boundary, see `perception/detectors.py`) and the cloud stream
(points + padding mask + per-frame lidar->map transform, the reference's
per-frame tf lookup).  Replay pairs the streams with the same slop-windowed
policy, optionally paced in wall-clock time, and drives
`perception.pipeline.step` deterministically: the same recording always
reproduces the same track table.
"""

from __future__ import annotations

import time
from typing import Iterator, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from ..perception.pipeline import FrameGeometry
from ..perception.projection import SE3, Intrinsics


def approx_sync(
    ts_a: Sequence[float],
    ts_b: Sequence[float],
    slop: float,
) -> List[Tuple[int, int]]:
    """Slop-windowed pairing of two timestamp streams.

    Greedy nearest-neighbour in time order: each candidate pair within
    ``slop`` seconds is accepted smallest-gap-first and each message is used
    at most once — the practical contract of the reference's
    `ApproximateTimeSynchronizer(..., slop=0.1)`
    (`human_tracking.py:147-152`).  Returns index pairs (i_a, i_b) sorted by
    the a-stream time.
    """
    ts_a = np.asarray(ts_a, dtype=np.float64)
    ts_b = np.asarray(ts_b, dtype=np.float64)
    if ts_a.size == 0 or ts_b.size == 0:
        return []
    # all in-window candidate pairs, best (smallest |dt|) first
    gaps = np.abs(ts_a[:, None] - ts_b[None, :])
    ii, jj = np.nonzero(gaps <= slop)
    order = np.argsort(gaps[ii, jj], kind="stable")
    used_a = np.zeros(ts_a.size, bool)
    used_b = np.zeros(ts_b.size, bool)
    pairs: List[Tuple[int, int]] = []
    for k in order:
        i, j = int(ii[k]), int(jj[k])
        if used_a[i] or used_b[j]:
            continue
        used_a[i] = used_b[j] = True
        pairs.append((i, j))
    pairs.sort(key=lambda p: ts_a[p[0]])
    return pairs


class SyncedFrame(NamedTuple):
    """One time-paired sensor frame, ready for `pipeline.step`."""

    stamp: float  # cloud-stream timestamp (seconds)
    points: np.ndarray  # [P, 3] lidar points
    point_mask: np.ndarray  # [P] bool padding mask
    instance_masks: np.ndarray  # [M, H, W] bool
    instance_valid: np.ndarray  # [M] bool
    geometry: FrameGeometry  # numpy leaves


def _geom_to_payload(geom: FrameGeometry, prefix: str, payload: dict) -> None:
    payload[f"{prefix}K"] = np.array(
        [
            [float(geom.intrinsics.fx), 0.0, float(geom.intrinsics.cx)],
            [0.0, float(geom.intrinsics.fy), float(geom.intrinsics.cy)],
            [0.0, 0.0, 1.0],
        ]
    )
    payload[f"{prefix}lidar_to_camera_R"] = np.asarray(
        geom.lidar_to_camera.rotation
    )
    payload[f"{prefix}lidar_to_camera_t"] = np.asarray(
        geom.lidar_to_camera.translation
    )
    payload[f"{prefix}image_size"] = np.array(
        [geom.image_width, geom.image_height]
    )


def _geom_from_payload(data, prefix: str, lidar_to_map: SE3) -> FrameGeometry:
    w, h = (int(x) for x in data[f"{prefix}image_size"])
    return FrameGeometry(
        intrinsics=Intrinsics.from_matrix(data[f"{prefix}K"]),
        lidar_to_camera=SE3(
            rotation=data[f"{prefix}lidar_to_camera_R"],
            translation=data[f"{prefix}lidar_to_camera_t"],
        ),
        lidar_to_map=lidar_to_map,
        image_width=w,
        image_height=h,
    )


class FrameRecorder:
    """Accumulates the two sensor streams; saves one compressed npz.

    Fixed shapes per session (static P/M/H/W — the pipeline's contract);
    camera intrinsics and the lidar->camera extrinsic are per-session (the
    reference hardcodes the extrinsic, `human_tracking.py:192-200`), while
    lidar->map is per cloud frame (the reference's tf lookup,
    `human_tracking.py:185-188`).
    """

    def __init__(self, geometry: FrameGeometry):
        self._geometry = geometry
        self._cloud_ts: List[float] = []
        self._points: List[np.ndarray] = []
        self._point_masks: List[np.ndarray] = []
        self._lidar_to_map_R: List[np.ndarray] = []
        self._lidar_to_map_t: List[np.ndarray] = []
        self._image_ts: List[float] = []
        self._inst_masks: List[np.ndarray] = []
        self._inst_valid: List[np.ndarray] = []

    def record_cloud(
        self,
        stamp: float,
        points: np.ndarray,
        point_mask: np.ndarray,
        lidar_to_map: Optional[SE3] = None,
    ) -> None:
        self._cloud_ts.append(float(stamp))
        self._points.append(np.asarray(points))
        self._point_masks.append(np.asarray(point_mask, dtype=bool))
        tf = (
            lidar_to_map
            if lidar_to_map is not None
            else self._geometry.lidar_to_map
        )
        self._lidar_to_map_R.append(np.asarray(tf.rotation))
        self._lidar_to_map_t.append(np.asarray(tf.translation))

    def record_image(
        self,
        stamp: float,
        instance_masks: np.ndarray,
        instance_valid: np.ndarray,
    ) -> None:
        self._image_ts.append(float(stamp))
        self._inst_masks.append(np.asarray(instance_masks, dtype=bool))
        self._inst_valid.append(np.asarray(instance_valid, dtype=bool))

    def __len__(self) -> int:
        return len(self._cloud_ts) + len(self._image_ts)

    def save(self, path: str) -> None:
        if not self._cloud_ts or not self._image_ts:
            raise ValueError("need at least one frame on each stream")
        payload = {
            "cloud.stamp": np.asarray(self._cloud_ts),
            "cloud.points": np.stack(self._points),
            "cloud.point_mask": np.stack(self._point_masks),
            "cloud.lidar_to_map_R": np.stack(self._lidar_to_map_R),
            "cloud.lidar_to_map_t": np.stack(self._lidar_to_map_t),
            "image.stamp": np.asarray(self._image_ts),
            "image.instance_masks": np.stack(self._inst_masks),
            "image.instance_valid": np.stack(self._inst_valid),
        }
        _geom_to_payload(self._geometry, "geometry.", payload)
        np.savez_compressed(path, **payload)


class FrameReplayer:
    """Loads a recorded session; yields time-synced frames, optionally paced.

    ``pace=True`` sleeps out the recorded inter-frame gaps (scaled by
    ``rate``) before yielding, like the reference's `BagReader` republisher
    (`human_tracking.py:83-108`); the default replays as fast as possible,
    which is what deterministic tests want.
    """

    def __init__(self, path: str):
        self._data = dict(np.load(path))
        self.cloud_stamps = self._data["cloud.stamp"]
        self.image_stamps = self._data["image.stamp"]

    def synced(
        self,
        slop: float = 0.1,
        *,
        pace: bool = False,
        rate: float = 1.0,
        sleep=time.sleep,
    ) -> Iterator[SyncedFrame]:
        pairs = approx_sync(self.cloud_stamps, self.image_stamps, slop)
        prev_stamp = None
        for i, j in pairs:
            stamp = float(self.cloud_stamps[i])
            if pace and prev_stamp is not None and stamp > prev_stamp:
                sleep((stamp - prev_stamp) / rate)
            prev_stamp = stamp
            lidar_to_map = SE3(
                rotation=self._data["cloud.lidar_to_map_R"][i],
                translation=self._data["cloud.lidar_to_map_t"][i],
            )
            yield SyncedFrame(
                stamp=stamp,
                points=self._data["cloud.points"][i],
                point_mask=self._data["cloud.point_mask"][i],
                instance_masks=self._data["image.instance_masks"][j],
                instance_valid=self._data["image.instance_valid"][j],
                geometry=_geom_from_payload(
                    self._data, "geometry.", lidar_to_map
                ),
            )


def replay_session(
    replayer: FrameReplayer,
    tracker_cfg,
    *,
    capacity: int = 16,
    slop: float = 0.1,
    pace: bool = False,
    rate: float = 1.0,
    device=None,
):
    """Drive the perception pipeline over a recorded session.

    Returns ``(state, obstacles_per_frame)``: the final `PerceptionState`
    and the solver-ready `ObstacleSet` after each synced frame, as tensors
    on ``device`` (None: the card).  Frame dt comes from the recorded
    timestamps (first frame gets the session's median gap), so a replayed
    session reproduces the live tracker outputs deterministically.
    """
    import torch

    from .._device import resolve_device
    from ..bridge import geometry_from_numpy
    from ..perception import pipeline as pipe

    dev = resolve_device(device)
    state = pipe.init_perception(capacity=capacity, dtype=torch.float32, device=dev)
    frames = list(replayer.synced(slop=slop)) if not pace else None
    stamps = (
        [f.stamp for f in frames]
        if frames is not None
        else list(replayer.cloud_stamps)
    )
    gaps = np.diff(sorted(stamps))
    default_dt = float(np.median(gaps)) if gaps.size else 0.1
    it = (
        iter(frames)
        if frames is not None
        else replayer.synced(slop=slop, pace=True, rate=rate)
    )
    prev_stamp = None
    outputs = []
    for frame in it:
        dt = (
            frame.stamp - prev_stamp if prev_stamp is not None else default_dt
        )
        prev_stamp = frame.stamp
        state, obstacles = pipe.step(
            tracker_cfg,
            state,
            geometry_from_numpy(frame.geometry, device=dev),
            torch.as_tensor(frame.points, device=dev),
            torch.as_tensor(frame.point_mask, device=dev),
            torch.as_tensor(frame.instance_masks, device=dev),
            torch.as_tensor(frame.instance_valid, device=dev),
            dt=float(dt),
            device=dev,
        )
        outputs.append(obstacles)
    return state, outputs


def record_synthetic_walk(
    path: str,
    *,
    n_frames: int = 60,
    dt: float = 0.1,
    n_points: int = 128,
    cluster: int = 40,
    image_hw: Tuple[int, int] = (48, 64),
    seed: int = 0,
):
    """Record a deterministic synthetic session: one human walking across
    the sensor FOV (the test/bench stand-in for a rosbag of the reference's
    `BagReader` sessions, `obstacle_handling/human_tracking.py:46-111`).

    The human is a ``cluster``-point LiDAR blob at z = 2 m walking along y;
    the image stream carries the matching instance mask (a box around the
    blob's projection).  Returns the human's ground-truth [F, 2] map-frame
    track for assertions.
    """
    from ..perception.pipeline import FrameGeometry
    from ..perception.projection import SE3, Intrinsics

    H, W = image_hw
    intr = Intrinsics(
        fx=np.float32(40.0), fy=np.float32(40.0),
        cx=np.float32(W / 2), cy=np.float32(H / 2),
    )
    eye = SE3(rotation=np.eye(3, dtype=np.float32),
              translation=np.zeros(3, np.float32))
    geom = FrameGeometry(
        intrinsics=intr, lidar_to_camera=eye, lidar_to_map=eye,
        image_width=W, image_height=H,
    )
    rec = FrameRecorder(geom)
    rng = np.random.default_rng(seed)
    truth = np.zeros((n_frames, 2), np.float32)
    for f in range(n_frames):
        t = f * dt
        hx = 0.3 + 0.0 * t
        hy = -1.0 + 2.0 * (f / max(1, n_frames - 1))  # walk across
        truth[f] = (hx, hy)
        pts = np.zeros((n_points, 3), np.float32)
        pts[:cluster, 0] = hx + rng.normal(0, 0.02, cluster)
        pts[:cluster, 1] = hy + rng.normal(0, 0.02, cluster)
        pts[:cluster, 2] = 2.0
        mask = np.zeros(n_points, bool)
        mask[:cluster] = True
        rec.record_cloud(t, pts, mask)
        u = int(W / 2 + 40.0 * hx / 2.0)
        v = int(H / 2 + 40.0 * hy / 2.0)
        inst = np.zeros((1, H, W), bool)
        inst[0, max(0, v - 8): v + 8, max(0, u - 8): u + 8] = True
        rec.record_image(t + 0.01, inst, np.array([True]))
    rec.save(path)
    return truth
