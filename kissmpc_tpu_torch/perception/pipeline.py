"""Perception pipeline: (segmentation masks + point cloud) -> tracked
dynamic obstacles.  A port of `kissmpc_tpu/perception/pipeline.py`.

The compute side of `DetectorNode.synchronized_callback`
(`obstacle_handling/human_tracking.py:179-316`): LiDAR range filter,
lidar->camera transform, pinhole projection, per-instance mask selection,
density clustering for the 3-D centre, map-frame transform, then the track
table.  The neural detector stays outside (see `detectors.py`): the
pipeline consumes any detector's instance masks as tensors.

Batch-major by design: a `PerceptionState` made with ``batch=B`` carries B
independent pipelines ([B]-leading leaves), and `step` broadcasts one
frame to all of them, as the reference's fleet bench vmaps one frame over
B pipelines (`scripts/bench_perception_tick.py:91-98`).  Every pipeline is
computed; none is deduplicated.  Shapes are static: P = max LiDAR points
(padded + masked), M = max instances per frame.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from .._device import resolve_device
from ..obstacles import ObstacleSet
from . import clustering, projection, tracker

# Reference constants (`obstacle_handling/human_tracking.py`).
MAX_LIDAR_RANGE = 5.0  # `:223-225`
DBSCAN_EPS = 0.08  # `:126`
DBSCAN_MIN_SAMPLES = 10  # `:127`


class FrameGeometry(NamedTuple):
    intrinsics: projection.Intrinsics
    lidar_to_camera: projection.SE3  # hardcoded extrinsic in the reference
    lidar_to_map: projection.SE3  # tf lookup per frame (`:185-188`)
    image_width: int
    image_height: int


def detect_centers(geom: FrameGeometry, points_lidar: torch.Tensor, point_mask: torch.Tensor,
                   instance_masks: torch.Tensor, instance_valid: torch.Tensor, *,
                   eps: float = DBSCAN_EPS, min_samples: int = DBSCAN_MIN_SAMPLES,
                   max_range: float = MAX_LIDAR_RANGE, device=None) -> Tuple[torch.Tensor,
                                                                              torch.Tensor]:
    """Per-instance centres in the map frame.

    points_lidar [..., P, 3], point_mask [..., P], instance_masks
    [..., M, H, W] bool, instance_valid [..., M]; their leading axes
    broadcast.  Returns (centres [..., M, 2] map-frame x/y, found [..., M]
    bool), the reference's per-track loop (`human_tracking.py:244-294`) over
    every instance at once.  ``device=None`` is the card; the inputs are
    moved there.
    """
    dev = resolve_device(device)
    points_lidar, point_mask, instance_masks, instance_valid = (
        torch.as_tensor(x, device=dev)
        for x in (points_lidar, point_mask, instance_masks, instance_valid))
    mask = projection.range_filter(points_lidar, point_mask, max_range)
    points_cam = geom.lidar_to_camera.apply(points_lidar)
    uv, valid = projection.project_points(geom.intrinsics, points_cam, mask,
                                          geom.image_width, geom.image_height)
    points_map = geom.lidar_to_map.apply(points_lidar)[..., None, :, :2]  # [..., 1, P, 2]

    sel = (projection.points_in_mask(instance_masks, uv[..., None, :, :], valid[..., None, :])
           & instance_valid[..., None])  # [..., M, P]
    points_map = points_map.expand(sel.shape + (2,))
    result = clustering.dbscan(points_map, sel, eps=eps, min_samples=min_samples)
    centers, found = clustering.largest_cluster_mean(points_map, result)
    return centers, found & instance_valid


class PerceptionState(NamedTuple):
    tracks: tracker.TrackTable


def init_perception(capacity: int = 16, dtype=torch.float32, *, batch: int | None = None,
                    device=None) -> PerceptionState:
    """Empty track tables; ``batch`` gives every leaf a leading [batch]
    axis (B independent pipelines).  ``device=None`` is the card."""
    return PerceptionState(tracks=tracker.init_tracks(capacity, dtype, batch=batch,
                                                      device=device))


def step(cfg: tracker.TrackerConfig, state: PerceptionState, geom: FrameGeometry,
         points_lidar: torch.Tensor, point_mask: torch.Tensor, instance_masks: torch.Tensor,
         instance_valid: torch.Tensor, dt: float, *,
         device=None) -> Tuple[PerceptionState, ObstacleSet]:
    """One synchronized frame -> updated tracks + solver-ready obstacles.

    A frame without the state's leading axes ([P, 3], [P], [M, H, W], [M])
    is broadcast to every pipeline of a batched state.  ``device=None`` is
    the card; the state and the frame are moved there.
    """
    dev = resolve_device(device)
    tracks = tracker.TrackTable(*(x.to(dev) for x in state.tracks))
    lead = tracks.position.shape[:-2]

    def per_pipeline(x, dims):
        x = torch.as_tensor(x, device=dev)
        return x.expand(lead + x.shape) if x.dim() == dims else x

    points_lidar, point_mask, instance_masks, instance_valid = (
        per_pipeline(x, dims) for x, dims in ((points_lidar, 2), (point_mask, 1),
                                              (instance_masks, 3), (instance_valid, 1)))
    centers, found = detect_centers(geom, points_lidar, point_mask, instance_masks,
                                    instance_valid, device=dev)
    tracks = tracker.update(cfg, tracks, centers, found, dt)
    return PerceptionState(tracks=tracks), tracker.to_obstacles(cfg, tracks)
