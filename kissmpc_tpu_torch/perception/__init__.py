"""Perception on tensors: a port of `kissmpc_tpu/perception/` (projection,
DBSCAN, the track table and the pipeline that joins them), with port-owned
copies of the detector boundary (`detectors.py`) and the torch segmenter
(`segnet.py`)."""

from . import clustering, pipeline, projection, tracker
from .clustering import ClusterResult, dbscan, largest_cluster_mean
from .pipeline import (
    FrameGeometry,
    PerceptionState,
    detect_centers,
    init_perception,
)
from .projection import SE3, Intrinsics
from .tracker import TrackerConfig, TrackTable, init_tracks, to_obstacles

__all__ = [
    "clustering",
    "pipeline",
    "projection",
    "tracker",
    "ClusterResult",
    "dbscan",
    "largest_cluster_mean",
    "FrameGeometry",
    "PerceptionState",
    "detect_centers",
    "init_perception",
    "SE3",
    "Intrinsics",
    "TrackerConfig",
    "TrackTable",
    "init_tracks",
    "to_obstacles",
]
