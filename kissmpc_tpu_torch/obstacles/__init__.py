from .obstacles import (
    HUMAN_RADIUS,
    PREDICTION_DT,
    ObstacleSet,
    advance,
    clearance_to_point,
    distance_to_point,
    dynamic_set,
    empty,
    predict_tracks,
    select_nearest,
    static_set,
    to_device,
)

__all__ = [
    "HUMAN_RADIUS",
    "PREDICTION_DT",
    "ObstacleSet",
    "advance",
    "clearance_to_point",
    "distance_to_point",
    "dynamic_set",
    "empty",
    "predict_tracks",
    "select_nearest",
    "static_set",
    "to_device",
]
