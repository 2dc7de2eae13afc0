from .obstacles import (
    HUMAN_RADIUS,
    PREDICTION_DT,
    ObstacleSet,
    clearance_to_point,
    distance_to_point,
    dynamic_set,
    empty,
    predict_tracks,
    select_nearest,
    static_set,
)

__all__ = [
    "HUMAN_RADIUS",
    "PREDICTION_DT",
    "ObstacleSet",
    "clearance_to_point",
    "distance_to_point",
    "dynamic_set",
    "empty",
    "predict_tracks",
    "select_nearest",
    "static_set",
]
