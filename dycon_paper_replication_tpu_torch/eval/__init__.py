"""Evaluation: the sliding-window engine and the per-dataset drivers."""

from .evaluator import (
    AUTO_GROUP,
    WholeVolumeInference,
    auto_group,
    iter_h5_volumes,
    iter_volumes,
    test_all_case,
    test_all_case_wholevolume,
    var_all_case,
    var_all_case_wholevolume,
)
from .sliding_window import SlidingWindowInference, compute_origins

__all__ = [
    "AUTO_GROUP", "auto_group", "SlidingWindowInference", "compute_origins", "iter_h5_volumes", "iter_volumes",
    "test_all_case", "var_all_case", "WholeVolumeInference", "test_all_case_wholevolume",
    "var_all_case_wholevolume",
]
