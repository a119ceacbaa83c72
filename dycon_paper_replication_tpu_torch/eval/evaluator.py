"""Validation and test drivers over the sliding-window engine.

Counterpart of the sliding-window half of
dycon_paper_replication_tpu/eval/evaluator.py:
  var_all_case  - Dice-only validation;
  test_all_case - the per-case (Dice, Jaccard, HD95, ASD) table with the
                  optional largest-connected-component step and a
                  performance.txt artifact.
The ISLES whole-volume drivers are not ported yet.
"""

from __future__ import annotations

import os
from typing import Iterable, Iterator

import numpy as np

from ..ops import metrics
from .sliding_window import SlidingWindowInference


def iter_h5_volumes(paths: Iterable[str],
                    label_key: str = "label") -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """Yield (image, label uint8) pairs from .h5 files. (The BraTS axial
    view change of the JAX reader comes with the BraTS slice.)"""
    import h5py

    for path in paths:
        with h5py.File(path, "r") as f:
            yield f["image"][:], f[label_key][:].astype(np.uint8)


def iter_volumes(paths: Iterable[str], label_key: str = "label"):
    """Yield (image, label uint8) pairs from .h5 or .npz files (an .npz holds
    the same `image` and label arrays, and needs no h5py)."""
    for path in paths:
        if path.endswith(".npz"):
            with np.load(path) as f:
                yield f["image"], f[label_key].astype(np.uint8)
        else:
            yield from iter_h5_volumes([path], label_key)


def var_all_case(sw: SlidingWindowInference,
                 volumes: Iterable[tuple[np.ndarray, np.ndarray]]) -> float:
    """Mean Dice over the validation volumes (0 for empty predictions)."""
    total, n = 0.0, 0
    for pred, _, label in sw.map(volumes):
        total += metrics.dice(pred, label) if pred.sum() > 0 else 0.0
        n += 1
    return total / max(n, 1)


def test_all_case(sw: SlidingWindowInference,
                  volumes: Iterable[tuple[np.ndarray, np.ndarray]], *, nms: bool = False,
                  metric_detail: bool = False,
                  test_save_path: str | None = None) -> np.ndarray:
    """Average (dice, jaccard, hd95, asd) over the test volumes."""
    total = np.zeros(4)
    n = 0
    if metric_detail:
        print(f"{'ID':<3} | {'Dice':<8} | {'Jaccard':<8} | {'HD95':<8} | {'ASD':<8}")
        print("-" * 45)
    for pred, _, label in sw.map(volumes):
        if nms:
            pred = metrics.largest_connected_component(pred)
        if pred.sum() == 0:
            case = (0.0, 0.0, 0.0, 0.0)
        else:
            case = metrics.calculate_metric_percase(pred, label)
        if metric_detail:
            print(f"{n:02d}  | {case[0]:<8.5f} | {case[1]:<8.5f} | {case[2]:<8.5f} | {case[3]:<8.5f}")
        total += np.asarray(case)
        n += 1
    avg = total / max(n, 1)
    print(f"average metric is {avg}")
    if test_save_path is not None:
        os.makedirs(test_save_path, exist_ok=True)
        with open(os.path.join(test_save_path, "performance.txt"), "w") as f:
            f.write(f"average metric is {avg} \n")
    return avg
