"""Segmentation quality metrics.

Counterpart of dycon_paper_replication_tpu/ops/metrics.py:
  * on tensors, batched: batch_dice, batch_jaccard (per sample);
  * on the host (numpy/scipy): dice / jaccard scalars, hd95, asd,
    sensitivity, specificity, calculate_metric_percase, compute_hd95_batch
    (the trainer's train-HD95), largest_connected_component.

medpy conventions (medpy.metric.binary, which the original evaluation uses):
  * surface voxels = object minus its binary erosion with the
    connectivity-1 (6-neighbourhood) cross structuring element;
  * surface distance set = Euclidean distance transform of the
    complement of the OTHER object's surface, sampled at this object's
    surface voxels;
  * hd95 = p95 over the CONCATENATION of both directed surface-distance
    sets (not the max of per-direction percentiles); asd = mean(d(A->B)).
largest_connected_component matches skimage.measure.label's default FULL
connectivity (26-neighbourhood) + bincount argmax.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy import ndimage


def batch_dice(pred: torch.Tensor, label: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Per-sample soft or hard Dice over (B, ...) masks -> (B,), in float32."""
    dims = tuple(range(1, pred.dim()))
    pred, label = pred.to(torch.float32), label.to(torch.float32)
    inter = (pred * label).sum(dim=dims)
    return 2.0 * inter / (pred.sum(dim=dims) + label.sum(dim=dims) + eps)


def batch_jaccard(pred: torch.Tensor, label: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Per-sample Jaccard over (B, ...) masks -> (B,), in float32."""
    dims = tuple(range(1, pred.dim()))
    pred, label = pred.to(torch.float32), label.to(torch.float32)
    inter = (pred * label).sum(dim=dims)
    return inter / (pred.sum(dim=dims) + label.sum(dim=dims) - inter + eps)


def dice(pred: np.ndarray, gt: np.ndarray) -> float:
    pred = np.asarray(pred, bool)
    gt = np.asarray(gt, bool)
    denom = pred.sum() + gt.sum()
    if denom == 0:
        return 0.0
    return float(2.0 * np.logical_and(pred, gt).sum() / denom)


def jaccard(pred: np.ndarray, gt: np.ndarray) -> float:
    pred = np.asarray(pred, bool)
    gt = np.asarray(gt, bool)
    union = np.logical_or(pred, gt).sum()
    if union == 0:
        return 0.0
    return float(np.logical_and(pred, gt).sum() / union)


def _surface_voxels(mask: np.ndarray) -> np.ndarray:
    structure = ndimage.generate_binary_structure(mask.ndim, 1)
    eroded = ndimage.binary_erosion(mask, structure=structure, border_value=0)
    return mask & ~eroded


def surface_distances(
    result: np.ndarray, reference: np.ndarray, voxelspacing=None
) -> np.ndarray:
    """Distances from each surface voxel of `result` to the nearest
    surface voxel of `reference` (medpy __surface_distances)."""
    result = np.atleast_1d(np.asarray(result, bool))
    reference = np.atleast_1d(np.asarray(reference, bool))
    if result.sum() == 0 or reference.sum() == 0:
        raise ValueError("surface distance undefined for empty masks")
    result_border = _surface_voxels(result)
    reference_border = _surface_voxels(reference)
    dt = ndimage.distance_transform_edt(~reference_border, sampling=voxelspacing)
    return dt[result_border]


def hd95(pred: np.ndarray, gt: np.ndarray, voxelspacing=None) -> float:
    """95th-percentile symmetric Hausdorff distance.

    medpy convention: the percentile is taken over the CONCATENATION of
    both directed surface-distance sets (not the max of per-direction
    percentiles) — medpy.metric.binary.hd95 does
    np.percentile(np.hstack((d1, d2)), 95)."""
    d1 = surface_distances(pred, gt, voxelspacing)
    d2 = surface_distances(gt, pred, voxelspacing)
    return float(np.percentile(np.hstack((d1, d2)), 95))


def asd(pred: np.ndarray, gt: np.ndarray, voxelspacing=None) -> float:
    """Average (one-sided) surface distance pred -> gt."""
    return float(surface_distances(pred, gt, voxelspacing).mean())


def sensitivity(pred: np.ndarray, gt: np.ndarray) -> float:
    pred = np.asarray(pred, bool)
    gt = np.asarray(gt, bool)
    tp = np.logical_and(pred, gt).sum()
    fn = np.logical_and(~pred, gt).sum()
    if tp + fn == 0:
        return 0.0
    return float(tp / (tp + fn))


def specificity(pred: np.ndarray, gt: np.ndarray) -> float:
    pred = np.asarray(pred, bool)
    gt = np.asarray(gt, bool)
    tn = np.logical_and(~pred, ~gt).sum()
    fp = np.logical_and(pred, ~gt).sum()
    if tn + fp == 0:
        return 0.0
    return float(tn / (tn + fp))


def calculate_metric_percase(pred: np.ndarray, gt: np.ndarray) -> tuple:
    """(dice, jaccard, hd95, asd) with the reference's empty-GT guard
    (test_3d_patch.py:496-508: hd/asd reported as 0 when gt is empty)."""
    d = dice(pred, gt)
    j = jaccard(pred, gt)
    if np.asarray(gt).sum() == 0 or np.asarray(pred).sum() == 0:
        return d, j, 0.0, 0.0
    return d, j, hd95(pred, gt), asd(pred, gt)


def compute_hd95_batch(pred: np.ndarray, target: np.ndarray, max_dist: float) -> list[float]:
    """hd95 per batch item, `max_dist` where either mask is empty (the
    reference training loop's metric)."""
    out = []
    for p, t in zip(np.asarray(pred), np.asarray(target)):
        out.append(float(max_dist) if p.sum() == 0 or t.sum() == 0 else hd95(p, t))
    return out


def largest_connected_component(segmentation: np.ndarray) -> np.ndarray:
    """Keep only the largest 26-connected foreground component; identity
    on empty masks (the test-time 'nms' post-processing)."""
    seg = np.asarray(segmentation) > 0
    structure = np.ones((3,) * seg.ndim, dtype=bool)
    labels, n = ndimage.label(seg, structure=structure)
    if n == 0:
        return segmentation
    counts = np.bincount(labels.ravel())[1:]
    return labels == (int(np.argmax(counts)) + 1)
