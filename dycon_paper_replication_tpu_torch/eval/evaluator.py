"""Validation and test loops over the sliding-window engine, and the
ISLES whole-volume protocol.

Counterpart of dycon_paper_replication_tpu/eval/evaluator.py:
  var_all_case  - Dice-only validation;
  test_all_case - the per-case (Dice, Jaccard, HD95, ASD) table with the
                  optional largest-connected-component step and a
                  performance.txt artifact;
  WholeVolumeInference - one forward of the whole padded volume;
  var_all_case_wholevolume, test_all_case_wholevolume - the ISLES
                  validation (soft Dice) and test (Dice, HD95, ASD,
                  sensitivity, specificity with the empty-mask rules).
"""

from __future__ import annotations

import os
from typing import Iterable, Iterator

import numpy as np
import torch

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


class WholeVolumeInference:
    """Single-forward whole-volume prediction (the ISLES protocol).

    The volume is padded symmetrically to the patch size where it is smaller
    (the ISLES trainer's floor + 1 on each side), then at the far end up to a
    multiple of 16 for the U-Net's pooling; one forward of the model (eval
    mode, on its device, no projection head) gives the argmax of output
    `head`, cut back to the volume: "sdf" (output 0, the tanh SDF head, which
    the reference's in-training ISLES validation argmaxes) or "seg" (output
    1, the segmentation logits, the offline test's). The padded volume goes
    to the device as float32 (the JAX package sends float16 over its host
    link; the port has no wire dtype, config.py). `map` takes volume groups
    of 1 only: batching several volumes per forward is not ported."""

    def __init__(self, model, patch_size: tuple[int, int, int], head: str = "seg"):
        if head not in ("sdf", "seg"):
            raise ValueError(f"head must be 'sdf' or 'seg', got {head!r}")
        self.model = model
        self.patch = tuple(patch_size)
        self.head = head
        self.device = next(model.parameters()).device

    def _pad(self, image: np.ndarray) -> tuple[np.ndarray, tuple[slice, ...]]:
        """(the padded float32 volume, the slices of the original in it)."""
        pads = [(p - s) // 2 + 1 if s < p else 0 for s, p in zip(image.shape, self.patch)]
        padded = np.pad(image, [(e, e) for e in pads])
        padded = np.pad(padded, [(0, max(-(-s // 16) * 16, 16) - s) for s in padded.shape])
        return padded, tuple(slice(e, e + s) for e, s in zip(pads, image.shape))

    @torch.inference_mode()
    def predict(self, image: np.ndarray) -> np.ndarray:
        """The (D1, D2, D3) uint8 label map of one volume."""
        padded, sl = self._pad(np.asarray(image, np.float32))
        x = torch.from_numpy(padded)[None, ..., None].to(self.device)
        outputs = self.model(x, with_projection=False)
        pred = outputs[0 if self.head == "sdf" else 1].argmax(dim=-1).to(torch.uint8)
        return pred[0].cpu().numpy()[sl]

    def map(self, volumes: Iterable[tuple[np.ndarray, np.ndarray]],
            group: int = 1) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        """(prediction, label) per (image, label) volume, in input order."""
        if group != 1:
            raise ValueError(f"volume groups larger than 1 are not ported, got {group}")
        for image, label in volumes:
            yield self.predict(image), label

    __call__ = predict


def var_all_case_wholevolume(wv: WholeVolumeInference,
                             volumes: Iterable[tuple[np.ndarray, np.ndarray]]) -> float:
    """ISLES in-training validation: the mean soft Dice (smooth 1) of
    prediction == 1 against label == 1."""
    total, n = 0.0, 0
    for pred, label in wv.map(volumes):
        p = (pred == 1).astype(np.float64)
        t = (label == 1).astype(np.float64)
        total += (2.0 * (p * t).sum() + 1.0) / (p.sum() + t.sum() + 1.0)
        n += 1
    return total / max(n, 1)


_ISLES_KEYS = ("dice", "hd95", "asd", "sensitivity", "specificity")


def isles_case_metrics(pred: np.ndarray, label: np.ndarray) -> dict:
    """One ISLES test case with the reference's empty-mask rules: both masks
    empty -> perfect scores; exactly one empty -> Dice 0 and HD95 = ASD =
    the volume's diagonal, sensitivity 0 and specificity 1, or 0 when only
    the label is empty and the prediction is not."""
    p, t = pred == 1, label == 1
    if p.sum() == 0 and t.sum() == 0:
        return dict(dice=1.0, hd95=0.0, asd=0.0, sensitivity=1.0, specificity=1.0)
    if p.sum() == 0 or t.sum() == 0:
        max_dist = float(np.linalg.norm(label.shape))
        spec = (1.0 if p.sum() == 0 else 0.0) if t.sum() == 0 else 1.0
        return dict(dice=0.0, hd95=max_dist, asd=max_dist, sensitivity=0.0, specificity=spec)
    return dict(dice=metrics.dice(p, t), hd95=metrics.hd95(p, t), asd=metrics.asd(p, t),
                sensitivity=metrics.sensitivity(p, t), specificity=metrics.specificity(p, t))


def test_all_case_wholevolume(wv: WholeVolumeInference,
                              volumes: Iterable[tuple[np.ndarray, np.ndarray]], *,
                              results_path: str | None = None) -> dict:
    """ISLES offline test: the per-metric mean and std over the volumes and
    the per-case rows (`cases`); with `results_path`, the results file."""
    rows = [isles_case_metrics(pred, label) for pred, label in wv.map(volumes)]
    summary = {k: float(np.mean([r[k] for r in rows])) for k in _ISLES_KEYS}
    summary.update({f"{k}_std": float(np.std([r[k] for r in rows])) for k in _ISLES_KEYS})
    summary["cases"] = rows
    if results_path is not None:
        with open(results_path, "w") as f:
            f.write("ISLES22 Test Results\n" + "=" * 60 + "\n")
            for k in _ISLES_KEYS:
                f.write(f"{k.upper():12s} | Mean: {summary[k]:.4f} | Std: "
                        f"{summary[f'{k}_std']:.4f}\n")
            f.write("\nPer-sample results:\n" + "-" * 60 + "\n")
            for i, r in enumerate(rows):
                f.write(f"Sample {i:3d} | " + " | ".join(f"{k}: {r[k]:.4f}" for k in _ISLES_KEYS)
                        + "\n")
    return summary
