"""Validation and test loops over the sliding-window engine, and the
ISLES whole-volume protocol.

Counterpart of dycon_paper_replication_tpu/eval/evaluator.py:
  var_all_case  - Dice-only validation;
  test_all_case - the per-case (Dice, Jaccard, HD95, ASD) table with the
                  optional largest-connected-component step and a
                  performance.txt artifact;
  WholeVolumeInference - one forward of the whole padded volume, volume
                  groups stacked into one forward;
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
from .sliding_window import (Pending, SlidingWindowInference, fetch_async, pipelined, replicate,
                             stage)


# The auto volume group (`--group 0`) on CUDA, the best group size measured
# on the card (NVIDIA H100 80GB HBM3, 700 W; PERF.md), per engine and
# use; 1 on the CPU. scripts/measure_group_eval.py, 8 volumes:
#   sliding window, "test" (test_pancreas, test_brats19): their host work
#     (largest component, HD95, ASD: ~1.7 s a (192, 192, 64) volume) bounds
#     them, 0.566 / 0.573 / 0.524 / 0.485 vols/s at groups 1 / 2 / 4 / 8
#     (float32, depth 1; bf16 0.629 / 0.567 / 0.551 / 0.519): a group's first
#     result waits for the whole group;
#   sliding window, "validation" (the trainer's, Dice only): the engine's
#     1.973 / 2.051 / 2.077 / 2.083 vols/s (bf16 3.835 / 3.952 / 3.989 /
#     3.928);
#   whole volume, "test" (test_isles22): 2.249 / 2.498 / 2.086 vols/s at
#     groups 1 / 2 / 4 with its metrics; "validation" (the ISLES trainer's,
#     soft Dice only; chip_smoke phase group_eval, 8 volumes of (112, 112,
#     73), six runs): medians 47.12 / 63.99 / 67.69 vols/s, group 4 ahead of
#     group 2 in five of the six.
AUTO_GROUP = {"sliding_window": {"test": 1, "validation": 8},
              "whole_volume": {"test": 2, "validation": 4}}


def auto_group(device, engine: str, use: str) -> int:
    """The auto group size of `engine` ("sliding_window" or "whole_volume")
    for `use` ("test" or "validation") on `device`."""
    return AUTO_GROUP[engine][use] if torch.device(device).type == "cuda" else 1


def iter_h5_volumes(paths: Iterable[str], label_key: str = "label",
                    axial_transpose: bool = False) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """Yield (image, label uint8) pairs from .h5 files. `axial_transpose`
    applies the BraTS (2, 1, 0) view change to both."""
    import h5py

    for path in paths:
        with h5py.File(path, "r") as f:
            image, label = f["image"][:], f[label_key][:].astype(np.uint8)
        if axial_transpose:
            image, label = np.transpose(image, (2, 1, 0)), np.transpose(label, (2, 1, 0))
        yield image, label


def iter_volumes(paths: Iterable[str], label_key: str = "label", axial_transpose: bool = False):
    """Yield (image, label uint8) pairs from .h5 or .npz files (an .npz holds
    the same `image` and label arrays, and needs no h5py), transposed
    (2, 1, 0) with `axial_transpose`."""
    for path in paths:
        if not path.endswith(".npz"):
            yield from iter_h5_volumes([path], label_key, axial_transpose)
            continue
        with np.load(path) as f:
            image, label = f["image"], f[label_key].astype(np.uint8)
        if axial_transpose:
            image, label = np.transpose(image, (2, 1, 0)), np.transpose(label, (2, 1, 0))
        yield image, label


def var_all_case(sw: SlidingWindowInference,
                 volumes: Iterable[tuple[np.ndarray, np.ndarray]], *, group: int = 1) -> float:
    """Mean Dice over the validation volumes (0 for empty predictions);
    `group` same-shape volumes per dispatch (SlidingWindowInference.map)."""
    total, n = 0.0, 0
    for pred, _, label in sw.map(volumes, group=group):
        total += metrics.dice(pred, label) if pred.sum() > 0 else 0.0
        n += 1
    return total / max(n, 1)


def test_all_case(sw: SlidingWindowInference,
                  volumes: Iterable[tuple[np.ndarray, np.ndarray]], *, nms: bool = False,
                  metric_detail: bool = False, test_save_path: str | None = None,
                  group: int = 1) -> np.ndarray:
    """Average (dice, jaccard, hd95, asd) over the test volumes."""
    total = np.zeros(4)
    n = 0
    if metric_detail:
        print(f"{'ID':<3} | {'Dice':<8} | {'Jaccard':<8} | {'HD95':<8} | {'ASD':<8}")
        print("-" * 45)
    for pred, _, label in sw.map(volumes, group=group):
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
    to the device as float32 with a float32 model (the JAX package sends
    float16 over its host link; the port has no wire dtype, config.py) and
    as float16 with a bfloat16 model, whose values then match the JAX
    package's bfloat16 path: its image is rounded through float16, and half
    the bytes cross.

    `map(volumes, group=V, depth=D)` stacks up to V consecutive volumes of
    one padded shape into one forward (exact: InstanceNorm is per-sample
    and the projection head is skipped; a shape change or the tail flushes
    a smaller batch) and keeps up to D dispatches per device ahead of the
    consumer, on sliding_window.py's dispatch thread with the predictions
    copied to pinned host memory behind an event. With `devices`, the
    groups go round-robin to one replica of the model per device (the JAX
    engine's volume-level data parallelism); results come back in input
    order either way."""

    def __init__(self, model, patch_size: tuple[int, int, int], head: str = "seg",
                 devices: list | None = None):
        if head not in ("sdf", "seg"):
            raise ValueError(f"head must be 'sdf' or 'seg', got {head!r}")
        self.model = model
        self.patch = tuple(patch_size)
        self.head = head
        self.device = next(model.parameters()).device
        self.devices = [torch.device(d) for d in devices] if devices else [self.device]
        self._replicas: list | None = None
        self.transfer_dtype = (np.float16 if model.cfg.compute_dtype == torch.bfloat16
                               else np.float32)

    def _pad(self, image: np.ndarray) -> tuple[np.ndarray, tuple[slice, ...]]:
        """(the padded volume, the slices of the original in it)."""
        pads = [(p - s) // 2 + 1 if s < p else 0 for s, p in zip(image.shape, self.patch)]
        padded = np.pad(image, [(e, e) for e in pads])
        padded = np.pad(padded, [(0, max(-(-s // 16) * 16, 16) - s) for s in padded.shape])
        return padded, tuple(slice(e, e + s) for e, s in zip(pads, image.shape))

    def _dispatch(self, staged: list, slot: int, models: list) -> Pending:
        """Enqueue one forward of the (padded, slices, label) items of
        `staged` (one padded shape) on replica `slot`, and the copy of its
        uint8 predictions to the host."""
        device = self.devices[slot]
        x = stage([w for w, _, _ in staged], self.transfer_dtype, device)
        outputs = models[slot](x.to(torch.float32)[..., None], with_projection=False)
        pred = outputs[0 if self.head == "sdf" else 1].argmax(dim=-1).to(torch.uint8)
        return Pending(fetch_async(pred), [(sl, label) for _, sl, label in staged], False)

    @staticmethod
    def _finish(entry: Pending):
        preds = entry.fetch.wait()[0]
        for i, (sl, label) in enumerate(entry.rests):
            yield preds[i][sl].copy(), label

    def predict(self, image: np.ndarray) -> np.ndarray:
        """The (D1, D2, D3) uint8 label map of one volume."""
        padded, sl = self._pad(np.asarray(image, self.transfer_dtype))
        with torch.inference_mode():
            entry = self._dispatch([(padded, sl, None)], 0, replicate(self))
        return next(self._finish(entry))[0]

    def map(self, volumes: Iterable[tuple[np.ndarray, np.ndarray]], group: int = 1,
            depth: int = 2) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        """(prediction, label) per (image, label) volume, in input order."""
        group, depth = max(1, int(group)), max(1, int(depth))
        models = replicate(self)

        def dispatches():
            buf: list = []
            n = 0
            for image, label in volumes:
                padded, sl = self._pad(np.asarray(image, self.transfer_dtype))
                if buf and padded.shape != buf[0][0].shape:
                    yield self._dispatch(buf, n % len(models), models)
                    buf, n = [], n + 1
                buf.append((padded, sl, label))
                if len(buf) == group:
                    yield self._dispatch(buf, n % len(models), models)
                    buf, n = [], n + 1
            if buf:
                yield self._dispatch(buf, n % len(models), models)

        for entry in pipelined(dispatches(), depth * len(models)):
            yield from self._finish(entry)

    __call__ = predict


def var_all_case_wholevolume(wv: WholeVolumeInference,
                             volumes: Iterable[tuple[np.ndarray, np.ndarray]], *,
                             group: int = 1) -> float:
    """ISLES in-training validation: the mean soft Dice (smooth 1) of
    prediction == 1 against label == 1."""
    total, n = 0.0, 0
    for pred, label in wv.map(volumes, group=group):
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
                              results_path: str | None = None, group: int = 1) -> dict:
    """ISLES offline test: the per-metric mean and std over the volumes and
    the per-case rows (`cases`); with `results_path`, the results file."""
    rows = [isles_case_metrics(pred, label) for pred, label in wv.map(volumes, group=group)]
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
