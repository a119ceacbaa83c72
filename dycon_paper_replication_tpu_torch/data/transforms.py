"""Numpy volume transforms over {'image', 'label'} sample dicts, each drawing
from an explicit `numpy.random.Generator`.

Counterpart of dycon_paper_replication_tpu/data/transforms.py (`Compose`,
`SagittalToAxial`, `CenterCrop`, `RandomCrop`, `RandomRotFlip`,
`RandomNoise`, `Resize`, `CreateOnehotLabel`, `ToArray`), drawing the same
numbers in the same order, so one seed gives the same samples. `ToArray`
gives the image as (D1, D2, D3, 1) float32, channels-last, the label as
(D1, D2, D3) int32, and a one-hot label, where CreateOnehotLabel made one,
as (C, D1, D2, D3) int64.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np


class Compose:
    def __init__(self, transforms: Sequence[Callable]):
        self.transforms = list(transforms)

    def __call__(self, sample: dict, rng: np.random.Generator) -> dict:
        for t in self.transforms:
            sample = t(sample, rng)
        return sample


class SagittalToAxial:
    """Transpose (H, W, D) -> (D, W, H), the BraTS volumes' axial view."""

    def __call__(self, sample: dict, rng: np.random.Generator) -> dict:
        image, label = sample["image"], sample["label"]
        if image.shape != label.shape:
            raise ValueError("image/label shape mismatch")
        return {"image": np.transpose(image, (2, 1, 0)), "label": np.transpose(label, (2, 1, 0))}


def _pad_margin(shape, output_size) -> tuple[bool, list[int]]:
    """Pad widths when the volume is not strictly larger than the crop on
    some axis: half the deficit plus 3 voxels per side."""
    needs = any(s <= o for s, o in zip(shape, output_size))
    return needs, [max((o - s) // 2 + 3, 0) if needs else 0 for s, o in zip(shape, output_size)]


class CenterCrop:
    """The centre crop to `output_size` (padded with a margin first when the
    volume is small)."""

    def __init__(self, output_size):
        self.output_size = tuple(output_size)

    def __call__(self, sample: dict, rng: np.random.Generator) -> dict:
        image, label = sample["image"], sample["label"]
        needs, pads = _pad_margin(label.shape, self.output_size)
        if needs:
            pw = [(p, p) for p in pads]
            image = np.pad(image, pw, mode="constant")
            label = np.pad(label, pw, mode="constant")
        starts = [int(round((s - o) / 2.0)) for s, o in zip(image.shape, self.output_size)]
        sl = tuple(slice(st, st + o) for st, o in zip(starts, self.output_size))
        return {"image": image[sl], "label": label[sl]}


class RandomCrop:
    """Uniform random crop to `output_size` (padded with a margin first when
    the volume is small)."""

    def __init__(self, output_size):
        self.output_size = tuple(output_size)

    def origin(self, shape, rng: np.random.Generator) -> list[int]:
        return [int(rng.integers(0, s - o)) if s > o else 0
                for s, o in zip(shape, self.output_size)]

    def __call__(self, sample: dict, rng: np.random.Generator) -> dict:
        image, label = sample["image"], sample["label"]
        needs, pads = _pad_margin(label.shape, self.output_size)
        if needs:
            pw = [(p, p) for p in pads]
            image = np.pad(image, pw, mode="constant")
            label = np.pad(label, pw, mode="constant")
        starts = self.origin(image.shape, rng)
        sl = tuple(slice(st, st + o) for st, o in zip(starts, self.output_size))
        return {"image": image[sl], "label": label[sl]}


class RandomRotFlip:
    """A k * 90 degree rotation in the first two axes, then a flip along
    axis 0 or 1 (always applied). Returns views; ToArray copies once."""

    def __call__(self, sample: dict, rng: np.random.Generator) -> dict:
        image, label = sample["image"], sample["label"]
        k = int(rng.integers(0, 4))
        image, label = np.rot90(image, k), np.rot90(label, k)
        axis = int(rng.integers(0, 2))
        return {"image": np.flip(image, axis=axis), "label": np.flip(label, axis=axis)}


class RandomNoise:
    """Additive Gaussian noise, sigma N(0, 1) clipped to +-2 sigma, plus mu."""

    def __init__(self, mu: float = 0.0, sigma: float = 0.1):
        self.mu = mu
        self.sigma = sigma

    def __call__(self, sample: dict, rng: np.random.Generator) -> dict:
        image, label = sample["image"], sample["label"]
        noise = np.clip(self.sigma * rng.standard_normal(image.shape), -2 * self.sigma,
                        2 * self.sigma)
        return {"image": image + noise + self.mu, "label": label}


class Resize:
    """Resize to a fixed grid: the image trilinear (zero outside), the
    label nearest."""

    def __init__(self, output_size):
        self.output_size = tuple(output_size)

    def __call__(self, sample: dict, rng: np.random.Generator) -> dict:
        from scipy import ndimage

        image, label = sample["image"], sample["label"]
        zoom = [o / s for o, s in zip(self.output_size, image.shape)]
        return {"image": ndimage.zoom(image, zoom, order=1, mode="constant", cval=0.0),
                "label": ndimage.zoom(label.astype(np.uint8), zoom, order=0)}


class CreateOnehotLabel:
    """Adds `onehot_label`, (num_classes, D1, D2, D3) float32."""

    def __init__(self, num_classes: int):
        self.num_classes = num_classes

    def __call__(self, sample: dict, rng: np.random.Generator) -> dict:
        label = sample["label"]
        onehot = np.stack([(label == i).astype(np.float32) for i in range(self.num_classes)],
                          axis=0)
        return {**sample, "onehot_label": onehot}


class ToArray:
    """image -> (D1, D2, D3, 1) float32, label -> (D1, D2, D3) int32, and a
    one-hot label, if any, -> int64."""

    def __call__(self, sample: dict, rng: np.random.Generator) -> dict:
        out = {"image": np.ascontiguousarray(sample["image"], dtype=np.float32)[..., None],
               "label": np.ascontiguousarray(sample["label"], dtype=np.int32)}
        if "onehot_label" in sample:
            out["onehot_label"] = sample["onehot_label"].astype(np.int64)
        return out
