"""Deterministic synthetic BraTS-, Pancreas- and ISLES-format dataset trees.

Counterpart of dycon_paper_replication_tpu/data/synthetic.py, the same
arrays from the same seed: a tree {root}/{train,test,val}.txt + data/<case>
for BraTS, {root}/{train,test,test1}.list + Pancreas_data/<case>, or
{root}/{train,val}.list + <case> for ISLES, each case an `image` float32
volume with a random ellipsoid "lesion" in its label array (`label`, or
ISLES' float64 `mask`); and `make_hard_pancreas`, a Pancreas tree of the
hard task of the SSL ablation (`_hard_volume`). Cases are .h5 files, as the
datasets ship, or numpy .npz archives of the same arrays, which need no
h5py (`suffix=".npz"`, `write_case`).
"""

from __future__ import annotations

import os

import numpy as np
from scipy import ndimage


def _ellipsoid_volume(rng: np.random.Generator, shape) -> tuple[np.ndarray, np.ndarray]:
    zz, yy, xx = np.meshgrid(*[np.arange(s, dtype=np.float32) for s in shape], indexing="ij")
    center = [rng.uniform(0.3 * s, 0.7 * s) for s in shape]
    radii = [rng.uniform(0.1 * s, 0.25 * s) for s in shape]
    d = (
        ((zz - center[0]) / radii[0]) ** 2
        + ((yy - center[1]) / radii[1]) ** 2
        + ((xx - center[2]) / radii[2]) ** 2
    )
    label = (d <= 1.0).astype(np.uint8)
    image = 0.4 * label + 0.1 * rng.standard_normal(shape).astype(np.float32)
    image = (image - image.min()) / (image.max() - image.min() + 1e-8)
    return image.astype(np.float32), label


def _smooth_field(rng: np.random.Generator, shape, sigma: float) -> np.ndarray:
    """Unit-variance low-frequency field: Gaussian-filtered white noise."""
    f = ndimage.gaussian_filter(rng.standard_normal(shape).astype(np.float32), sigma)
    return f / (f.std() + 1e-8)


def _hard_volume(rng: np.random.Generator, shape) -> tuple[np.ndarray, np.ndarray]:
    """One volume of the hard task, built so that a few labeled volumes
    underdetermine the decision rule while the unlabeled ones still carry
    it:
      * the lesions (label 1) are 1-3 warped, filled, low-contrast blobs
        (contrast ~ N(0.14, 0.03) against noise of sigma 0.12);
      * 2-4 distractor shells of the same intensity are hollow, so telling
        them apart takes shape context, not an intensity threshold;
      * each case has its own multiplicative bias field and contrast.
    """
    zz, yy, xx = np.meshgrid(*[np.arange(s, dtype=np.float32) for s in shape], indexing="ij")
    # one smooth warp makes both lesions and shells irregular
    warp = [8.0 * _smooth_field(rng, shape, sigma=8.0) for _ in range(3)]
    wz, wy, wx = zz + warp[0], yy + warp[1], xx + warp[2]

    def blob_d2(center, radii):
        return (((wz - center[0]) / radii[0]) ** 2 + ((wy - center[1]) / radii[1]) ** 2
                + ((wx - center[2]) / radii[2]) ** 2)

    label = np.zeros(shape, np.uint8)
    body = np.zeros(shape, np.float32)
    for _ in range(rng.integers(1, 4)):  # filled blobs: the foreground
        center = [rng.uniform(0.25 * s, 0.75 * s) for s in shape]
        radii = [rng.uniform(0.08 * s, 0.16 * s) for s in shape]
        d2 = blob_d2(center, radii)
        label |= d2 <= 1.0
        body += np.clip(1.2 - d2, 0.0, 1.0)
    for _ in range(rng.integers(2, 5)):  # hollow shells: the distractors
        center = [rng.uniform(0.2 * s, 0.8 * s) for s in shape]
        radii = [rng.uniform(0.09 * s, 0.18 * s) for s in shape]
        d2 = blob_d2(center, radii)
        body += np.clip(1.2 - d2, 0.0, 1.0) * np.clip((d2 - 0.45) / 0.2, 0.0, 1.0)
    contrast = rng.normal(0.14, 0.03)
    tissue = 0.5 + 0.08 * _smooth_field(rng, shape, sigma=12.0)
    image = tissue + contrast * np.clip(body, 0.0, 1.0)
    image *= 1.0 + 0.25 * _smooth_field(rng, shape, sigma=16.0)  # bias field
    image += 0.12 * rng.standard_normal(shape).astype(np.float32)
    image = (image - image.min()) / (image.max() - image.min() + 1e-8)
    return image.astype(np.float32), label.astype(np.uint8)


def write_case(path: str, image: np.ndarray, label: np.ndarray,
               label_key: str = "label") -> None:
    """One case file: .npz with numpy, anything else as .h5 with h5py."""
    if path.endswith(".npz"):
        np.savez(path, image=image, **{label_key: label})
        return
    import h5py

    with h5py.File(path, "w") as f:
        f.create_dataset("image", data=image)
        f.create_dataset(label_key, data=label)


def make_brats19(root: str, n_train: int = 8, n_test: int = 3, shape=(64, 64, 48), seed: int = 0,
                 suffix: str = ".h5") -> dict[str, list[str]]:
    """BraTS-like tree: {root}/{train,test,val}.txt (val = test) of case
    names + data/<name><suffix>, the same volumes for either suffix, stored
    in the sagittal view (BraTS2019 reads them axial)."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "data"), exist_ok=True)
    names = {"train": [f"case_{i:03d}" for i in range(n_train)],
             "test": [f"case_t{i:03d}" for i in range(n_test)]}
    names["val"] = names["test"]
    for split in ("train", "test", "val"):
        with open(os.path.join(root, f"{split}.txt"), "w") as f:
            f.write("\n".join(names[split]) + "\n")
    for name in names["train"] + names["test"]:
        image, label = _ellipsoid_volume(rng, shape)
        write_case(os.path.join(root, "data", name + suffix), image, label)
    return names


def make_pancreas(root: str, n_train: int = 8, n_test: int = 3, shape=(72, 72, 56),
                  seed: int = 1, suffix: str = ".h5"):
    """Pancreas-like tree: {root}/{train,test,test1}.list + Pancreas_data/,
    cases written as `suffix` (".h5", or ".npz", which needs no h5py), the
    same volumes either way."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "Pancreas_data"), exist_ok=True)
    train = [f"PANCREAS_{i:04d}{suffix}" for i in range(n_train)]
    test = [f"PANCREAS_t{i:04d}{suffix}" for i in range(n_test)]
    for fname, items in (("train.list", train), ("test.list", test), ("test1.list", test)):
        with open(os.path.join(root, fname), "w") as f:
            f.write("\n".join(items) + "\n")
    for name in train + test:
        image, label = _ellipsoid_volume(rng, shape)
        write_case(os.path.join(root, "Pancreas_data", name), image, label)
    return train, test


def make_hard_pancreas(root: str, n_train: int = 40, n_test: int = 8, shape=(96, 96, 64),
                       seed: int = 7, suffix: str = ".h5"):
    """Pancreas-like tree of the hard task (`_hard_volume`), which the
    Pancreas trainer and test CLI read unchanged: the SSL ablation's data
    (scripts/ssl_ablation_torch.py). Cases written as `suffix`, the same
    volumes either way."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "Pancreas_data"), exist_ok=True)
    train = [f"PANCREAS_{i:04d}{suffix}" for i in range(n_train)]
    test = [f"PANCREAS_t{i:04d}{suffix}" for i in range(n_test)]
    for fname, items in (("train.list", train), ("test.list", test), ("test1.list", test)):
        with open(os.path.join(root, fname), "w") as f:
            f.write("\n".join(items) + "\n")
    for name in train + test:
        image, label = _hard_volume(rng, shape)
        write_case(os.path.join(root, "Pancreas_data", name), image, label)
    return train, test


def make_isles22(root: str, n_train: int = 8, n_val: int = 3, shape=(64, 64, 48), seed: int = 2,
                 suffix: str = ".h5"):
    """ISLES-like tree: {root}/{train,val}.list of case ids + <id><suffix>
    with `image` and a float64 `mask`, the same volumes for either suffix."""
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    train = [f"sub-strokecase{i:04d}" for i in range(n_train)]
    val = [f"sub-strokecase9{i:03d}" for i in range(n_val)]
    for fname, items in (("train.list", train), ("val.list", val)):
        with open(os.path.join(root, fname), "w") as f:
            f.write("\n".join(items) + "\n")
    for name in train + val:
        image, label = _ellipsoid_volume(rng, shape)
        write_case(os.path.join(root, name + suffix), image, label.astype(np.float64), "mask")
    return train, val
