"""Deterministic synthetic Pancreas- and ISLES-format dataset trees.

Counterpart of `_ellipsoid_volume`, `make_pancreas` and `make_isles22` in
dycon_paper_replication_tpu/data/synthetic.py: a tree
{root}/{train,test,test1}.list + Pancreas_data/<case>, or
{root}/{train,val}.list + <case> for ISLES, each case an `image` float32
volume with a random ellipsoid "lesion" in its label array (`label`, or
ISLES' float64 `mask`). Cases are .h5 files, as the datasets ship, or numpy
.npz archives of the same arrays, which need no h5py (`suffix=".npz"`,
`write_case`).
"""

from __future__ import annotations

import os

import numpy as np


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
