"""Volume datasets of {'image', 'label'} cases: the Pancreas-CT and the
ISLES-2022 splits.

Counterpart of `H5VolumeDataset`, `Pancreas` and `ISLESDataset` in
dycon_paper_replication_tpu/data/datasets.py. A case is an `.h5` file (read
with h5py, imported only then) or an `.npz` archive of the same arrays
(numpy alone), chosen by the file's extension. With `crop_size`, the crop
origin is drawn from the stored shape exactly as RandomCrop draws it, and an
.h5 case reads only that window; an .npz case is read whole and then cut,
which gives the same sample. BraTS is not ported yet.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np

from .transforms import Compose, RandomCrop, _pad_margin


def _read_list(path: str) -> list[str]:
    with open(path) as f:
        return [line.strip().split(",")[0] for line in f if line.strip()]


class VolumeDataset:
    """A list of case files holding `image` and `label` volumes of one
    spatial shape."""

    label_key = "label"

    def __init__(self, paths: Sequence[str], transform: Compose | None = None,
                 crop_size: tuple[int, int, int] | None = None):
        self.paths = list(paths)
        self.transform = transform
        self.crop_size = tuple(crop_size) if crop_size is not None else None
        self._shapes: dict[int, tuple[int, ...]] = {}

    def __len__(self) -> int:
        return len(self.paths)

    def shape(self, idx: int) -> tuple[int, ...]:
        if idx not in self._shapes:
            path = self.paths[idx]
            if path.endswith(".npz"):
                with np.load(path) as f:
                    self._shapes[idx] = tuple(f["image"].shape)
            else:
                import h5py

                with h5py.File(path, "r") as f:
                    self._shapes[idx] = tuple(f["image"].shape)
        return self._shapes[idx]

    def _read(self, idx: int, window: tuple[slice, ...] | None = None) -> dict:
        path = self.paths[idx]
        window = window if window is not None else (slice(None),) * 3
        if path.endswith(".npz"):
            with np.load(path) as f:
                image, label = f["image"][window], f[self.label_key][window]
        else:
            import h5py

            with h5py.File(path, "r") as f:
                image, label = f["image"][window], f[self.label_key][window]
        return {"image": np.asarray(image, np.float32), "label": np.asarray(label, np.uint8)}

    def get(self, idx: int, rng: np.random.Generator) -> dict:
        crop = self.crop_size
        if crop is None:
            sample = self._read(idx)
        elif not _pad_margin(self.shape(idx), crop)[0]:
            starts = RandomCrop(crop).origin(self.shape(idx), rng)
            sample = self._read(idx, tuple(slice(s, s + o) for s, o in zip(starts, crop)))
        else:  # a small volume: read whole, pad with the margin, crop
            sample = RandomCrop(crop)(self._read(idx), rng)
        if self.transform is not None:
            sample = self.transform(sample, rng)
        return sample


class Pancreas(VolumeDataset):
    """Pancreas-CT: <base_dir>/{train,test}.list naming Pancreas_data/ cases."""

    def __init__(self, base_dir: str, split: str = "train", num: int | None = None,
                 transform: Compose | None = None, crop_size=None):
        names = _read_list(os.path.join(base_dir, "train.list" if split == "train"
                                        else "test.list"))
        if num is not None:
            names = names[:num]
        paths = [os.path.join(base_dir, "Pancreas_data", n) for n in names]
        super().__init__(paths, transform, crop_size)


class ISLESDataset(VolumeDataset):
    """ISLES-2022 DWI stroke volumes: <h5_dir>/{split}.list of case ids, each
    case <h5_dir>/<id>.h5 or, where that is missing, <id>.npz, with the
    arrays `image` and `mask`. Cases with neither file are left out and
    listed in `missing` (as .h5 paths, the JAX dataset's)."""

    label_key = "mask"

    def __init__(self, h5_dir: str, split: str = "train", transform: Compose | None = None,
                 crop_size=None):
        list_file = os.path.join(h5_dir, f"{split}.list")
        if not os.path.exists(list_file):
            raise FileNotFoundError(f"List file {list_file} not found.")
        paths, self.missing = [], []
        for name in _read_list(list_file):
            h5, npz = (os.path.join(h5_dir, name + ext) for ext in (".h5", ".npz"))
            if os.path.exists(h5) or os.path.exists(npz):
                paths.append(h5 if os.path.exists(h5) else npz)
            else:
                self.missing.append(h5)
        super().__init__(paths, transform, crop_size)
