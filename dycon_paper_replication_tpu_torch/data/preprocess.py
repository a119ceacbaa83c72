"""NIfTI -> case-file preprocessing (BraTS-2019 and ISLES-2022).

Counterpart of dycon_paper_replication_tpu/data/preprocess.py, with the same
steps, file names, target shapes and seed-42 split (the reference's
BraTS19_DataPreprocessing.py and ISLES22_DataPreprocessing.py):
  * BraTS: one modality by preference T2 > FLAIR > T1ce > T1, z-score over
    nonzero voxels then min-max to [0, 1], the whole tumour (seg > 0) as the
    label, both resampled to (192, 192, 64) (linear image, nearest label);
  * ISLES: the BIDS layout, DWI preferred (ADC, then FLAIR), the mask from
    derivatives/, resampled to (112, 112, 64), and an 80/20 train/val split
    (numpy RandomState(42)) into train.list / val.list.
NIfTI is read by the port's own numpy reader (data/nifti.py); resampling is
scipy.ndimage.zoom.

Output format (`fmt`, the CLIs' --format): "h5", the JAX package's (gzip
datasets `image` and `label` / `mask`, the attribute case_name), which needs
h5py and fails loudly without it; or "npz", an .npz of the same arrays
(np.savez_compressed; case_name as a 0-d string array), which the port's
datasets and evaluators read with numpy alone (data/datasets.py), on a
machine without h5py. Never the one in place of the other.
"""

from __future__ import annotations

import os

import numpy as np
from scipy.ndimage import zoom

from . import nifti

BRATS_TARGET_SHAPE = (192, 192, 64)
ISLES_TARGET_SHAPE = (112, 112, 64)
FORMATS = ("h5", "npz")


def normalize_image(image: np.ndarray) -> np.ndarray:
    """Per-volume z-score over nonzero voxels, then min-max to [0, 1]."""
    image = image.astype(np.float32)
    if np.all(image == 0):
        return image
    nonzero = image > 0
    if np.any(nonzero):
        mean = image[nonzero].mean()
        std = image[nonzero].std()
        if std > 0:
            image = np.where(nonzero, (image - mean) / std, 0)
    lo, hi = image.min(), image.max()
    if hi > lo:
        image = (image - lo) / (hi - lo)
    return image


def resample(image: np.ndarray, label: np.ndarray, target_shape) -> tuple[np.ndarray, np.ndarray]:
    """Zoom to the target shape (linear image, nearest label), then crop or
    zero-pad any residual off-by-one of zoom's rounding; the label binary."""
    factors = [t / s for t, s in zip(target_shape, image.shape)]
    image_r = _fit_exact(zoom(image, factors, order=1).astype(np.float32), target_shape)
    label_r = _fit_exact(zoom(label, factors, order=0), target_shape)
    return image_r, (label_r > 0.5).astype(np.uint8)


def _fit_exact(data: np.ndarray, target_shape) -> np.ndarray:
    if data.shape == tuple(target_shape):
        return data
    out = np.zeros(target_shape, dtype=data.dtype)
    src = tuple(slice(0, min(s, t)) for s, t in zip(data.shape, target_shape))
    out[src] = data[src]
    return out


def check_format(fmt: str) -> None:
    """Raise unless `fmt` can be written here: "npz" always, "h5" with h5py."""
    if fmt not in FORMATS:
        raise ValueError(f"format must be one of {FORMATS}, got {fmt!r}")
    if fmt == "h5":
        try:
            import h5py  # noqa: F401
        except ImportError as exc:
            raise RuntimeError("--format h5 needs h5py, which is not installed; "
                               "--format npz writes the same arrays with numpy") from exc


def write_case(output_dir: str, case_name: str, arrays: dict[str, np.ndarray],
               fmt: str = "h5") -> str:
    """<output_dir>/<case_name>.h5 or .npz holding `arrays`; returns the path."""
    check_format(fmt)
    os.makedirs(output_dir, exist_ok=True)
    path = os.path.join(output_dir, f"{case_name}.{fmt}")
    if fmt == "npz":
        np.savez_compressed(path, **arrays, case_name=np.array(case_name))
        return path
    import h5py

    with h5py.File(path, "w") as f:
        for key, value in arrays.items():
            f.create_dataset(key, data=value, compression="gzip")
        f.attrs["case_name"] = case_name
    return path


# ------------------------------ BraTS-2019 ------------------------------

_BRATS_MODALITY_ORDER = ("t2", "flair", "t1ce", "t1")


def find_brats_case_dir(base_dir: str, case_name: str) -> str | None:
    for sub in ("HGG", "LGG", ""):
        p = os.path.join(base_dir, sub, case_name) if sub else os.path.join(base_dir, case_name)
        if os.path.isdir(p):
            return p
    return None


def find_brats_files(case_path: str, case_name: str) -> dict[str, str]:
    """Modality ('t1', 't1ce', 't2', 'flair', 'seg') -> file path: the
    standard BraTS names in .nii.gz then .nii, else keyword matching."""
    found: dict[str, str] = {}
    for mod in ("t1", "t1ce", "t2", "flair", "seg"):
        for ext in (".nii.gz", ".nii"):
            p = os.path.join(case_path, f"{case_name}_{mod}{ext}")
            if os.path.exists(p):
                found[mod] = p
                break
    if len(found) >= 3:
        return found
    for f in sorted(os.listdir(case_path)):
        if not (f.endswith(".nii") or f.endswith(".nii.gz")):
            continue
        fl = f.lower()
        full = os.path.join(case_path, f)
        if "_t1." in fl and "t1c" not in fl:
            found.setdefault("t1", full)
        elif "t1c" in fl or "t1gd" in fl:
            found.setdefault("t1ce", full)
        elif "_t2." in fl and "flair" not in fl:
            found.setdefault("t2", full)
        elif "flair" in fl:
            found.setdefault("flair", full)
        elif "seg" in fl:
            found.setdefault("seg", full)
    return found


def process_brats_case(base_dir: str, case_name: str, output_dir: str, fmt: str = "h5") -> bool:
    """One BraTS case -> <output_dir>/<case>.<fmt> with image and binary label."""
    case_path = find_brats_case_dir(base_dir, case_name)
    if case_path is None:
        print(f"[skip] case directory not found: {case_name}")
        return False
    files = find_brats_files(case_path, case_name)
    if "seg" not in files:
        print(f"[skip] no segmentation for {case_name}")
        return False
    image_path = next((files[m] for m in _BRATS_MODALITY_ORDER if m in files), None)
    if image_path is None:
        print(f"[skip] no image modality for {case_name}")
        return False

    image = normalize_image(nifti.load(image_path).get_fdata())
    label = (nifti.load(files["seg"]).get_fdata() > 0).astype(np.uint8)  # whole tumour
    image_r, label_r = resample(image, label, BRATS_TARGET_SHAPE)
    write_case(output_dir, case_name, {"image": image_r, "label": label_r}, fmt)
    print(f"[ok] {case_name}: {image.shape} -> {BRATS_TARGET_SHAPE}")
    return True


def preprocess_brats2019(input_dir: str, output_dir: str, cases: list[str] | None = None,
                         fmt: str = "h5") -> int:
    check_format(fmt)
    if cases is None:
        cases = []
        for sub in ("HGG", "LGG"):
            p = os.path.join(input_dir, sub)
            if os.path.isdir(p):
                cases += [d for d in sorted(os.listdir(p)) if d.startswith("BraTS19")]
    n = sum(process_brats_case(input_dir, c, output_dir, fmt) for c in cases)
    print(f"processed {n}/{len(cases)} cases")
    return n


# ------------------------------ ISLES-2022 ------------------------------


def find_isles_files(base_dir: str, case_name: str,
                     modality: str = "dwi") -> tuple[str | None, str | None]:
    """BIDS layout: the image under <case>/ses-0001/{dwi|anat}/, the mask
    under derivatives/; the modality falls back across dwi -> adc -> flair."""

    def _img(mod: str) -> str:
        if mod == "flair":
            return os.path.join(base_dir, case_name, "ses-0001", "anat",
                                f"{case_name}_ses-0001_FLAIR.nii.gz")
        return os.path.join(base_dir, case_name, "ses-0001", "dwi",
                            f"{case_name}_ses-0001_{mod}.nii.gz")

    image_path = None
    order = [modality.lower()] + [m for m in ("dwi", "adc", "flair") if m != modality.lower()]
    for mod in order:
        p = _img(mod)
        if os.path.exists(p):
            image_path = p
            break
    mask_path = os.path.join(base_dir, "derivatives", case_name, "ses-0001",
                             f"{case_name}_ses-0001_msk.nii.gz")
    return image_path, (mask_path if os.path.exists(mask_path) else None)


def process_isles_case(base_dir: str, case_name: str, output_dir: str, modality: str = "dwi",
                       fmt: str = "h5") -> bool:
    image_path, mask_path = find_isles_files(base_dir, case_name, modality)
    if image_path is None or mask_path is None:
        print(f"[skip] missing image or mask for {case_name}")
        return False
    image = normalize_image(nifti.load(image_path).get_fdata())
    mask = (nifti.load(mask_path).get_fdata() > 0).astype(np.uint8)
    image_r, mask_r = resample(image, mask, ISLES_TARGET_SHAPE)
    write_case(output_dir, case_name, {"image": image_r, "mask": mask_r}, fmt)
    print(f"[ok] {case_name}: {image.shape} -> {ISLES_TARGET_SHAPE}")
    return True


def create_isles_splits(cases: list[str], output_dir: str, train_ratio: float = 0.8,
                        seed: int = 42) -> tuple[list[str], list[str]]:
    """Reproducible 80/20 split (seed 42) into train.list / val.list."""
    rng = np.random.RandomState(seed)
    idx = rng.permutation(len(cases))
    n_train = int(len(cases) * train_ratio)
    train = [cases[i] for i in idx[:n_train]]
    val = [cases[i] for i in idx[n_train:]]
    os.makedirs(output_dir, exist_ok=True)
    for fname, items in (("train.list", train), ("val.list", val)):
        with open(os.path.join(output_dir, fname), "w") as f:
            f.write("\n".join(items) + ("\n" if items else ""))
    print(f"split: {len(train)} train / {len(val)} val (seed {seed})")
    return train, val


def preprocess_isles22(input_dir: str, output_dir: str, modality: str = "dwi",
                       cases: list[str] | None = None, fmt: str = "h5") -> int:
    check_format(fmt)
    if cases is None:
        cases = sorted(
            d for d in os.listdir(input_dir)
            if d.startswith("sub-strokecase") and os.path.isdir(os.path.join(input_dir, d))
        )
    done = [c for c in cases if process_isles_case(input_dir, c, output_dir, modality, fmt)]
    create_isles_splits(done, output_dir)
    print(f"processed {len(done)}/{len(cases)} cases")
    return len(done)
