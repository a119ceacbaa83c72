"""Data: datasets, transforms, the two- and three-stream samplers, the batch loader,
synthetic dataset trees, and NIfTI reading and preprocessing."""

from . import nifti
from .datasets import BraTS2019, ISLESDataset, Pancreas, VolumeDataset
from .pipeline import BatchLoader
from .preprocess import (
    BRATS_TARGET_SHAPE,
    ISLES_TARGET_SHAPE,
    create_isles_splits,
    normalize_image,
    preprocess_brats2019,
    preprocess_isles22,
    resample,
)
from .samplers import ThreeStreamBatchSampler, TwoStreamBatchSampler
from .synthetic import make_brats19, make_hard_pancreas
from .transforms import (
    CenterCrop,
    Compose,
    CreateOnehotLabel,
    RandomCrop,
    RandomNoise,
    RandomRotFlip,
    Resize,
    SagittalToAxial,
    ToArray,
)

__all__ = ["BRATS_TARGET_SHAPE", "BatchLoader", "BraTS2019", "CenterCrop", "Compose",
           "CreateOnehotLabel", "ISLESDataset", "ISLES_TARGET_SHAPE", "Pancreas", "RandomCrop",
           "RandomNoise", "RandomRotFlip", "Resize", "SagittalToAxial", "ThreeStreamBatchSampler",
           "ToArray", "TwoStreamBatchSampler", "VolumeDataset", "create_isles_splits",
           "make_brats19", "make_hard_pancreas", "nifti", "normalize_image",
           "preprocess_brats2019", "preprocess_isles22", "resample"]
