"""Data: datasets, transforms, the two-stream sampler, the batch loader,
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
from .samplers import TwoStreamBatchSampler
from .synthetic import make_brats19
from .transforms import Compose, RandomCrop, RandomRotFlip, SagittalToAxial, ToArray

__all__ = ["BRATS_TARGET_SHAPE", "BatchLoader", "BraTS2019", "Compose", "ISLESDataset",
           "ISLES_TARGET_SHAPE", "Pancreas", "RandomCrop", "RandomRotFlip", "SagittalToAxial",
           "ToArray", "TwoStreamBatchSampler", "VolumeDataset", "create_isles_splits",
           "make_brats19", "nifti", "normalize_image", "preprocess_brats2019",
           "preprocess_isles22", "resample"]
