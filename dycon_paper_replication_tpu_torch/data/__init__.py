"""Data: datasets, transforms, the two-stream sampler, the batch loader and
synthetic dataset trees."""

from .datasets import BraTS2019, ISLESDataset, Pancreas, VolumeDataset
from .pipeline import BatchLoader
from .samplers import TwoStreamBatchSampler
from .synthetic import make_brats19
from .transforms import Compose, RandomCrop, RandomRotFlip, SagittalToAxial, ToArray

__all__ = ["BatchLoader", "BraTS2019", "Compose", "ISLESDataset", "Pancreas", "RandomCrop",
           "RandomRotFlip", "SagittalToAxial", "ToArray", "TwoStreamBatchSampler", "VolumeDataset",
           "make_brats19"]
