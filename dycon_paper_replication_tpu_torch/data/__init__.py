"""Data: datasets, transforms, the two-stream sampler, the batch loader and
synthetic dataset trees."""

from .datasets import ISLESDataset, Pancreas, VolumeDataset
from .pipeline import BatchLoader
from .samplers import TwoStreamBatchSampler
from .transforms import Compose, RandomCrop, RandomRotFlip, ToArray

__all__ = ["BatchLoader", "Compose", "ISLESDataset", "Pancreas", "RandomCrop", "RandomRotFlip", "ToArray",
           "TwoStreamBatchSampler", "VolumeDataset"]
