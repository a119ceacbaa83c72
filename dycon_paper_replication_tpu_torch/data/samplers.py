"""Semi-supervised batch indices.

Counterpart of `TwoStreamBatchSampler` and `ThreeStreamBatchSampler` in
dycon_paper_replication_tpu/data/samplers.py, with the same draws from the
same seed: each batch is [labeled_0 .. labeled_{k-1} | unlabeled_0 ..
unlabeled_{m-1}], so the losses slice batch[:labeled_bs] for the
supervised terms. An epoch is one pass over the labeled (primary) indices;
the unlabeled stream reshuffles forever. The three-stream sampler appends a
third eternally reshuffled stream (no trainer uses it, as in the
reference).
"""

from __future__ import annotations

from typing import Iterator, Sequence

import numpy as np


def _eternal_permutations(indices: Sequence[int], rng: np.random.Generator) -> Iterator[int]:
    idx = np.asarray(indices)
    while True:
        yield from rng.permutation(idx)


class TwoStreamBatchSampler:
    def __init__(self, primary_indices: Sequence[int], secondary_indices: Sequence[int],
                 batch_size: int, secondary_batch_size: int, seed: int = 0):
        self.primary_indices = list(primary_indices)
        self.secondary_indices = list(secondary_indices)
        self.secondary_batch_size = secondary_batch_size
        self.primary_batch_size = batch_size - secondary_batch_size
        self.rng = np.random.default_rng(seed)
        if not (len(self.primary_indices) >= self.primary_batch_size > 0
                and len(self.secondary_indices) >= self.secondary_batch_size > 0):
            raise ValueError(
                f"need 0 < labeled batch {self.primary_batch_size} <= "
                f"{len(self.primary_indices)} labeled cases and 0 < unlabeled batch "
                f"{self.secondary_batch_size} <= {len(self.secondary_indices)} unlabeled cases")

    def __iter__(self) -> Iterator[list[int]]:
        primary = self.rng.permutation(np.asarray(self.primary_indices))
        secondary = _eternal_permutations(self.secondary_indices, self.rng)
        for b in range(len(self)):
            p = primary[b * self.primary_batch_size:(b + 1) * self.primary_batch_size]
            s = [next(secondary) for _ in range(self.secondary_batch_size)]
            yield [int(i) for i in p] + [int(i) for i in s]

    def __len__(self) -> int:
        return len(self.primary_indices) // self.primary_batch_size


class ThreeStreamBatchSampler:
    """Batches [primary | secondary | tertiary]: one pass over the primary
    indices per epoch, the other two streams reshuffled forever."""

    def __init__(self, primary_indices: Sequence[int], secondary_indices: Sequence[int],
                 tertiary_indices: Sequence[int], batch_size: int, secondary_batch_size: int,
                 tertiary_batch_size: int, seed: int = 0):
        self.primary_indices = list(primary_indices)
        self.secondary_indices = list(secondary_indices)
        self.tertiary_indices = list(tertiary_indices)
        self.secondary_batch_size = secondary_batch_size
        self.tertiary_batch_size = tertiary_batch_size
        self.primary_batch_size = batch_size - secondary_batch_size - tertiary_batch_size
        self.rng = np.random.default_rng(seed)
        if not len(self.primary_indices) >= self.primary_batch_size > 0:
            raise ValueError(f"need 0 < primary batch {self.primary_batch_size} <= "
                             f"{len(self.primary_indices)} primary indices")

    def __iter__(self) -> Iterator[list[int]]:
        primary = self.rng.permutation(np.asarray(self.primary_indices))
        secondary = _eternal_permutations(self.secondary_indices, self.rng)
        tertiary = _eternal_permutations(self.tertiary_indices, self.rng)
        for b in range(len(self)):
            p = primary[b * self.primary_batch_size:(b + 1) * self.primary_batch_size]
            s = [int(next(secondary)) for _ in range(self.secondary_batch_size)]
            t = [int(next(tertiary)) for _ in range(self.tertiary_batch_size)]
            yield [int(i) for i in p] + s + t

    def __len__(self) -> int:
        return len(self.primary_indices) // self.primary_batch_size
