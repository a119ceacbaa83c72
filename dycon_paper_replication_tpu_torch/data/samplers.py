"""Semi-supervised batch indices.

Counterpart of `TwoStreamBatchSampler` in
dycon_paper_replication_tpu/data/samplers.py, with the same draws from the
same seed: each batch is [labeled_0 .. labeled_{k-1} | unlabeled_0 ..
unlabeled_{m-1}], so the losses slice batch[:labeled_bs] for the
supervised terms. An epoch is one pass over the labeled (primary) indices;
the unlabeled stream reshuffles forever.
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
