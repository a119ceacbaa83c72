"""Prefetching batch feeder: a background thread reads and augments the next
batches while the card runs the current step.

Counterpart of `BatchLoader` in dycon_paper_replication_tpu/data/pipeline.py:
each (epoch, batch) draws from its own `numpy.random.default_rng((seed,
epoch, batch))`, so the batches are the JAX package's for one seed, whatever
the prefetch depth. Batches are fresh numpy arrays {'image' (B, D1, D2, D3, 1)
float32, 'label' (B, D1, D2, D3) int32}; the trainer moves them to the
card. Not ported: the pooled host buffers and the narrow wire dtypes of the
TPU's host link.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np

from .samplers import TwoStreamBatchSampler


class _WorkerError:
    """Carries a producer exception to the consumer, which raises it."""

    def __init__(self, exc: BaseException):
        self.exc = exc


def background(items: Iterator, depth: int, name: str) -> Iterator:
    """The items of `items`, produced on one thread at most `depth` ahead of
    the consumer (the batch loader's prefetch, the evaluation engines'
    dispatch). The thread's exception is raised in the consumer as
    RuntimeError(f"{name} thread failed"); a consumer that leaves early
    stops the thread at its next item."""
    q: queue.Queue = queue.Queue(maxsize=max(1, depth))
    stop = threading.Event()
    done = object()

    def put(item) -> bool:
        # re-checks `stop`: a consumer that leaves early must not leave
        # this thread blocked in q.put
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in items:
                if not put(item):
                    return
            put(done)
        except BaseException as exc:  # noqa: BLE001 — re-raised by the consumer
            put(_WorkerError(exc))

    t = threading.Thread(target=worker, name=name, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is done:
                return
            if isinstance(item, _WorkerError):
                raise RuntimeError(f"{name} thread failed") from item.exc
            yield item
    finally:
        stop.set()
        t.join(timeout=10)


class BatchLoader:
    """Batches of `dataset.get(idx, rng)` samples over the index lists of
    `sampler` (re-iterated each epoch)."""

    def __init__(self, dataset, sampler: TwoStreamBatchSampler, seed: int = 0,
                 prefetch: int = 2):
        self.dataset = dataset
        self.sampler = sampler
        self.seed = seed
        self.prefetch = max(1, prefetch)
        self._epoch = 0

    def __len__(self) -> int:
        return len(self.sampler)

    def _assemble(self, indices: list[int], rng: np.random.Generator) -> dict:
        samples = [self.dataset.get(i, rng) for i in indices]
        return {"image": np.stack([s["image"] for s in samples]),
                "label": np.stack([s["label"] for s in samples])}

    def epochs(self, n_epochs: int | None = None) -> Iterator[tuple[int, dict]]:
        """(epoch index, batch) over `n_epochs` epochs (None: no end) from one
        producer thread, so the queue does not drain at epoch boundaries
        (a Pancreas epoch is only labelnum / labeled_bs batches)."""

        def produce():
            produced = 0
            while n_epochs is None or produced < n_epochs:
                epoch_id = self._epoch
                self._epoch += 1
                produced += 1
                for b, indices in enumerate(iter(self.sampler)):
                    rng = np.random.default_rng((self.seed, epoch_id, b))
                    yield epoch_id, self._assemble(indices, rng)

        return background(produce(), self.prefetch, "BatchLoader producer")

    def __iter__(self) -> Iterator[dict]:
        """The batches of one epoch."""
        for _, batch in self.epochs(1):
            yield batch
