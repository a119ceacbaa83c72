"""Prefetching batch feeder: a background thread reads and augments the next
batches, and copies them to the card, while the card runs the current step.

Counterpart of `BatchLoader` in dycon_paper_replication_tpu/data/pipeline.py:
each (epoch, batch) draws from its own `numpy.random.default_rng((seed,
epoch, batch))`, so the batches are the JAX package's for one seed, whatever
the prefetch depth. A batch is {'image' (B, D1, D2, D3, 1), 'label'
(B, D1, D2, D3)} in the wire dtypes (`image_dtype`, `label_dtype`: float32
and int32 by default, float16 and uint8 for the trainer's --wire_dtype
float16, which the step widens on the device), holding the rows `rows` of
the global batch (a data-parallel rank's; all by default).

Without a CUDA `device` (the CPU) the batches are fresh numpy arrays, and
nothing is pinned. With one, they are tensors on the card: the producer
thread assembles each batch into a ring of pinned host buffers
(`PinnedRing`, JAX's `_batch_buffers`: prefetch + 3 slots a shape) and
copies it with non_blocking=True on a side stream; the consumer's stream
waits on that copy's event, and the allocator is told the tensors are used
there (record_stream). A slot is filled again only once the event of its
last copy has completed: the host may be steps ahead of the card
(train/trainer.py, fetch_ahead), so JAX's argument that the consumer
synchronizes every step does not hold here. Pinning that fails raises; the
loader never falls back to pageable memory.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Iterator

import numpy as np
import torch

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


class PinnedRing:
    """`depth` slots of host buffers, handed out in turn by `acquire`; a slot
    is handed out again only after the event that `release` gave it (its
    last copy to the device) has completed, polled every `poll_s` (a poll,
    not a wait on the event: the thread then holds no CUDA sync, and the
    trainer may run its step under torch.cuda.set_sync_debug_mode)."""

    def __init__(self, depth: int, make: Callable[[], dict], poll_s: float = 1e-4):
        self.slots = [make() for _ in range(depth)]
        self.events: list = [None] * depth
        self.poll_s = poll_s
        self._next = 0

    def acquire(self) -> tuple[int, dict]:
        i = self._next
        self._next = (i + 1) % len(self.slots)
        event = self.events[i]
        while event is not None and not event.query():
            time.sleep(self.poll_s)
        self.events[i] = None
        return i, self.slots[i]

    def release(self, i: int, event) -> None:
        self.events[i] = event


class BatchLoader:
    """Batches of `dataset.get(idx, rng)` samples over the index lists of
    `sampler` (re-iterated each epoch): numpy arrays, or tensors on a CUDA
    `device` (module doc)."""

    def __init__(self, dataset, sampler: TwoStreamBatchSampler, seed: int = 0,
                 prefetch: int = 2, device: torch.device | str | None = None,
                 image_dtype=np.float32, label_dtype=np.int32, rows=None):
        self.dataset = dataset
        self.sampler = sampler
        self.seed = seed
        self.prefetch = max(1, prefetch)
        self.device = None if device is None else torch.device(device)
        if self.device is not None and self.device.type != "cuda":
            self.device = None
        self.image_dtype = np.dtype(image_dtype)
        self.label_dtype = np.dtype(label_dtype)
        self.rows = None if rows is None else np.asarray(rows)
        self._epoch = 0
        # one ring per shape key, each with its own cursor (JAX's pool)
        self._pool: dict = {}
        self._stream = None

    def __len__(self) -> int:
        return len(self.sampler)

    def _ring(self, image_shape, label_shape) -> PinnedRing:
        key = (image_shape, label_shape)
        if key not in self._pool:
            def make():
                return {"image": torch.empty(image_shape, pin_memory=True,
                                             dtype=_torch_dtype(self.image_dtype)),
                        "label": torch.empty(label_shape, pin_memory=True,
                                             dtype=_torch_dtype(self.label_dtype))}
            self._pool[key] = PinnedRing(self.prefetch + 3, make)
        return self._pool[key]

    def _assemble(self, indices: list[int], rng: np.random.Generator):
        # every sample is drawn, in order, whichever rows are kept: the
        # rng stream is the batch's
        samples = [self.dataset.get(i, rng) for i in indices]
        if self.rows is not None:
            samples = [samples[r] for r in self.rows]
        if self.device is None:
            return {"image": np.stack([s["image"] for s in samples]).astype(self.image_dtype,
                                                                             copy=False),
                    "label": np.stack([s["label"] for s in samples]).astype(self.label_dtype,
                                                                             copy=False)}
        n = len(samples)
        ring = self._ring((n,) + samples[0]["image"].shape, (n,) + samples[0]["label"].shape)
        slot, buf = ring.acquire()
        for k in ("image", "label"):
            host = buf[k].numpy()
            for i, s in enumerate(samples):
                host[i] = s[k]
        with torch.cuda.device(self.device):
            if self._stream is None:
                self._stream = torch.cuda.Stream(self.device)
            with torch.cuda.stream(self._stream):
                out = {k: v.to(self.device, non_blocking=True) for k, v in buf.items()}
                ready = torch.cuda.Event()
                ready.record(self._stream)
        ring.release(slot, ready)
        return out, ready

    def epochs(self, n_epochs: int | None = None) -> Iterator[tuple[int, dict]]:
        """(epoch index, batch) over `n_epochs` epochs (None: no end) from one
        producer thread, so the queue does not drain at epoch boundaries
        (a Pancreas epoch is only labelnum / labeled_bs batches). On CUDA
        each batch is made ready for the consumer's current stream as it is
        handed over."""

        def produce():
            produced = 0
            while n_epochs is None or produced < n_epochs:
                epoch_id = self._epoch
                self._epoch += 1
                produced += 1
                for b, indices in enumerate(iter(self.sampler)):
                    rng = np.random.default_rng((self.seed, epoch_id, b))
                    yield epoch_id, self._assemble(indices, rng)

        items = background(produce(), self.prefetch, "BatchLoader producer")
        if self.device is None:
            return items
        return self._handed_over(items)

    def _handed_over(self, items: Iterator) -> Iterator[tuple[int, dict]]:
        try:
            for epoch_id, (batch, ready) in items:
                stream = torch.cuda.current_stream(self.device)
                stream.wait_event(ready)
                for t in batch.values():
                    t.record_stream(stream)
                yield epoch_id, batch
        finally:
            items.close()

    def __iter__(self) -> Iterator[dict]:
        """The batches of one epoch."""
        for _, batch in self.epochs(1):
            yield batch


def _torch_dtype(dtype: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype)).dtype
