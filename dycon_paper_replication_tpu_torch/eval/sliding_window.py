"""Sliding-window 3-D inference.

Counterpart of dycon_paper_replication_tpu/eval/sliding_window.py, with the
same semantics (the original patch loop's): pad the volume, centered, up to
the patch size; place patch origins on a (stride_xy, stride_xy, stride_z)
grid clamped to the far edge, deduplicated; average the per-voxel
foreground probability over overlapping patches; threshold at 0.5; un-pad.
InstanceNorm makes outputs patch-dependent, so patching is part of the
model's semantics.

On the device: the padded volumes are placed once; patches are gathered in
chunks of `patch_batch`, the origin list padded to whole chunks with
ZERO-WEIGHT entries (they run through the model and add nothing); the
overlap normaliser is a host-built float64 reciprocal count, applied as one
multiply. With a 2-class folded model that has a folded-IO seg entry
(`apply_seg_folded`: the UNet3D; the VNet has none and runs its patches
through `forward`, which folds inside) and all origins even, the whole
pipeline runs in fold-2 layout: the canvas is folded once, patches are
folded slices, the foreground probability is sigmoid(l1 - l0) on the
class-major lanes of the folded logits, and the score unfolds once. Any odd
origin takes the plain accumulator (softmax of channels-last logits).

Volume groups (`map(..., group=V)`, the JAX engine's): V consecutive
volumes of one raw shape share one dispatch, one volume-major origin list
with a volume index per origin over V canvases (folded once per group), so
forward chunks fill across volume boundaries; the list is padded to whole
chunks (times the replicas) with zero-weight entries. A shape change or the
tail flushes a smaller group, which runs volume by volume. Each volume's
patches are added to its canvas in the order a single-volume dispatch adds
them, so a group's scores are a single volume's wherever the forward of a
patch does not depend on its chunk.

Pipelining (`map(..., depth=D)`): a dispatch thread reads the volumes,
stages them and enqueues each group's device work (PyTorch releases the
GIL inside its ops, so the thread blocks in the launch queue, not the
consumer); up to `depth` dispatched groups wait with their label and score
on the device, copied to pinned host memory with non_blocking copies on a
side stream behind an event. The consumer waits only for that event, so
its host work on group i (metrics, saving) overlaps the device's work on
group i + 1. Nothing in the loop calls `.cpu()` or `.item()`.
`device_resident_runner(images)` stages one group once and returns a
callable that reruns its device work with no host traffic: the compute
ceiling against which `map`'s vols/s is read.

The host staging ring (JAX `_stage_host`), on CUDA: a group is copied into
a page-locked (V, *raw_shape) buffer from PyTorch's caching host allocator,
which recycles its blocks once their copies have finished, and sent with a
non_blocking copy. A buffer is exactly the raw shape and written whole, so
no margin of an earlier shape can leak. Kept against sending a fresh numpy
stack (a pageable copy, which first waits for the stream) by a measurement
on the card (scripts/measure_group_eval.py, NVIDIA H100
80GB HBM3, 700 W, headline protocol: 8 volumes of (192, 192, 64), patch
96^3, stride 16/4, folded float32, patch batch 4): a group of 8 (75.5 MB)
reaches the card in 15.0 ms pinned against 37.6 ms pageable (median of 5),
and the pinned copy does not make the dispatch thread wait for the stream;
end to end the two are within one run's noise (0.462 against 0.471 vols/s
with the test CLI's host work), since a group's device work takes ~3.9 s.

Replicas (`devices=[...]`, the counterpart of the JAX engine's mesh): one
model replica per device, each group's chunks split into contiguous blocks,
one per replica, each replica adding its patches into its own canvas, and
the partial score canvases summed on the first device: exact up to the
order of the additions, since overlap-add is addition.

The label map comes back as uint8, unpacked: on the card a uint8 copy
beats packing it (ops/bits.py). `transfer_dtype` is the JAX engine's: the
dtype the volume crosses the host link in, float32 by default (the
trainer's validation) and float16 where the JAX test CLI asks for it, with
a bfloat16 model. In float16 the image is rounded as JAX rounds it, and
half the bytes cross; on the card it is widened to float32 before
patching, so the model sees the same values as JAX's.
"""

from __future__ import annotations

import copy
import math
from typing import Callable, Iterator, NamedTuple

import numpy as np
import torch

from ..data.pipeline import background
from ..ops.folding import fold2, unfold2


def compute_origins(vol_shape: tuple[int, int, int], patch: tuple[int, int, int],
                    stride_xy: int, stride_z: int) -> np.ndarray:
    """Deduplicated (K, 3) int32 patch origins on the clamped grid."""
    strides = (stride_xy, stride_xy, stride_z)
    axes = []
    for size, p, s in zip(vol_shape, patch, strides):
        n = math.ceil((size - p) / s) + 1 if size > p else 1
        axes.append(sorted({min(s * i, size - p) for i in range(n)}))
    return np.array([(x, y, z) for x in axes[0] for y in axes[1] for z in axes[2]],
                    dtype=np.int32)


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def pipelined(dispatches: Iterator, depth: int) -> Iterator:
    """Items of `dispatches`, produced in inference mode on one dispatch
    thread at most `depth` ahead of the consumer (data/pipeline.background)."""

    def in_inference_mode():
        with torch.inference_mode():
            yield from dispatches

    return background(in_inference_mode(), depth, "evaluation dispatch")


_side_streams: dict = {}


class Fetch(NamedTuple):
    """Device results on their way to the host: `host` the host tensors
    (page-locked on CUDA), `event` recorded after their copies (None on the
    CPU), `keep` the device tensors the copies read."""

    host: tuple
    event: object
    keep: tuple

    def wait(self) -> list[np.ndarray]:
        if self.event is not None:
            self.event.synchronize()
        return [h.numpy() for h in self.host]


def fetch_async(*tensors: torch.Tensor) -> Fetch:
    """Start copying device `tensors` to the host without blocking: on CUDA
    into pinned buffers by non_blocking copies on a side stream that waits
    for the current stream; on the CPU the tensors themselves."""
    device = tensors[0].device
    if device.type != "cuda":
        return Fetch(tensors, None, ())
    if device not in _side_streams:
        _side_streams[device] = torch.cuda.Stream(device)
    side = _side_streams[device]
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        host = tuple(torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in tensors)
        for h, t in zip(host, tensors):
            h.copy_(t, non_blocking=True)
        event = torch.cuda.Event()
        event.record(side)
    return Fetch(host, event, tensors)


def stage(arrays: list[np.ndarray], dtype, device: torch.device) -> torch.Tensor:
    """(V, *shape) on `device` from V same-shape host arrays in `dtype`:
    on CUDA through a page-locked buffer and a non_blocking copy (the
    staging ring, module doc), on the CPU a numpy stack."""
    if device.type == "cuda":
        buf = torch.empty((len(arrays),) + arrays[0].shape,
                          dtype=torch.from_numpy(np.zeros(0, dtype)).dtype, pin_memory=True)
        view = buf.numpy()
        for i, a in enumerate(arrays):
            np.copyto(view[i], a, casting="unsafe")
        return buf.to(device, non_blocking=True)
    return torch.from_numpy(np.stack([np.asarray(a, dtype) for a in arrays])).to(device)


def replicate(engine) -> list:
    """`engine.model` on each of `engine.devices`: the model itself on its
    own device (first occurrence), copies elsewhere (kept in
    `engine._replicas`), refreshed from the model's current state at every
    call."""
    model, devices = engine.model, engine.devices
    if len(devices) == 1 and devices[0] == engine.device:
        return [model]
    with torch.inference_mode(False), torch.no_grad():  # also from the dispatch thread
        if engine._replicas is None:
            own = devices.index(engine.device) if engine.device in devices else -1
            engine._replicas = [model if i == own else copy.deepcopy(model).to(d)
                                for i, d in enumerate(devices)]
        state = model.state_dict()
        for r in engine._replicas:
            if r is not model:
                r.load_state_dict(state)
                r.train(model.training)
    return engine._replicas


class _Group(NamedTuple):
    """One dispatch: V volumes of `raw_shape`, centred at `pads` in canvases
    of `true_shape`; per replica its chunks of (volume index, origin,
    weight) rows, `patch_batch` rows each."""

    raw_shape: tuple
    pads: tuple
    true_shape: tuple
    origins: np.ndarray
    folded: bool
    n_vol: int
    chunks: list  # per replica: [(vol_idx (B,), origins (B, 3), weights (B,)), ...]


class Pending(NamedTuple):
    """A dispatched group: its fetch and the items' extra fields."""

    fetch: Fetch
    rests: list
    with_score: bool


class SlidingWindowInference:
    """Sliding-window engine for one (patch, strides) protocol over `model`,
    a UNet3D or VNet in eval mode on its device.

    `label, score = sw(image)` with image a (D1, D2, D3) numpy volume gives
    numpy (D1, D2, D3) uint8 labels and float32 scores. `sw.map(volumes,
    group=V, depth=D)` runs an iterable of (image, *rest) items. With
    `devices`, one replica of the model per device (module doc)."""

    def __init__(self, model, patch_size: tuple[int, int, int], stride_xy: int,
                 stride_z: int, patch_batch: int = 4, transfer_dtype=np.float32,
                 devices: list | None = None):
        self.model = model
        self.transfer_dtype = transfer_dtype
        self.patch = tuple(patch_size)
        self.stride_xy = stride_xy
        self.stride_z = stride_z
        self.patch_batch = patch_batch
        self.device = next(model.parameters()).device
        self.devices = [torch.device(d) for d in devices] if devices else [self.device]
        self._replicas: list | None = None
        # reciprocal overlap counts keyed by (padded shape, folded)
        self._inv_cnt_cache: dict = {}

    def replicas(self) -> list:
        return replicate(self)

    def _folded(self, origins: np.ndarray) -> bool:
        cfg = self.model.cfg
        return (getattr(self.model, "apply_seg_folded", None) is not None
                and cfg.layout == "folded" and cfg.n_classes == 2
                and all(p % 16 == 0 for p in self.patch) and not (origins % 2).any())

    def _inv_cnt(self, true_shape, origins, folded: bool) -> torch.Tensor:
        """float32 reciprocal of the overlap count, built in float64 on the
        host (so `score * inv` matches `score / cnt` to 1 ulp), zero where
        no window reaches; in fold-2 layout (G1, G2, G3, 8) when folded."""
        key = (tuple(true_shape), folded)
        if key not in self._inv_cnt_cache:
            p = self.patch
            cnt = np.zeros(true_shape, np.float64)
            for x, y, z in origins:
                cnt[x:x + p[0], y:y + p[1], z:z + p[2]] += 1.0
            inv = np.where(cnt > 0, 1.0 / np.maximum(cnt, 1.0), 0.0).astype(np.float32)
            if folded:
                g = tuple(s // 2 for s in true_shape)
                inv = (inv.reshape(g[0], 2, g[1], 2, g[2], 2)
                       .transpose(0, 2, 4, 1, 3, 5).reshape(g + (8,)))
            self._inv_cnt_cache[key] = torch.from_numpy(inv).to(self.devices[0])
        return self._inv_cnt_cache[key]

    def _prepare(self, raw_shape: tuple, n_vol: int) -> _Group:
        """The origin grid of `raw_shape` for `n_vol` volumes, volume-major,
        padded to whole chunks (times the replicas) with zero-weight copies
        of the last origin (volume 0), split into one contiguous block of
        chunks per replica."""
        pads = tuple(max(p - s, 0) // 2 for s, p in zip(raw_shape, self.patch))
        true_shape = tuple(max(s, p) for s, p in zip(raw_shape, self.patch))
        origins = compute_origins(true_shape, self.patch, self.stride_xy, self.stride_z)
        k, n_dev, b = len(origins), len(self.devices), self.patch_batch
        kb = _round_up(k * n_vol, b * n_dev)
        vol_idx = np.concatenate([np.repeat(np.arange(n_vol), k), np.zeros(kb - k * n_vol, int)])
        orgs = np.concatenate([np.tile(origins, (n_vol, 1)),
                               np.tile(origins[-1:], (kb - k * n_vol, 1))])
        weights = np.zeros(kb, np.float32)
        weights[:k * n_vol] = 1.0
        per_dev = kb // n_dev
        chunks = [[(vol_idx[c:c + b], orgs[c:c + b], weights[c:c + b])
                   for c in range(d * per_dev, (d + 1) * per_dev, b)] for d in range(n_dev)]
        return _Group(tuple(raw_shape), pads, true_shape, origins, self._folded(origins), n_vol,
                      chunks)

    def _accum_plain(self, model, canvas: torch.Tensor, chunks) -> Iterator[torch.Tensor]:
        """Adds each chunk's softmax foreground probabilities into a fresh
        (V, *true_shape) score; yields after each chunk (so replicas
        interleave), the score last."""
        p = self.patch
        score = torch.zeros(canvas.shape, dtype=torch.float32, device=canvas.device)
        for vis, orgs, w in chunks:
            sl = [(int(vi),) + tuple(slice(o, o + n) for o, n in zip(org, p))
                  for vi, org in zip(vis, orgs)]
            patches = torch.stack([canvas[s] for s in sl])[..., None]
            _, logits, _ = model(patches, with_projection=False)
            probs = torch.softmax(logits, dim=-1)[..., 1]
            for s, prob, wi in zip(sl, probs, w):
                score[s] += float(wi) * prob
            yield None
        yield score

    def _accum_folded(self, model, canvas: torch.Tensor, chunks) -> Iterator[torch.Tensor]:
        """The same in fold-2 layout: the canvases folded once, a fresh
        (V, G1, G2, G3, 8) score."""
        pf = tuple(n // 2 for n in self.patch)
        vol_f = fold2(canvas[..., None])  # (V, G1, G2, G3, 8)
        score = torch.zeros(vol_f.shape, dtype=torch.float32, device=canvas.device)
        for vis, orgs, w in chunks:
            sl = [(int(vi),) + tuple(slice(o // 2, o // 2 + n) for o, n in zip(org, pf))
                  for vi, org in zip(vis, orgs)]
            patches = torch.stack([vol_f[s] for s in sl])  # (B, *pf, 8)
            seg_f = model.apply_seg_folded(patches)
            probs = torch.sigmoid(seg_f[..., 8:16] - seg_f[..., 0:8])
            for s, prob, wi in zip(sl, probs, w):
                score[s] += float(wi) * prob
            yield None
        yield score

    def _run(self, raws: list[torch.Tensor], g: _Group, models: list):
        """The device work of one group: `raws` (V, *raw_shape), one per
        replica on its device. Returns the (V, *raw_shape) uint8 labels and
        float32 scores on the first device."""
        raw_sl = tuple(slice(lo, lo + s) for lo, s in zip(g.pads, g.raw_shape))
        accs = []
        for model, raw, chunks in zip(models, raws, g.chunks):
            canvas = torch.zeros((g.n_vol,) + g.true_shape, dtype=torch.float32,
                                 device=raw.device)
            canvas[(slice(None),) + raw_sl] = raw
            accum = self._accum_folded if g.folded else self._accum_plain
            accs.append(accum(model, canvas, chunks))
        partial = [None] * len(accs)
        while any(p is None for p in partial):  # one chunk per replica in turn
            for i, acc in enumerate(accs):
                if partial[i] is None:
                    partial[i] = next(acc)
        score = partial[0]
        for p in partial[1:]:
            score = score + p.to(score.device)
        score = score * self._inv_cnt(g.true_shape, g.origins, g.folded)
        if g.folded:
            score = unfold2(score)[..., 0]
        score = score[(slice(None),) + raw_sl]
        return (score > 0.5).to(torch.uint8), score

    def _stage(self, images: list[np.ndarray]) -> list[torch.Tensor]:
        raw = stage(images, self.transfer_dtype, self.devices[0])
        return [raw if d == self.devices[0] else raw.to(d) for d in self.devices]

    def _dispatch_many(self, images: list[np.ndarray], rests: list,
                       return_score: bool) -> Pending:
        """Stage a group of same-shape volumes, enqueue its device work and
        the copies of its results, without waiting for any of them."""
        g = self._prepare(images[0].shape, len(images))
        label, score = self._run(self._stage(images), g, self.replicas())
        fetch = fetch_async(label, score) if return_score else fetch_async(label)
        return Pending(fetch, rests, return_score)

    @staticmethod
    def _finish(entry: Pending):
        """(label, score or None, *rest) per volume of a dispatched group,
        fresh host arrays."""
        host = entry.fetch.wait()
        for i, rest in enumerate(entry.rests):
            yield (host[0][i].copy(), host[1][i].copy() if entry.with_score else None, *rest)

    @torch.inference_mode()
    def device_resident_runner(self, images: list[np.ndarray]) -> Callable:
        """Compute-ceiling probe: stage one group of same-shape volumes on
        the device once and return a callable that reruns its device work
        with no host traffic, returning the device (labels, scores)."""
        g = self._prepare(images[0].shape, len(images))
        raws = self._stage(images)
        models = self.replicas()

        def run():
            with torch.inference_mode():
                return self._run(raws, g, models)

        return run

    @torch.inference_mode()
    def dispatch(self, image: np.ndarray, return_score: bool = True) -> Pending:
        """Single-volume `_dispatch_many`: enqueued, not waited for."""
        return self._dispatch_many([np.asarray(image, self.transfer_dtype)], [()], return_score)

    def __call__(self, image: np.ndarray, *, return_score: bool = True):
        label, score = next(self._finish(self.dispatch(image, return_score)))
        return label, score

    def map(self, volumes, *, return_score: bool = False, group: int = 1, depth: int = 2):
        """Yield (label, score or None, *rest) for each (image, *rest) item,
        in input order: groups of `group` consecutive same-shape volumes
        (a shape change or the tail flushes the rest volume by volume), up
        to `depth` dispatched groups ahead of the consumer (module doc)."""
        group, depth = max(1, int(group)), max(1, int(depth))

        def dispatches():
            buf: list = []

            def flush():
                if len(buf) == group:
                    yield self._dispatch_many([b[0] for b in buf], [b[1] for b in buf],
                                              return_score)
                else:
                    for image, rest in buf:
                        yield self._dispatch_many([image], [rest], return_score)
                buf.clear()

            for item in volumes:
                image, *rest = item if isinstance(item, tuple) else (item,)
                image = np.asarray(image, self.transfer_dtype)
                if buf and image.shape != buf[0][0].shape:
                    yield from flush()
                buf.append((image, tuple(rest)))
                if len(buf) == group:
                    yield from flush()
            yield from flush()

        for entry in pipelined(dispatches(), depth):
            yield from self._finish(entry)
