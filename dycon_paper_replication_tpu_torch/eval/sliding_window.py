"""Sliding-window 3-D inference.

Counterpart of dycon_paper_replication_tpu/eval/sliding_window.py, with the
same semantics (the original patch loop's): pad the volume, centered, up to
the patch size; place patch origins on a (stride_xy, stride_xy, stride_z)
grid clamped to the far edge, deduplicated; average the per-voxel
foreground probability over overlapping patches; threshold at 0.5; un-pad.
InstanceNorm makes outputs patch-dependent, so patching is part of the
model's semantics.

On the device: the padded volume is placed once; patches are gathered in
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

Not ported yet: mesh sharding, volume groups larger than 1 and the host
staging ring. The label map comes back as uint8, unpacked: on the card a
uint8 copy beats packing it (ops/bits.py).
"""

from __future__ import annotations

import math

import numpy as np
import torch

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


class SlidingWindowInference:
    """Sliding-window engine for one (patch, strides) protocol over `model`,
    a UNet3D or VNet in eval mode on its device.

    `label, score = sw(image)` with image a (D1, D2, D3) numpy volume gives
    numpy (D1, D2, D3) uint8 labels and float32 scores. `sw.map(volumes)`
    runs an iterable of (image, *rest) items."""

    def __init__(self, model, patch_size: tuple[int, int, int], stride_xy: int,
                 stride_z: int, patch_batch: int = 4):
        self.model = model
        self.patch = tuple(patch_size)
        self.stride_xy = stride_xy
        self.stride_z = stride_z
        self.patch_batch = patch_batch
        self.device = next(model.parameters()).device
        # reciprocal overlap counts keyed by (padded shape, folded)
        self._inv_cnt_cache: dict = {}

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
            self._inv_cnt_cache[key] = torch.from_numpy(inv).to(self.device)
        return self._inv_cnt_cache[key]

    def _chunks(self, origins: np.ndarray):
        """(origins, weights) per chunk of patch_batch, the tail padded with
        zero-weight copies of the last origin."""
        k = len(origins)
        kb = _round_up(k, self.patch_batch)
        origins_b = np.concatenate([origins, np.tile(origins[-1:], (kb - k, 1))])
        weights_b = np.zeros(kb, np.float32)
        weights_b[:k] = 1.0
        for c in range(0, kb, self.patch_batch):
            yield origins_b[c:c + self.patch_batch], weights_b[c:c + self.patch_batch]

    def _accum_plain(self, vol: torch.Tensor, origins: np.ndarray) -> torch.Tensor:
        p = self.patch
        score = torch.zeros(vol.shape, dtype=torch.float32, device=self.device)
        for chunk, w in self._chunks(origins):
            sl = [tuple(slice(o, o + n) for o, n in zip(org, p)) for org in chunk]
            patches = torch.stack([vol[s] for s in sl])[..., None]
            _, logits, _ = self.model(patches, with_projection=False)
            probs = torch.softmax(logits, dim=-1)[..., 1]
            for s, prob, wi in zip(sl, probs, w):
                score[s] += float(wi) * prob
        return score

    def _accum_folded(self, vol: torch.Tensor, origins: np.ndarray) -> torch.Tensor:
        pf = tuple(n // 2 for n in self.patch)
        vol_f = fold2(vol[None, ..., None])[0]  # (G1, G2, G3, 8)
        score = torch.zeros(vol_f.shape, dtype=torch.float32, device=self.device)
        for chunk, w in self._chunks(origins):
            sl = [tuple(slice(o // 2, o // 2 + n) for o, n in zip(org, pf)) for org in chunk]
            patches = torch.stack([vol_f[s] for s in sl])  # (B, *pf, 8)
            seg_f = self.model.apply_seg_folded(patches)
            probs = torch.sigmoid(seg_f[..., 8:16] - seg_f[..., 0:8])
            for s, prob, wi in zip(sl, probs, w):
                score[s] += float(wi) * prob
        return score

    @torch.inference_mode()
    def __call__(self, image: np.ndarray, *, return_score: bool = True):
        raw_shape = image.shape
        pads = [max(p - s, 0) // 2 for s, p in zip(raw_shape, self.patch)]
        true_shape = tuple(max(s, p) for s, p in zip(raw_shape, self.patch))
        origins = compute_origins(true_shape, self.patch, self.stride_xy, self.stride_z)
        folded = self._folded(origins)

        raw = tuple(slice(lo, lo + s) for lo, s in zip(pads, raw_shape))
        vol = torch.zeros(true_shape, dtype=torch.float32, device=self.device)
        vol[raw] = torch.from_numpy(np.asarray(image, np.float32)).to(self.device)
        if folded:
            score = self._accum_folded(vol, origins) * self._inv_cnt(true_shape, origins, True)
            score = unfold2(score[None])[0, ..., 0]
        else:
            score = self._accum_plain(vol, origins) * self._inv_cnt(true_shape, origins, False)
        score = score[raw]
        label = (score > 0.5).to(torch.uint8).cpu().numpy()
        return label, (score.cpu().numpy() if return_score else None)

    def map(self, volumes, *, return_score: bool = False):
        """Yield (label, score or None, *rest) for each (image, *rest) item,
        in input order."""
        for item in volumes:
            image, *rest = item if isinstance(item, tuple) else (item,)
            label, score = self(image, return_score=return_score)
            yield (label, score, *rest)
