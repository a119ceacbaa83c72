"""Resampling and pooling of channels-last (B, D1, D2, D3, C) volumes.

Counterpart of dycon_paper_replication_tpu/ops/resize.py, with the same
coordinate conventions:
  * align_corners=False (half-pixel centers, the decoder's 2x upsample):
        src = (dst + 0.5) * in / out - 0.5, clamped at 0;
  * align_corners=True (the projection head):  src = dst * (in-1) / (out-1).
Source indices are clamped to the valid range. Also the 2x max pool and the
non-overlapping average pool of the FeCL mask, ASPP's global average
pool, and the zero pad to a shape.
"""

from __future__ import annotations

import torch


def _axis_lerp(x: torch.Tensor, axis: int, out_size: int, align_corners: bool) -> torch.Tensor:
    """Linearly resample one axis of `x` to `out_size`."""
    in_size = x.shape[axis]
    if in_size == out_size:
        return x
    dst = torch.arange(out_size, dtype=torch.float32, device=x.device)
    if align_corners:
        scale = (in_size - 1) / (out_size - 1) if out_size > 1 else 0.0
        src = dst * scale
    else:
        src = ((dst + 0.5) * (in_size / out_size) - 0.5).clamp(min=0.0)
    lo = src.floor().to(torch.int64).clamp(0, in_size - 1)
    hi = (lo + 1).clamp(0, in_size - 1)
    shape = [1] * x.dim()
    shape[axis] = out_size
    w = (src - lo.to(torch.float32)).to(x.dtype).reshape(shape)
    x_lo = x.index_select(axis, lo)
    x_hi = x.index_select(axis, hi)
    return x_lo + (x_hi - x_lo) * w


def trilinear_resize(x: torch.Tensor, out_spatial: tuple[int, int, int],
                     align_corners: bool = False,
                     spatial_axes: tuple[int, int, int] = (1, 2, 3)) -> torch.Tensor:
    """Resize the three spatial axes of a 5-D volume to `out_spatial`."""
    for axis, size in zip(spatial_axes, out_spatial):
        x = _axis_lerp(x, axis, size, align_corners)
    return x


def upsample2x(x: torch.Tensor, spatial_axes: tuple[int, int, int] = (1, 2, 3)) -> torch.Tensor:
    """Trilinear 2x upsample with half-pixel centers, in closed form:
    out[2i] = 0.25 x[i-1] + 0.75 x[i], out[2i+1] = 0.75 x[i] + 0.25 x[i+1],
    edges clamped."""
    for axis in spatial_axes:
        n = x.shape[axis]
        prev = torch.cat([x.narrow(axis, 0, 1), x.narrow(axis, 0, n - 1)], dim=axis)
        nxt = torch.cat([x.narrow(axis, 1, n - 1), x.narrow(axis, n - 1, 1)], dim=axis)
        even = 0.25 * prev + 0.75 * x
        odd = 0.75 * x + 0.25 * nxt
        st = torch.stack([even, odd], dim=axis + 1)
        x = st.reshape(*x.shape[:axis], 2 * n, *x.shape[axis + 1:])
    return x


def block_max(x: torch.Tensor, dims: tuple[int, ...]) -> torch.Tensor:
    """The max over `dims`, which hold the 8 voxels of a 2x2x2 block. Every
    max pool of the UNet3D takes it here, so that the card-against-CPU step
    check (train/device_check.py) can replace it."""
    return x.amax(dim=dims)


def max_pool_2x(x: torch.Tensor) -> torch.Tensor:
    """2x2x2 stride-2 max pool over the spatial axes of (B, D1, D2, D3, C)."""
    b, d1, d2, d3, c = x.shape
    return block_max(x.reshape(b, d1 // 2, 2, d2 // 2, 2, d3 // 2, 2, c), (2, 4, 6))


def avg_pool_nonoverlap(x: torch.Tensor, kernel: tuple[int, int, int]) -> torch.Tensor:
    """Non-overlapping average pool (kernel == stride) of a (B, D1, D2, D3)
    volume, the contrastive-mask downsampler: an exact mean via reshape,
    trailing remainders dropped (torch avg_pool3d's floor output size)."""
    b, d1, d2, d3 = x.shape
    k1, k2, k3 = kernel
    o1, o2, o3 = d1 // k1, d2 // k2, d3 // k3
    x = x[:, :o1 * k1, :o2 * k2, :o3 * k3]
    return x.reshape(b, o1, k1, o2, k2, o3, k3).mean(dim=(2, 4, 6))


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """Adaptive (1, 1, 1) average pool over the spatial axes of
    (B, D1, D2, D3, C), keeping them: (B, 1, 1, 1, C)."""
    return x.mean(dim=(1, 2, 3), keepdim=True)


def pad_to_shape(x: torch.Tensor, spatial: tuple[int, int, int]) -> torch.Tensor:
    """Zero-pad the spatial axes of (B, D1, D2, D3, C) up to `spatial`,
    split evenly (the extra voxel on the trailing side)."""
    pads = []
    for axis in (3, 2, 1):  # F.pad lists the last axis first
        extra = max(spatial[axis - 1] - x.shape[axis], 0)
        pads += [extra // 2, extra - extra // 2]
    return torch.nn.functional.pad(x, [0, 0] + pads)
