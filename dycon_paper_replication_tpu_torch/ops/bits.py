"""Bit packing of binary masks along their last axis.

Counterpart of dycon_paper_replication_tpu/ops/bits.py: `packbits_le` packs
a 0/1 tensor into uint8 on its device (little-endian bit order, the last axis
padded with zeros to a multiple of 8), `unpackbits_le` inverts it on the host
with numpy. The JAX package packs the train step's foreground mask for its
slow host link. The port's trainer does not: on the card, bringing one
train-HD95 step's (8, 96, 96, 96) BraTS foreground mask to the host as a
uint8 array takes 0.897 ms unpacked (one copy) and 1.913 ms packed (pack on
the card, copy an eighth of the bytes, unpack with numpy), the medians of
40 runs each by `scripts/profile_torch_train.py --config brats19`
(pred_fg_d2h_*_ms) on an NVIDIA H100 80GB HBM3 at 700 W: the host-side
unpack costs more than the copy it saves.
"""

from __future__ import annotations

import numpy as np
import torch

_WEIGHTS = (1, 2, 4, 8, 16, 32, 64, 128)


def packbits_le(x: torch.Tensor) -> torch.Tensor:
    """0/1 float/int/bool (..., n) -> uint8 (..., ceil(n / 8)), bit i of
    byte j holding element 8 j + i."""
    pad = (-x.shape[-1]) % 8
    xb = torch.nn.functional.pad(x.to(torch.uint8), (0, pad))
    xb = xb.reshape(*xb.shape[:-1], -1, 8)
    weights = torch.tensor(_WEIGHTS, dtype=torch.uint8, device=x.device)
    return (xb * weights).sum(dim=-1, dtype=torch.uint8)


def unpackbits_le(packed: np.ndarray, last_dim: int) -> np.ndarray:
    """Host inverse of `packbits_le`: uint8 (..., ceil(n / 8)) -> uint8 0/1
    (..., last_dim)."""
    return np.unpackbits(np.asarray(packed), axis=-1, bitorder="little")[..., :last_dim]
