"""Signed distance fields of binary masks, for SDF-head supervision.

Counterpart of dycon_paper_replication_tpu/ops/sdf.py, the reference's
`compute_sdf` (utils/util.py:205-236): per batch item, the distance to the
object's boundary, negative inside and positive outside, each side
normalised by its largest distance so the field lies in [-1, 1], 0 on the
boundary, and all 0 for an empty mask. Host-side (scipy's exact Euclidean
distance transform): nothing in the train step calls it, as in the JAX
package.
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage


def compute_sdf(segmentation: np.ndarray) -> np.ndarray:
    """(B, ...) masks (foreground > 0.5) -> (B, ...) float32 normalised SDF:
    dist_out / max(dist_out) - dist_in / max(dist_in), with the boundary
    (the foreground voxels an erosion by the face-connected structure
    removes) set to 0."""
    seg = np.asarray(segmentation) > 0.5
    out = np.zeros(seg.shape, np.float32)
    for b in range(seg.shape[0]):
        pos = seg[b]
        if not pos.any():
            continue
        dist_out = ndimage.distance_transform_edt(~pos)
        dist_in = ndimage.distance_transform_edt(pos)
        structure = ndimage.generate_binary_structure(pos.ndim, 1)
        boundary = pos & ~ndimage.binary_erosion(pos, structure, border_value=0)
        sdf = dist_out / max(dist_out.max(), 1e-8) - dist_in / max(dist_in.max(), 1e-8)
        sdf[boundary] = 0.0
        out[b] = sdf
    return out
