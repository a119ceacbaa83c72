"""UNet3D forward in fold-2 (space-to-depth) execution.

Counterpart of dycon_paper_replication_tpu/models/unet3d_folded.py. The same
module and weights as the plain path, the same outputs to float32
tolerance, but levels 1 and 2 (C = f0 at full resolution, f1 at half) run
folded: each 2x2x2 block lives in the channel axis and every 3^3 conv there
is a dense 2^3-tap conv over the folded grid (ops/folding.py), which on the
card is the hand-written kernel K1. Levels 3 to center and the two deepest
decoder stages keep the plain channels-last path.
"""

from __future__ import annotations

import torch

from . import layers
from ..ops.folding import (
    conv1x1_folded,
    fold2,
    folded_conv3,
    instance_norm_folded,
    phase1_lane_masks,
    pool_consume_fold,
    pool_refold,
    unfold2,
    upsample2x_folded,
)
from ..ops.resize import max_pool_2x, upsample2x


def _folded_block(block, x: torch.Tensor, *, grid, n_valid: int) -> torch.Tensor:
    """UnetConv3 on folded data: conv(0->1) + IN + ReLU + conv(1->0) + IN +
    ReLU. x (B, *grid, 8Ci) phase-0 -> (B, *grid, 8Co) phase-0. The lane
    masks keep the phase-1 boundary planes out of the statistics and zero
    them for the second conv."""
    co = block.conv1.w.shape[4]
    masks = phase1_lane_masks(tuple(g + 1 for g in grid), co, device=x.device)
    h = folded_conv3(x, block.conv1.w, block.conv1.b, to_phase=1)
    h = layers.relu(instance_norm_folded(h, n_valid, masks=masks))
    h = folded_conv3(h, block.conv2.w, block.conv2.b, to_phase=0)
    return layers.relu(instance_norm_folded(h, n_valid))


def unet3d_trunk_folded(net, xf: torch.Tensor, *,
                        generator: torch.Generator | None = None):
    """Encoder + decoder on FOLDED input, FOLDED output.

    xf: (B, G1, G2, G3, 8*in_ch) phase-0 (grid dims % 8 == 0). Returns
    (h, center): h the last decoder map, folded phase-0 (B, *G, 8*f0);
    center the unfolded bottleneck for the projection head."""
    _, G1, G2, G3, _ = xf.shape
    if G1 % 8 or G2 % 8 or G3 % 8:
        raise ValueError(f"folded grid {(G1, G2, G3)} must be divisible by 8")
    train = net.training
    rate = net.cfg.dropout_rate
    g1 = (G1, G2, G3)
    g2 = tuple(g // 2 for g in g1)
    n1 = 8 * G1 * G2 * G3
    n2 = n1 // 8

    # folded encoder levels 1-2
    s1 = _folded_block(net.conv1, xf, grid=g1, n_valid=n1)
    s2 = _folded_block(net.conv2, pool_refold(s1), grid=g2, n_valid=n2)
    h = pool_consume_fold(s2)  # unfolded level-3 input

    # unfolded middle
    s3 = net.conv3(h)
    s4 = net.conv4(max_pool_2x(s3))
    center = layers.dropout(net.center(max_pool_2x(s4)), rate, generator, train)
    h = center
    for block, skip in ((net.up_concat4, s4), (net.up_concat3, s3)):
        h = block(torch.cat([skip, upsample2x(h)], dim=-1))

    # folded decoder levels 2-1, skip first as in the plain path
    h = torch.cat([s2, upsample2x_folded(h)], dim=-1)
    h = _folded_block(net.up_concat2, h, grid=g2, n_valid=n2)
    h = torch.cat([s1, upsample2x_folded(unfold2(h))], dim=-1)
    h = _folded_block(net.up_concat1, h, grid=g1, n_valid=n1)
    h = layers.dropout(h, rate, generator, train)
    return h, center


def unet3d_seg_folded_io(net, xf: torch.Tensor) -> torch.Tensor:
    """Eval-mode seg head with folded input AND output: xf (B, *G, 8*in_ch)
    phase-0 -> (B, *G, 8*n_classes) float32 with class-major lanes
    (lane = class * 8 + sub-position), equal to fold2 of the plain logits."""
    h, _ = unet3d_trunk_folded(net, xf)
    return conv1x1_folded(h, net.out_conv2.w, net.out_conv2.b).to(torch.float32)


def unet3d_apply_folded(net, x: torch.Tensor, *, with_projection: bool = True,
                        generator: torch.Generator | None = None):
    """The folded forward with the plain path's interface: x (B, D, H, W,
    in_ch), D, H, W % 16 == 0 -> (sdf, seg, features or None)."""
    from .unet3d import projection_head

    _, D, H, W, _ = x.shape
    if D % 16 or H % 16 or W % 16:
        raise ValueError(f"spatial dims {(D, H, W)} must be divisible by 16")
    h, center = unet3d_trunk_folded(net, fold2(x), generator=generator)
    sdf = torch.tanh(unfold2(conv1x1_folded(h, net.final.w, net.final.b)).to(torch.float32))
    seg = unfold2(conv1x1_folded(h, net.out_conv2.w, net.out_conv2.b)).to(torch.float32)
    features = (projection_head(net, center, generator=generator) if with_projection
                else None)
    return sdf, seg, features
