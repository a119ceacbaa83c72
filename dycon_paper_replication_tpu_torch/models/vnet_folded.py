"""V-Net forward in fold-2 (space-to-depth) execution.

Counterpart of dycon_paper_replication_tpu/models/vnet_folded.py. The same
module and weights as the plain path (models/vnet.py), the same outputs and
BatchNorm statistics to float32 tolerance, but the two small-channel levels
(L0: n_filters at full resolution, L1: 2 n_filters at half) run folded.

V-Net's blocks have odd conv counts at both ends (enc0 and dec3 are single
3^3 convs) and resample with strided and transposed 2^3 convs, so the
input is folded at PHASE 1 and every block boundary lands on phase 0:

  input fold (phase 1) -> enc0 conv (1 -> 0) -> s0 at phase 0
  -> strided 2^3 conv, one dense product per phase-0 block -> L1, refolded
  -> enc1 convs (0 -> 1 -> 0) -> s1 at phase 0 -> strided conv -> plain L2
  ... plain middle (enc2..enc4, dec0, dec1: cuDNN) ...
  transposed 2^3 conv emits whole 2x2x2 blocks = folded phase-0 L1
  -> (+ s1) -> dec2 convs (0 -> 1 -> 0) -> transposed conv -> (+ s0)
  -> dec3 conv (0 -> 1) -> heads on phase 1 -> unfold once.

The six folded 3^3 convs (enc0, enc1 x 2, dec2 x 2, dec3) go through
ops/folding.folded_conv3, which is K1 forward and K1 dx / K1-dW backward on
the card. BatchNorm runs folded over the true voxel count, with the
factored phase-1 masks on phase-1 tensors (ops/folding.batch_norm_folded).
"""

from __future__ import annotations

import torch

from . import layers
from ..ops.folding import (
    batch_norm_folded,
    conv1x1_folded,
    fold2_phase1,
    folded_conv3,
    phase1_lane_masks,
    strided_conv2_folded,
    transposed_conv2_to_folded,
    unfold2,
    unfold2_phase1,
)


def _bn_folded(bn: layers.BatchNorm, x: torch.Tensor, n_valid: int,
               masks: list[torch.Tensor] | None = None) -> torch.Tensor:
    """`bn` over a folded tensor, in the module's mode; in training mode its
    running stats take the batch's update, as layers.BatchNorm does."""
    y, mean, var = batch_norm_folded(x, bn.scale, bn.bias, bn.mean, bn.var, n_valid, masks,
                                     train=bn.training)
    if bn.training:
        layers.update_running_stats(bn, mean, var)
    return y


def _folded_stack(block, x: torch.Tensor, *, grid: tuple[int, int, int], n_valid: int,
                  cd: torch.dtype | None = None, start_phase: int = 0) -> torch.Tensor:
    """A ConvBlock on folded data, x at `start_phase`; each conv toggles the
    phase. `grid` is the PHASE-0 grid (phase-1 tensors live at grid + 1)."""
    phase = start_phase
    for i in range(block.n_stages):
        to_phase = 1 - phase
        conv = getattr(block, f"conv{i}")
        h = folded_conv3(x, conv.w, conv.b, to_phase=to_phase, compute_dtype=cd)
        masks = (phase1_lane_masks(tuple(g + 1 for g in grid), conv.w.shape[4], device=x.device)
                 if to_phase == 1 else None)
        x = layers.relu(_bn_folded(getattr(block, f"bn{i}"), h, n_valid, masks))
        phase = to_phase
    return x


def vnet_apply_folded(net, x: torch.Tensor, *, with_projection: bool = True, key=None):
    """The folded forward with the plain path's interface: x (B, D, H, W,
    in_ch), D, H, W % 16 == 0 -> (sdf, seg, features or None)."""
    from .unet3d import dropout_keys, projection_head

    _, D, H, W, _ = x.shape
    if D % 16 or H % 16 or W % 16:
        raise ValueError(f"spatial dims {(D, H, W)} must be divisible by 16")
    train, rate, cd = net.training, net.cfg.dropout_rate, net.cfg.compute_dtype
    d1_key, d2_key = dropout_keys(key, train, 2)
    g0 = (D // 2, H // 2, W // 2)  # L0 folded grid (phase 0)
    g1 = tuple(g // 2 for g in g0)  # L1 folded grid
    n0 = D * H * W
    n1 = n0 // 8

    # folded encoder: L0 (enc0 + down0) and L1 (enc1 + down1)
    s0 = _folded_stack(net.enc0, fold2_phase1(x), grid=g0, n_valid=n0, cd=cd, start_phase=1)
    h = strided_conv2_folded(s0, net.down0.conv.w, net.down0.conv.b, compute_dtype=cd)
    h = layers.relu(_bn_folded(net.down0.bn, h, n1))
    s1 = _folded_stack(net.enc1, h, grid=g1, n_valid=n1, cd=cd)
    h = strided_conv2_folded(s1, net.down1.conv.w, net.down1.conv.b, compute_dtype=cd,
                             fold_output=False)
    h = layers.relu(net.down1.bn(h))  # unfolded L2

    # plain middle: enc2..enc4 (+ down2, down3), dec0, dec1 (+ up0, up1)
    skips = []
    for lvl in (2, 3, 4):
        h = getattr(net, f"enc{lvl}")(h)
        if lvl < 4:
            skips.append(h)
            h = getattr(net, f"down{lvl}")(h)
    center = layers.dropout(h, rate, d1_key, train)
    h = center
    for lvl in (0, 1):
        h = getattr(net, f"up{lvl}")(h)
        h = getattr(net, f"dec{lvl}")(h + skips[1 - lvl].to(h.dtype))

    # folded decoder: up2 / dec2 (L1), up3 / dec3 (L0)
    h = transposed_conv2_to_folded(h, net.up2.conv.w, net.up2.conv.b, compute_dtype=cd)
    h = layers.relu(_bn_folded(net.up2.bn, h, n1))
    h = _folded_stack(net.dec2, h + s1.to(h.dtype), grid=g1, n_valid=n1, cd=cd)
    h = transposed_conv2_to_folded(unfold2(h), net.up3.conv.w, net.up3.conv.b, compute_dtype=cd)
    h = layers.relu(_bn_folded(net.up3.bn, h, n0))
    # ends at phase 1, grid g0 + 1
    h = _folded_stack(net.dec3, h + s0.to(h.dtype), grid=g0, n_valid=n0, cd=cd)
    h = layers.dropout(h, rate, d2_key, train)

    def head(conv):
        return unfold2_phase1(conv1x1_folded(h, conv.w, conv.b, cd)).to(torch.float32)

    seg = head(net.out_conv)
    sdf = torch.tanh(head(net.out_conv_sdf))
    features = projection_head(net, center) if with_projection else None
    return sdf, seg, features
