"""Fold-2 (space-to-depth) execution of the UNet's small-channel levels.

Counterpart of dycon_paper_replication_tpu/ops/folding.py. A 2x2x2 spatial
block is folded into the channel axis (lane = c * 8 + sd * 4 + sh * 2 + sw,
channel-major), and a 3^3 SAME conv on folded data becomes a dense 2^3-tap
conv over the folded grid, provided input and output use alternating fold
phases:

  phase-0 block i of a length-n axis holds positions (2i, 2i+1), grid n/2;
  phase-1 block i holds positions (2i-1, 2i), grid n/2 + 1, where the
      positions -1 and n are padding.

  phase-0 -> phase-1: 2 taps per axis, padding (1, 1);
  phase-1 -> phase-0: 2 taps per axis, VALID;
  both with the folded taps M[t][s, o] = w[2t + s - o - 1] (zero when
  |2t + s - o - 1| > 1).

The phase-1 intermediate of a UnetConv3 block carries two boundary planes
per axis; they are kept out of the InstanceNorm statistics (division by the
true voxel count) and zeroed before the next conv, so folded == unfolded up
to float32 reassociation.

`folded_conv3` goes through the autograd Function `FoldedConv3Fn`
(ops/folded_conv_cuda.py) on every device, which dispatches on the device
alone: a CUDA tensor goes to the hand-written kernels (K1 forward; K1 and
K1-dW backward), a CPU tensor to their plain versions. The gradient to the
unfolded kernel and the bias flows through `fold_conv3_weights` and
`fold_bias` by autograd, as the JAX package's `folded_conv3_via_pallas`
does by JAX autodiff.

The VNet's fold-2 ops (models/vnet_folded.py) sit beside the UNet's:
`fold2_phase1` / `unfold2_phase1` (the input folded at phase 1, for conv
stacks of odd length), the strided and transposed 2^3 resamplers, each one
dense product per folded block, and `batch_norm_folded`. They are plain
torch, as their JAX counterparts are plain XLA outside any Pallas kernel.

`compute_dtype` (None or a torch dtype) is the JAX package's: the convs
cast their input and their weight to it and emit it, and each bias is cast
to the output's dtype before it is added (in bfloat16 the products sum in
float32 and round once; a bfloat16 tensor plus a float32 bias would be
float32 in torch, which is why the cast is explicit). The norms take float32
statistics and return the input's dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..parallel import mesh
from . import resize
from .folded_conv_cuda import FoldedConv3Fn, cast_operands

_SUBS = 8  # 2*2*2 sub-positions per folded block


def fold2(x: torch.Tensor) -> torch.Tensor:
    """(B, D, H, W, C) -> (B, D/2, H/2, W/2, 8C), phase-0, c-major lanes."""
    b, d, h, w, c = x.shape
    x = x.reshape(b, d // 2, 2, h // 2, 2, w // 2, 2, c)
    x = x.permute(0, 1, 3, 5, 7, 2, 4, 6)  # (..., C, sd, sh, sw)
    return x.reshape(b, d // 2, h // 2, w // 2, c * _SUBS)


def unfold2(x: torch.Tensor) -> torch.Tensor:
    """Inverse of fold2: (B, g1, g2, g3, 8C) -> (B, 2g1, 2g2, 2g3, C)."""
    b, g1, g2, g3, l = x.shape
    c = l // _SUBS
    x = x.reshape(b, g1, g2, g3, c, 2, 2, 2)
    x = x.permute(0, 1, 5, 2, 6, 3, 7, 4)  # (B, g1, sd, g2, sh, g3, sw, C)
    return x.reshape(b, 2 * g1, 2 * g2, 2 * g3, c)


def fold_conv3_weights(w: torch.Tensor) -> torch.Tensor:
    """(3, 3, 3, Ci, Co) -> folded taps (2, 2, 2, 8*Ci, 8*Co).

    Entry ((td,th,tw), (ci,sd,sh,sw), (co,od,oh,ow)) is
    w[delta_d+1, delta_h+1, delta_w+1, ci, co] with delta = 2t + s - o - 1
    per axis, and 0 where any |delta| > 1. One tensor serves both phase
    directions."""
    ci, co = w.shape[3], w.shape[4]
    t = torch.arange(2, device=w.device)
    delta = 2 * t[:, None, None] + t[None, :, None] - t[None, None, :] - 1  # (t, s, o)
    valid = delta.abs() <= 1
    idx = (delta + 1).clamp(0, 2)

    def ax(a, pos):  # place a (2,2,2) array on 3 of 9 axes
        return a.reshape([2 if i in pos else 1 for i in range(9)])

    # axis order: (td, sd, od, th, sh, oh, tw, sw, ow)
    wf = w[ax(idx, (0, 1, 2)), ax(idx, (3, 4, 5)), ax(idx, (6, 7, 8))]  # (2,)*9 + (Ci, Co)
    val = ax(valid, (0, 1, 2)) & ax(valid, (3, 4, 5)) & ax(valid, (6, 7, 8))
    wf = torch.where(val[..., None, None], wf, torch.zeros((), dtype=w.dtype, device=w.device))
    # -> (td, th, tw, Ci, sd, sh, sw, Co, od, oh, ow)
    wf = wf.permute(0, 3, 6, 9, 1, 4, 7, 10, 2, 5, 8)
    return wf.reshape(2, 2, 2, ci * _SUBS, co * _SUBS)


def fold_bias(b: torch.Tensor) -> torch.Tensor:
    """(C,) -> (8C,) c-major lane bias."""
    return b.repeat_interleave(_SUBS)


def folded_conv3(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None, *,
                 to_phase: int, compute_dtype: torch.dtype | None = None) -> torch.Tensor:
    """One 3^3 SAME conv on folded data.

    x: (B, G1, G2, G3, 8Ci), phase-0 if to_phase == 1, phase-1 if 0.
    w: the UNFOLDED (3, 3, 3, Ci, Co) kernel; b: (Co,) or None.
    Returns phase-1 at grid G+1 (to_phase=1) or phase-0 at grid G-1, in
    `compute_dtype` (x's dtype when None). The weight is folded in its own
    dtype, then cast, as `folded_conv3_via_pallas` does."""
    x, wf = cast_operands(x, fold_conv3_weights(w), compute_dtype)
    y = FoldedConv3Fn.apply(x.contiguous(), wf.contiguous(), to_phase)
    if b is not None:
        y = y + fold_bias(b).to(y.dtype)
    return y


def phase1_lane_masks(grid: tuple[int, int, int], c: int,
                      device: torch.device | str = "cpu") -> list[torch.Tensor]:
    """Factored phase-1 validity mask at full lane width.

    Three float32 factors of shapes (1, G1, 1, 1, 8C), (1, 1, G2, 1, 8C),
    (1, 1, 1, G3, 8C) whose product is the phase-1 validity mask. Lane k
    holds sub-position s = k % 8 with bits (sd, sh, sw); sub-bit 0 of an
    axis is the padding position -1 at block 0, bit 1 the position n at
    the last block."""
    sub = torch.arange(_SUBS * c, device=device) % _SUBS
    bits = (sub // 4, (sub // 2) % 2, sub % 2)
    out = []
    for axis, (g, bit) in enumerate(zip(grid, bits)):
        i = torch.arange(g, device=device)
        m = torch.where(bit[None, :] == 0, (i > 0)[:, None], (i < g - 1)[:, None])
        shape = [1, 1, 1, 1, _SUBS * c]
        shape[1 + axis] = g
        out.append(m.to(torch.float32).reshape(shape))
    return out


def instance_norm_folded(x: torch.Tensor, n_valid: int,
                         masks: list[torch.Tensor] | None = None,
                         eps: float = 1e-5) -> torch.Tensor:
    """InstanceNorm over a folded (B, G1, G2, G3, 8C) tensor.

    Per (sample, channel) statistics over all sub-positions and blocks in
    the one-pass E[x^2] - E[x]^2 form, divided by the TRUE voxel count
    `n_valid`. `masks` (phase1_lane_masks) keeps a phase-1 tensor's
    boundary planes out of the statistics and zeroes them on output."""
    b, g1, g2, g3, l = x.shape
    c = l // _SUBS
    xf = x.to(torch.float32)
    if masks is not None:
        for m in masks:
            xf = xf * m
    s1 = xf.sum(dim=(1, 2, 3))           # (B, 8C)
    s2 = xf.square().sum(dim=(1, 2, 3))  # (B, 8C)
    mean = s1.reshape(b, c, _SUBS).sum(-1) / n_valid
    var = s2.reshape(b, c, _SUBS).sum(-1) / n_valid - mean.square()
    scale = torch.rsqrt(var + eps)  # (B, C)
    scale_l = scale.repeat_interleave(_SUBS, dim=-1)[:, None, None, None, :]
    shift_l = (mean * scale).repeat_interleave(_SUBS, dim=-1)[:, None, None, None, :]
    y = x.to(torch.float32) * scale_l - shift_l
    if masks is not None:
        for m in masks:
            y = y * m
    return y.to(x.dtype)


def pool_consume_fold(x: torch.Tensor) -> torch.Tensor:
    """2^3 stride-2 max pool of a phase-0 folded tensor, UNFOLDED output:
    (B, G, G, G, 8C) -> (B, G, G, G, C), a max over the sub-positions."""
    b, g1, g2, g3, l = x.shape
    return resize.block_max(x.reshape(b, g1, g2, g3, l // _SUBS, _SUBS), (5,))


def pool_refold(x: torch.Tensor) -> torch.Tensor:
    """Max pool a phase-0 folded tensor and re-fold it for the next level:
    (B, G, G, G, 8C) -> (B, G/2, G/2, G/2, 8C)."""
    return fold2(pool_consume_fold(x))


def upsample2x_folded(x: torch.Tensor) -> torch.Tensor:
    """Trilinear 2x upsample (half-pixel centers, clamped edges) of an
    unfolded (B, g1, g2, g3, C) tensor, returned FOLDED phase-0 as
    (B, g1, g2, g3, 8C):
      out[2i] = 0.25 x[i-1] + 0.75 x[i];  out[2i+1] = 0.75 x[i] + 0.25 x[i+1]
    with the even/odd pair as a new minor sub axis, which lands the result
    directly in fold2's c-major lane order."""
    for axis in (1, 2, 3):
        n = x.shape[axis]
        prev = torch.cat([x.narrow(axis, 0, 1), x.narrow(axis, 0, n - 1)], dim=axis)
        nxt = torch.cat([x.narrow(axis, 1, n - 1), x.narrow(axis, n - 1, 1)], dim=axis)
        even = 0.25 * prev + 0.75 * x
        odd = 0.75 * x + 0.25 * nxt
        x = torch.stack([even, odd], dim=-1)
        x = x.reshape(*x.shape[:4], -1)
    return x


def conv1x1_folded(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None,
                   compute_dtype: torch.dtype | None = None) -> torch.Tensor:
    """1^3 conv on a folded tensor, per sub-position: x (B, G1, G2, G3, 8Ci),
    w (1, 1, 1, Ci, Co) -> (B, G1, G2, G3, 8Co), class-major lanes."""
    b_, g1, g2, g3, l = x.shape
    ci = l // _SUBS
    x, w = cast_operands(x, w, compute_dtype)
    y = torch.einsum("bdhwcs,cn->bdhwns", x.reshape(b_, g1, g2, g3, ci, _SUBS),
                     w.reshape(ci, -1))
    y = y.reshape(b_, g1, g2, g3, -1)
    if b is not None:
        y = y + fold_bias(b).to(y.dtype)
    return y


def fold2_phase1(x: torch.Tensor) -> torch.Tensor:
    """(B, D, H, W, C) -> PHASE-1 folded (B, D/2+1, H/2+1, W/2+1, 8C).

    Phase-1 block i holds positions (2i-1, 2i); positions -1 and D are zero
    padding, so a phase-1 -> phase-0 (VALID) folded conv of this tensor is
    the SAME-padded 3^3 conv. The input fold of conv stacks with an odd
    number of convs (VNet's enc0 and dec3): every block boundary then lands
    on phase 0, where the strided 2^3 resamplers consume blocks."""
    return fold2(F.pad(x, (0, 0, 1, 1, 1, 1, 1, 1)))


def unfold2_phase1(x: torch.Tensor) -> torch.Tensor:
    """Inverse of fold2_phase1: unfold and drop the boundary planes."""
    return unfold2(x)[:, 1:-1, 1:-1, 1:-1, :]


def strided_conv2_folded(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None, *,
                         compute_dtype: torch.dtype | None = None,
                         fold_output: bool = True) -> torch.Tensor:
    """2^3 stride-2 conv of a phase-0 folded tensor.

    Stride-2 windows are exactly the phase-0 blocks, so the conv is one
    dense (8Ci, Co) product per block. x (B, G1, G2, G3, 8Ci), w (2, 2, 2,
    Ci, Co) DHWIO -> the half-resolution output (B, G1, G2, G3, Co), or
    refolded phase-0 (B, G1/2, G2/2, G3/2, 8Co) with `fold_output`."""
    ci = x.shape[-1] // _SUBS
    x, w = cast_operands(x, w, compute_dtype)
    # lane k = c * 8 + (qd * 4 + qh * 2 + qw)  ->  W[(c, q), co] = w[q, c, co]
    y = x @ w.permute(3, 0, 1, 2, 4).reshape(ci * _SUBS, -1)
    if b is not None:
        y = y + b.to(y.dtype)
    return fold2(y) if fold_output else y


def transposed_conv2_to_folded(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None, *,
                               compute_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Transposed 2^3 stride-2 conv with FOLDED phase-0 output.

    Each input voxel emits one whole 2x2x2 output block, one phase-0 folded
    block: one dense (Ci, 8Co) product. x (B, g1, g2, g3, Ci) unfolded ->
    (B, g1, g2, g3, 8Co), equal to fold2 of models/layers.conv_transpose3d.
    Output sub-position p takes tap 1 - p: the JAX layer's
    lax.conv_transpose (transpose_kernel=False) mirrors the kernel."""
    ci = x.shape[-1]
    x, w = cast_operands(x, w, compute_dtype)
    y = x @ w.flip(0, 1, 2).permute(3, 4, 0, 1, 2).reshape(ci, -1)
    if b is not None:
        y = y + fold_bias(b).to(y.dtype)
    return y


def batch_norm_folded(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                      mean: torch.Tensor, var: torch.Tensor, n_valid: int,
                      masks: list[torch.Tensor] | None = None, *, train: bool,
                      momentum: float = 0.1, eps: float = 1e-5):
    """BatchNorm over a folded (B, G1, G2, G3, 8C) tensor, with the numerics
    of models/layers.batch_norm_train (train) and batch_norm (eval).

    Statistics in float32 over batch and space, divided by the TRUE voxel
    count B * `n_valid`, the variance in two passes; `masks`
    (phase1_lane_masks) keep a phase-1 tensor's boundary planes out of both
    passes and zero them on output, so the next folded conv reads zeros
    there. Returns (y, new_mean, new_var): in train mode the running stats
    moved by `momentum` towards the batch mean and the unbiased variance
    (detached), in eval mode `mean` and `var` themselves. Inside a
    data-parallel step (parallel.sharded) both passes' sums are cross-rank
    sums over the global count, as in models/layers.batch_norm_train."""
    b, g1, g2, g3, l = x.shape
    c = l // _SUBS
    n = b * n_valid
    shard = mesh.active()
    reduce = (lambda t: t) if shard is None else shard.all_sum
    if shard is not None:  # a data-parallel step: the global batch's statistics
        n *= shard.world
    xf = x.to(torch.float32)
    if masks is not None:
        for m in masks:
            xf = xf * m
    if train:
        b_mean = reduce(xf.sum(dim=(0, 1, 2, 3)).reshape(c, _SUBS).sum(-1)) / n
        cent = xf - b_mean.repeat_interleave(_SUBS)
        if masks is not None:
            for m in masks:
                cent = cent * m
        b_var = reduce(cent.square().sum(dim=(0, 1, 2, 3)).reshape(c, _SUBS).sum(-1)) / n
        unbiased = b_var.detach() * (n / max(n - 1, 1))
        new_mean = (1 - momentum) * mean + momentum * b_mean.detach()
        new_var = (1 - momentum) * var + momentum * unbiased
    else:
        b_mean, b_var, new_mean, new_var = mean, var, mean, var
    k = torch.rsqrt(b_var + eps) * scale
    shift = bias - b_mean * k
    y = x.to(torch.float32) * k.repeat_interleave(_SUBS) + shift.repeat_interleave(_SUBS)
    if masks is not None:
        for m in masks:
            y = y * m
    return y.to(x.dtype), new_mean, new_var
