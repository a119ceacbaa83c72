"""Segmentation and consistency losses over channels-last tensors: logits
(B, D1, D2, D3, C), integer label maps (B, D1, D2, D3).

Counterpart of dycon_paper_replication_tpu/ops/losses.py: the losses the
train step uses, and the package's other losses (the probability-map
consistency losses, entropy, focal, symmetric MSE).
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy over all voxels; labels are class indices."""
    logp = F.log_softmax(logits, dim=-1)
    return -logp.gather(-1, labels[..., None].long()).mean()


def no_reduce(t: torch.Tensor) -> torch.Tensor:
    """The sums of one process: the identity."""
    return t


def dice_loss(score: torch.Tensor, target: torch.Tensor, smooth: float = 1e-5,
              reduce: Callable[[torch.Tensor], torch.Tensor] = no_reduce) -> torch.Tensor:
    """Soft binary Dice loss over the whole batch: `score` a foreground
    probability map, `target` a same-shape binary mask. `reduce` takes each
    of the three sums over the global batch in a data-parallel step
    (parallel.Shard.all_sum): the ratio of sums is not a mean over ranks."""
    target = target.to(score.dtype)
    intersect = reduce((score * target).sum())
    y_sum = reduce((target * target).sum())
    z_sum = reduce((score * score).sum())
    return 1.0 - (2.0 * intersect + smooth) / (z_sum + y_sum + smooth)


def dice_loss_nclass(probs: torch.Tensor, labels: torch.Tensor, num_classes: int,
                     smooth: float = 1e-5,
                     reduce: Callable[[torch.Tensor], torch.Tensor] = no_reduce) -> torch.Tensor:
    """Mean over classes of the soft Dice loss against one-hot labels;
    `reduce` as in dice_loss."""
    one_hot = F.one_hot(labels.long(), num_classes).to(probs.dtype)
    dims = tuple(range(probs.dim() - 1))
    intersect = reduce((probs * one_hot).sum(dim=dims))
    z_sum = reduce((probs * probs).sum(dim=dims))
    y_sum = reduce((one_hot * one_hot).sum(dim=dims))
    return (1.0 - (2.0 * intersect + smooth) / (z_sum + y_sum + smooth)).mean()


def softmax_mse_loss(input_logits: torch.Tensor, target_logits: torch.Tensor) -> torch.Tensor:
    """Elementwise (softmax(a) - softmax(b))^2, the caller reduces; no
    gradient to the target (the mean-teacher convention)."""
    a = torch.softmax(input_logits, dim=-1)
    b = torch.softmax(target_logits, dim=-1).detach()
    return (a - b) ** 2


def softmax_kl_loss(input_logits: torch.Tensor, target_logits: torch.Tensor) -> torch.Tensor:
    """KL(target || input), mean over ALL elements including the class axis
    (F.kl_div's reduction='mean'); no gradient to the target."""
    input_log = F.log_softmax(input_logits, dim=-1)
    target = torch.softmax(target_logits, dim=-1).detach()
    target_log = torch.log(target.clamp_min(1e-30))
    return (target * (target_log - input_log)).mean()


def mse_consistency_loss(input_probs: torch.Tensor, target_probs: torch.Tensor) -> torch.Tensor:
    """Mean squared difference of two probability maps (already softmaxed);
    no gradient to the target."""
    return ((input_probs - target_probs.detach()) ** 2).mean()


def kl_consistency_loss(input_probs: torch.Tensor, target_probs: torch.Tensor) -> torch.Tensor:
    """KL(target || input) on probability maps, mean over all elements; no
    gradient to the target."""
    target = target_probs.detach()
    return (target * (torch.log(target.clamp_min(1e-30))
                      - torch.log(input_probs.clamp_min(1e-30)))).mean()


def entropy_loss(probs: torch.Tensor, num_classes: int = 2) -> torch.Tensor:
    """Mean Shannon entropy of a probability map (..., C), normalised by
    log(num_classes)."""
    return (entropy_map(probs) / torch.log(torch.tensor(float(num_classes)))).mean()


def entropy_map(probs: torch.Tensor) -> torch.Tensor:
    """Per-voxel Shannon entropy of a probability map (..., C) -> (...)."""
    return -(probs * torch.log(probs + 1e-6)).sum(dim=-1)


def focal_loss(logits: torch.Tensor, labels: torch.Tensor, gamma: float = 2.0,
               alpha: torch.Tensor | None = None) -> torch.Tensor:
    """Multi-class focal loss, mean-reduced: logits (..., C), integer labels
    (...), `alpha` optional (C,) class weights; no gradient through p_t."""
    logpt = F.log_softmax(logits, dim=-1).gather(-1, labels[..., None].long())[..., 0]
    pt = logpt.detach().exp()
    if alpha is not None:
        logpt = logpt * torch.as_tensor(alpha, dtype=logits.dtype,
                                        device=logits.device)[labels.long()]
    return (-((1.0 - pt) ** gamma) * logpt).mean()


def symmetric_mse_loss(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Mean squared error with gradients to both inputs."""
    return ((a - b) ** 2).mean()
