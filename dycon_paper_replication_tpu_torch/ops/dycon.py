"""DyCON's two losses: UnCL (uncertainty-aware consistency) and dense FeCL
(focal voxel contrastive loss with the teacher cross-negative term).

Counterpart of `uncl_loss`, `fecl_loss` and `gambling_softmax` in
dycon_paper_replication_tpu/ops/dycon.py, with its behaviour kept where it
defines training:
  * UnCL's entropy penalty is mean(weighted diff) + beta * mean(H_s + H_t),
    the value of the reference's broadcast (B, B, ...) mean;
  * FeCL's max shift is the per-column max over axis -2, taken after the
    diagonal is zeroed, without gradient;
  * FeCL's positive focal threshold (1.3..1.5) lies above the similarity
    proxy's range (0, 1], so every positive pair is focal-weighted;
  * rows with no positive pair contribute 0 (an explicit guard);
  * the teacher cross term uses raw cosine similarity and clamps 1 - sim at
    0, so a similarity that rounds above 1 spikes the term instead of making
    it NaN.
The row-chunked FeCL (`fecl_loss_chunked`, ISLES) is not ported yet.
"""

from __future__ import annotations

import torch

_EPS_ENTROPY = 1e-6
_EPS_LOG = 1e-18


def uncl_loss(s_logits: torch.Tensor, t_logits: torch.Tensor, beta: float) -> torch.Tensor:
    """mean_vox[sum_c (p_s - p_t)^2 / (e^{beta H_s} + e^{beta H_t})]
    + beta * mean_vox[H_s + H_t], H = -sum_c p log(p + 1e-6); logits
    (B, D1, D2, D3, C) channels-last."""
    p_s = torch.softmax(s_logits, dim=-1)
    p_t = torch.softmax(t_logits, dim=-1)
    h_s = -(p_s * torch.log(p_s + _EPS_ENTROPY)).sum(dim=-1)
    h_t = -(p_t * torch.log(p_t + _EPS_ENTROPY)).sum(dim=-1)
    weight = torch.exp(beta * h_s) + torch.exp(beta * h_t)
    diff = ((p_s - p_t) ** 2).sum(dim=-1)
    return (diff / weight).mean() + beta * (h_s + h_t).mean()


def fecl_loss(feat: torch.Tensor, mask: torch.Tensor, teacher_feat: torch.Tensor | None = None,
              gambling_uncertainty: torch.Tensor | None = None, *, temperature: float = 0.6,
              gamma: float = 2.0, use_focal: bool = True, pos_thresh: float = 1.5,
              neg_thresh: float = 0.5, lambda_cross: float = 1.0) -> torch.Tensor:
    """Dense FeCL over (B, N, N) similarity matrices.

    feat: (B, N, D) L2-normalised student embeddings; mask: (B, N) class id
    per location; teacher_feat: optional (B, N, D) teacher embeddings (the
    caller detaches them); gambling_uncertainty: optional (B, N) weight of
    the positive term. Returns the student InfoNCE (focal-weighted when
    `use_focal`) + lambda_cross * the teacher hard-negative penalty."""
    n = feat.shape[1]
    dtype = feat.dtype
    same = (mask[:, :, None] == mask[:, None, :]).to(dtype)
    diff = 1.0 - same
    off_diag = 1.0 - torch.eye(n, dtype=dtype, device=feat.device)

    logits = torch.einsum("bnd,bmd->bnm", feat, feat) / temperature
    logits = logits * off_diag  # zero self-similarity before the max shift
    col_max = logits.amax(dim=-2, keepdim=True).detach()
    exp_logits = torch.exp(logits - col_max)

    neg_sum = (exp_logits * diff).sum(dim=-1, keepdim=True)
    division = exp_logits / (exp_logits + neg_sum + _EPS_LOG)
    loss_matrix = -torch.log(division + _EPS_LOG) * same * off_diag
    pos_count = same.sum(dim=-1) - 1.0
    has_pos = pos_count > 0

    def row_mean(row_sums):
        zero = torch.zeros((), dtype=row_sums.dtype, device=row_sums.device)
        return torch.where(has_pos, row_sums / pos_count.clamp_min(1.0), zero).mean()

    if use_focal:
        sim = division
        hard_pos = (same > 0) & (sim < pos_thresh)
        hard_neg = (diff > 0) & (sim > neg_thresh)
        focal = torch.where(hard_pos, (1.0 - sim) ** gamma,
                            torch.where(hard_neg, sim ** gamma, torch.ones_like(sim)))
        loss_student = row_mean((loss_matrix * focal).sum(dim=-1))
    else:
        loss_student = row_mean(loss_matrix.sum(dim=-1))

    if gambling_uncertainty is not None:
        zero = torch.zeros((), dtype=dtype, device=feat.device)
        per_patch = torch.where(has_pos, loss_matrix.sum(dim=-1) / pos_count.clamp_min(1.0), zero)
        loss_student = (per_patch * gambling_uncertainty).mean()

    if teacher_feat is None:
        return loss_student

    cross_sim = torch.einsum("bnd,bmd->bnm", feat, teacher_feat)
    cross_hard = ((diff > 0) & (cross_sim > neg_thresh)).to(dtype)
    # torch.maximum, not clamp_min: at a tie it splits the gradient as JAX does
    gap = torch.maximum(1.0 - cross_sim, torch.zeros((), dtype=dtype, device=feat.device))
    cross_term = -torch.log(gap + _EPS_LOG) * cross_hard
    loss_cross = cross_term.sum() / (cross_hard.sum() + _EPS_LOG)
    return loss_student + lambda_cross * loss_cross


def gambling_softmax(logits: torch.Tensor) -> torch.Tensor:
    """Softmax over the class axis with an epsilon-guarded denominator."""
    e = torch.exp(logits)
    return e / (e.sum(dim=-1, keepdim=True) + _EPS_LOG)
