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
`fecl_loss_chunked` is the same FeCL over row tiles (the `fecl_impl=
"chunked"` path of the train step): the B x N x N matrices exist one tile
at a time, and each tile's terms run under torch.utils.checkpoint, so the
backward recomputes them instead of storing them. Its `cs > neg_thresh`
test, and the dense FeCL's, goes through the fused FeCL's `cross_side`
hook when that is set (ops/fecl_fused.py; set only by kink sharing:
train/device_check.py and the JAX parity tests).
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from . import fecl_fused

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
              neg_thresh: float = 0.5, lambda_cross: float = 1.0,
              shard=None) -> torch.Tensor:
    """Dense FeCL over (B, N, N) similarity matrices.

    feat: (B, N, D) L2-normalised student embeddings; mask: (B, N) class id
    per location; teacher_feat: optional (B, N, D) teacher embeddings (the
    caller detaches them); gambling_uncertainty: optional (B, N) weight of
    the positive term. Returns the student InfoNCE (focal-weighted when
    `use_focal`) + lambda_cross * the teacher hard-negative penalty. With
    `shard` (a data-parallel step, parallel.Shard) it returns this rank's
    term of the global value: the student mean over the global batch, the
    cross term's sum over the global count of hard pairs."""
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
    if shard is not None:
        loss_student = loss_student * (feat.shape[0] / shard.global_batch)

    if teacher_feat is None:
        return loss_student

    cross_sim = torch.einsum("bnd,bmd->bnm", feat, teacher_feat)
    above = cross_sim > neg_thresh
    if fecl_fused.cross_side is not None:
        above = fecl_fused.cross_side(slice(0, n), cross_sim, neg_thresh, above)
    cross_hard = ((diff > 0) & above).to(dtype)
    # torch.maximum, not clamp_min: at a tie it splits the gradient as JAX does
    gap = torch.maximum(1.0 - cross_sim, torch.zeros((), dtype=dtype, device=feat.device))
    cross_term = -torch.log(gap + _EPS_LOG) * cross_hard
    count = cross_hard.sum()
    if shard is not None:
        count = shard.all_sum_(count.detach().clone())
    loss_cross = cross_term.sum() / (count + _EPS_LOG)
    return loss_student + lambda_cross * loss_cross


def fecl_loss_chunked(feat: torch.Tensor, mask: torch.Tensor,
                      teacher_feat: torch.Tensor | None = None,
                      gambling_uncertainty: torch.Tensor | None = None, *,
                      temperature: float = 0.6, gamma: float = 2.0, use_focal: bool = True,
                      pos_thresh: float = 1.5, neg_thresh: float = 0.5,
                      lambda_cross: float = 1.0, row_chunk: int = 512,
                      shard=None) -> torch.Tensor:
    """`fecl_loss` over row tiles of `row_chunk` (JAX `fecl_loss_chunked`);
    `shard` as in fecl_loss.

    The column max is a first pass over the tiles, without gradient; then
    each tile's student and cross terms are computed under
    torch.utils.checkpoint and summed. When N is not a multiple of
    `row_chunk` the row axis is padded with zero rows of sentinel class -1:
    the pad is kept out of every positive and negative set, and the student
    mean divides by the true N."""
    b, n_true, _ = feat.shape
    dtype = feat.dtype
    mask = mask.to(dtype)
    pad = -n_true % row_chunk
    if pad:
        feat = torch.nn.functional.pad(feat, (0, 0, 0, pad))
        mask = torch.cat([mask, torch.full((b, pad), -1.0, dtype=dtype, device=feat.device)], 1)
        if teacher_feat is not None:
            teacher_feat = torch.nn.functional.pad(teacher_feat, (0, 0, 0, pad))
        if gambling_uncertainty is not None:
            gambling_uncertainty = torch.nn.functional.pad(gambling_uncertainty, (0, pad))
    n = feat.shape[1]
    ids = torch.arange(n, device=feat.device)
    col_valid = (ids < n_true).to(dtype)

    with torch.no_grad():
        col_max = torch.full((b, n), -torch.inf, dtype=dtype, device=feat.device)
        for k in range(0, n, row_chunk):
            lt = torch.einsum("btd,bnd->btn", feat[:, k:k + row_chunk], feat) / temperature
            lt = lt * (ids[k:k + row_chunk, None] != ids[None, :]).to(dtype)
            col_max = torch.maximum(col_max, lt.amax(dim=1))

    def tile_terms(f_t, feat_all, tfeat_all, g_t, k):
        rows = ids[k:k + row_chunk]
        m_t = mask[:, k:k + row_chunk]
        same = (m_t[:, :, None] == mask[:, None, :]).to(dtype)
        diff = (1.0 - same) * col_valid
        off = (rows[:, None] != ids[None, :]).to(dtype)
        lt = torch.einsum("btd,bnd->btn", f_t, feat_all) / temperature
        e = torch.exp(lt * off - col_max[:, None, :])
        neg_sum = (e * diff).sum(dim=-1, keepdim=True)
        division = e / (e + neg_sum + _EPS_LOG)
        loss_mat = -torch.log(division + _EPS_LOG) * same * off
        pos_count = same.sum(dim=-1) - 1.0
        if use_focal and g_t is None:
            hard_pos = (same > 0) & (division < pos_thresh)
            hard_neg = (diff > 0) & (division > neg_thresh)
            focal = torch.where(hard_pos, (1.0 - division) ** gamma,
                                torch.where(hard_neg, division ** gamma,
                                            torch.ones_like(division)))
            row_sum = (loss_mat * focal).sum(dim=-1)
        else:
            row_sum = loss_mat.sum(dim=-1)
        zero = torch.zeros((), dtype=dtype, device=feat.device)
        row_mean = torch.where(pos_count > 0, row_sum / pos_count.clamp_min(1.0), zero)
        row_mean = row_mean * (rows < n_true).to(dtype)
        if g_t is not None:
            row_mean = row_mean * g_t
        student = row_mean.sum()
        if tfeat_all is None:
            return student, zero, zero
        cs = torch.einsum("btd,bnd->btn", f_t, tfeat_all)
        above = cs > neg_thresh
        if fecl_fused.cross_side is not None:
            above = fecl_fused.cross_side(slice(k, k + row_chunk), cs, neg_thresh, above)
        hard = ((diff > 0) & above & (rows < n_true)[None, :, None]).to(dtype)
        gap = torch.maximum(1.0 - cs, zero)
        return student, (-torch.log(gap + _EPS_LOG) * hard).sum(), hard.sum()

    student = cross = count = 0.0
    for k in range(0, n, row_chunk):
        g_t = None if gambling_uncertainty is None else gambling_uncertainty[:, k:k + row_chunk]
        s, c, h = checkpoint(tile_terms, feat[:, k:k + row_chunk], feat, teacher_feat, g_t, k,
                             use_reentrant=False)
        student, cross, count = student + s, cross + c, count + h
    loss_student = student / ((b if shard is None else shard.global_batch) * n_true)
    if teacher_feat is None:
        return loss_student
    if shard is not None:
        count = shard.all_sum_(count.detach().clone())
    return loss_student + lambda_cross * cross / (count + _EPS_LOG)


def gambling_softmax(logits: torch.Tensor) -> torch.Tensor:
    """Softmax over the class axis with an epsilon-guarded denominator."""
    e = torch.exp(logits)
    return e / (e.sum(dim=-1, keepdim=True) + _EPS_LOG)
