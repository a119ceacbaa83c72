"""The DyCON train step.

Counterpart of dycon_paper_replication_tpu/train/step.py:
  noise on the teacher input -> teacher forward (no gradient, train mode,
  dropout) -> student forward -> CE + binary Dice on the labeled slice ->
  FeCL over the L2-normalised projection embeddings with the pooled label
  mask -> UnCL -> double-softmax consistency on the unlabeled slice ->
  weighted sum -> backward -> clip, weight decay, momentum, lr -> EMA
  teacher -> NaN/Inf skip -> train Dice.

The batch layout is the two-stream sampler's: labeled samples first
(batch[:labeled_bs]). Image (B, D1, D2, D3, 1) float32, label
(B, D1, D2, D3) integer, on the model's device.

One `torch.Generator` on that device draws the step's randomness: the
teacher noise clip(0.1 N(0, 1), +-0.2), then the teacher's dropout, then the
student's. The noise can also be passed in, so a test can hand both
packages the same numbers. The NaN/Inf check reads the loss on the host,
one sync per step. FeCL is dense at `fecl_chunk` 0; above it, over row
tiles of `fecl_chunk` through `fecl_impl` "fused" (ops/fecl_fused.py: the
closed-form backward, the kernel K2 on the card) or "chunked"
(ops/dycon.py:fecl_loss_chunked).

Beside the scalars, every step returns the outputs the trainer reads on
its train-HD95 and monitor iterations (the JAX full step's): the student's
foreground `pred_fg` (s_probs[..., 1] > 0.5, uint8), its L2-normalised
`embedding` (B, N, D) and the pooled FeCL mask `mask_con` (B, N). They are
tensors the step computes anyway, so the JAX light/full pair, which saves
compiling a second program, has no eager counterpart. Not ported: `remat`.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from ..config import TrainConfig
from ..ops import dycon, fecl_fused, losses
from ..ops.resize import avg_pool_nonoverlap
from .state import TrainState, ema_update, sgd_update

# order of the per-step scalar vector a step returns
SCALAR_METRICS = ("loss", "loss_ce", "loss_dice", "f_loss", "u_loss", "consistency_loss",
                  "train_dice", "skipped")


class StepScalars(NamedTuple):
    """Per-step schedule values, computed on the host."""

    beta: float
    consistency_weight: float
    pos_thresh: float
    neg_thresh: float


def normalized_embeddings(features: torch.Tensor) -> torch.Tensor:
    """(B, d1, d2, d3, C) projection map -> (B, N, C) L2-normalised rows."""
    flat = features.reshape(features.shape[0], -1, features.shape[-1])
    return flat / torch.linalg.vector_norm(flat, dim=-1, keepdim=True).clamp_min(1e-12)


def mask_kernel(cfg: TrainConfig, image_spatial, feat_spatial) -> tuple[int, int, int]:
    """The mask's pool kernel: feature_scaler * 4 per axis ("fixed",
    BraTS/Pancreas) or image / feature size per axis ("derived", ISLES)."""
    if cfg.mask_kernel_mode == "fixed":
        k = cfg.feature_scaler * 4
        return (k, k, k)
    return tuple(i // f for i, f in zip(image_spatial, feat_spatial))


def ema_alpha(step: int, decay: float) -> float:
    """min(1 - 1 / (step + 1), decay) in float32, from the step before the
    increment (0 at the first step: the teacher takes the student's
    weights)."""
    one = np.float32(1.0)
    return float(min(one - one / (np.float32(step) + one), np.float32(decay)))


def build_train_step(cfg: TrainConfig, lr_schedule: Callable[[int], float]) -> Callable:
    """train_step(state, batch, generator, scalars, noise=None) -> (the
    float32 vector of SCALAR_METRICS on the device, {"pred_fg",
    "embedding", "mask_con"}); `state` is updated in place. `lr_schedule`
    maps the step count to the learning rate."""
    lbs = cfg.labeled_bs

    def loss_fn(student, image, label, t_logits, t_features, generator, scalars: StepScalars):
        _, s_logits, s_features = student(image, generator=generator)
        s_probs = torch.softmax(s_logits, dim=-1)
        t_probs = torch.softmax(t_logits, dim=-1)

        loss_ce = losses.cross_entropy_loss(s_logits[:lbs], label[:lbs])
        if cfg.dice_loss_kind == "binary":
            loss_dice = losses.dice_loss(s_probs[:lbs, ..., 1], label[:lbs] == 1)
        else:
            loss_dice = losses.dice_loss_nclass(s_probs[:lbs], label[:lbs], cfg.num_classes)

        stud_emb = normalized_embeddings(s_features)
        kernel = mask_kernel(cfg, image.shape[1:4], s_features.shape[1:4])
        mask = avg_pool_nonoverlap(label.to(torch.float32), kernel)
        mask = (mask > 0.5).to(torch.float32).reshape(label.shape[0], -1)
        teacher_emb = normalized_embeddings(t_features) if cfg.use_teacher_loss else None
        fecl_kwargs = dict(temperature=cfg.temp, gamma=cfg.gamma, use_focal=bool(cfg.use_focal),
                           pos_thresh=scalars.pos_thresh, neg_thresh=scalars.neg_thresh)
        if cfg.fecl_chunk > 0 and cfg.fecl_impl == "fused":
            # the teacher embeddings come from a no-grad forward and the mask
            # is binary, as the closed-form backward requires
            f_loss = fecl_fused.fecl_loss_fused(stud_emb, mask, teacher_emb,
                                                row_chunk=cfg.fecl_chunk, **fecl_kwargs)
        elif cfg.fecl_chunk > 0:
            f_loss = dycon.fecl_loss_chunked(stud_emb, mask, teacher_emb,
                                             row_chunk=cfg.fecl_chunk, **fecl_kwargs)
        else:
            f_loss = dycon.fecl_loss(stud_emb, mask, teacher_emb, **fecl_kwargs)

        u_loss = dycon.uncl_loss(s_logits, t_logits, scalars.beta)
        # The reference feeds already-softmaxed probabilities into the
        # softmax consistency losses, which softmax them again; kept, since
        # it sets the size of the term.
        if cfg.consistency_type == "mse":
            cons = losses.softmax_mse_loss(s_probs[lbs:], t_probs[lbs:]).mean()
        else:
            cons = losses.softmax_kl_loss(s_probs[lbs:], t_probs[lbs:])

        total = (cfg.l_weight * (loss_ce + loss_dice) + scalars.consistency_weight * cons
                 + cfg.u_weight * (f_loss + u_loss))
        return total, (loss_ce, loss_dice, f_loss, u_loss, cons), (s_probs, stud_emb, mask)

    def train_step(state: TrainState, batch: dict, generator: torch.Generator,
                   scalars: StepScalars, noise: torch.Tensor | None = None):
        image = batch["image"].to(torch.float32)
        label = batch["label"].long()
        if noise is None:
            noise = torch.randn(image.shape, generator=generator, device=image.device)
            noise = (0.1 * noise).clamp(-0.2, 0.2)
        teacher = state.teacher.train(cfg.teacher_train_mode)
        with torch.no_grad():
            _, t_logits, t_features = teacher(
                image + noise, generator=generator if cfg.teacher_train_mode else None)

        student = state.student.train()
        stats = {k: b.clone() for k, b in student.named_buffers()}
        student.zero_grad(set_to_none=True)
        total, parts, (s_probs, stud_emb, mask) = loss_fn(student, image, label, t_logits,
                                                          t_features, generator, scalars)
        total.backward()

        # NaN/Inf guard: drop the whole update (parameters, student stats,
        # momentum, teacher EMA, step), as the reference's `continue`; the
        # teacher's stats still advance, its forward has run.
        bad = not bool(torch.isfinite(total.detach()))
        if bad:
            with torch.no_grad():
                for k, b in student.named_buffers():
                    b.copy_(stats[k])
        else:
            sgd_update(state, lr_schedule(state.step), cfg.momentum, cfg.weight_decay,
                       cfg.grad_clip_norm)
            ema_update(state.teacher, student, ema_alpha(state.step, cfg.ema_decay))
            state.step += 1
        student.zero_grad(set_to_none=True)

        with torch.no_grad():
            fg = s_probs[..., 1] > 0.5
            pred_fg = fg.to(torch.float32)
            lab_f = label.to(torch.float32)
            inter = (pred_fg * lab_f).sum(dim=(1, 2, 3))
            dice_b = 2.0 * inter / (pred_fg.sum(dim=(1, 2, 3)) + lab_f.sum(dim=(1, 2, 3)) + 1e-8)
            vec = torch.stack([total.detach(), *(p.detach() for p in parts), dice_b.mean(),
                               torch.tensor(float(bad), device=image.device)])
        return vec, {"pred_fg": fg.view(torch.uint8), "embedding": stud_emb.detach(),
                     "mask_con": mask}

    return train_step
