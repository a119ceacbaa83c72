"""The DyCON train step.

Counterpart of dycon_paper_replication_tpu/train/step.py:
  noise on the teacher input -> teacher forward (no gradient, train mode,
  dropout) -> student forward -> CE + binary Dice on the labeled slice ->
  FeCL over the L2-normalised projection embeddings with the pooled label
  mask -> UnCL -> double-softmax consistency on the unlabeled slice ->
  weighted sum -> backward -> clip, weight decay, momentum, lr -> EMA
  teacher -> NaN/Inf skip -> train Dice.

The batch layout is the two-stream sampler's: labeled samples first
(batch[:labeled_bs]). Image (B, D1, D2, D3, 1) float32 or float16, label
(B, D1, D2, D3) integer (uint8 or int32), on the model's device: the
loader's wire dtypes (data/pipeline.py), widened here to float32 / int64.

The step's randomness is the JAX step's, from the same threefry key
(ops/threefry.py): the key splits into the noise, student and teacher keys,
as at the JAX step.py:191; the teacher noise clip(0.1 N(0, 1), +-0.2) is
jax.random.normal's draw from the noise key, and the models split their keys
into the dropout keys as the JAX models do. On the card the noise and the
dropout masks come from the threefry kernel (ops/csrc/threefry.cu). The
noise can also be passed in (the global batch's). FeCL is dense at `fecl_chunk` 0; above it, over
row tiles of `fecl_chunk` through `fecl_impl` "fused" (ops/fecl_fused.py:
the closed-form backward, the kernel K2 on the card) or "chunked"
(ops/dycon.py:fecl_loss_chunked).

The NaN/Inf skip is decided on the device, as the JAX step decides it: the
update is always computed (train/state.py: sgd_candidate, ema_candidate)
and `select_` keeps the old values where the loss is not finite. The step
count is a device tensor, and the learning rate (`lr_schedule(step)`) and
the EMA alpha (`ema_alpha`) are computed from it in float32 there, so the
step holds no host read: the host can queue the next step while this one
runs (train/trainer.py, fetch_ahead). Two host reads remain on paths other
than the dense-FeCL one: the fused FeCL's backward hands K2 its cross-term
cotangent as a kernel argument (ops/fecl_fused.py), and a data-parallel
step's scalar all-reduce, which over gloo is a host round trip by nature.

`diagnostics` (the JAX step's light/full pair): with True the step also
returns the outputs the trainer reads on its train-HD95 and monitor
iterations (the JAX full step's): the student's foreground `pred_fg`
(s_probs[..., 1] > 0.5, uint8), its L2-normalised `embedding` (B, N, D) and
the pooled FeCL mask `mask_con` (B, N); with False, an empty dict. These
are tensors the eager step computes anyway (the train Dice and FeCL read
them), so the light step saves little device time here; it exists so that
the trainer's diagnostic iterations, and the sample a NaN skip drops, are
the JAX trainer's.

`cfg.remat` "full" recomputes the student forward in the backward pass
(torch.utils.checkpoint, non-reentrant), as JAX's jax.checkpoint of the
student forward; the teacher's no-grad forward is not affected. The
recompute draws the same dropout masks from the same student key (the
draws are counter-based; no generator state to replay), and runs under
models/layers.frozen_running_stats, so the BatchNorms' running statistics
move once. It is refused in a data-parallel step, whose BatchNorm sums
would run their cross-rank all-reduces again inside the backward.

Data parallelism (`shard`, a parallel.Shard): each rank holds its rows of
the global batch (labeled_bs / N labeled ones first) and computes its term
of the JAX step's GLOBAL loss, so that the terms sum to it: each mean over
the global batch is the rank's sum over the global count (CE, UnCL, the
consistency term, FeCL's student mean), the Dice ratio and the BatchNorm
statistics take their sums across ranks through a differentiable all-reduce
(whose backward all-reduces the cotangent), FeCL's cross term divides by
the global count of hard pairs, and a rank draws its own rows of the global
batch's teacher noise and dropout masks (threefry's `rows`). The scalars are all-reduced
(one collective), so every rank sees the global loss and skips a NaN/Inf
step together; the gradients are all-reduced by SUM (the gradient of the
summed terms, not a mean of per-rank gradients), and global-norm clipping
acts on the reduced gradient. The EMA stays local, on identical replicas.
The diagnostic outputs are the rank's own rows.
"""

from __future__ import annotations

import contextlib
from typing import Callable, NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from ..config import TrainConfig
from ..models import layers
from ..ops import dycon, fecl_fused, losses, threefry
from ..parallel import mesh
from ..ops.resize import avg_pool_nonoverlap
from .state import TrainState, ema_candidate, select_, sgd_candidate

# order of the per-step scalar vector a step returns
SCALAR_METRICS = ("loss", "loss_ce", "loss_dice", "f_loss", "u_loss", "consistency_loss",
                  "train_dice", "skipped")


def foreground(probs: torch.Tensor) -> torch.Tensor:
    """The student's foreground, probs[..., 1] > 0.5 (the train Dice and
    `pred_fg`); a module-level function, so that train/device_check.py can
    share a side at this threshold as at the step's other kinks."""
    return probs[..., 1] > 0.5


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


def ema_alpha(step: torch.Tensor | int, decay: float) -> torch.Tensor:
    """min(1 - 1 / (step + 1), decay) in float32 on the step's device, from
    the step before the increment (0 at the first step: the teacher takes
    the student's weights)."""
    s = torch.as_tensor(step).to(torch.float32)
    return torch.clamp_max(1.0 - 1.0 / (s + 1.0), decay)


def remat_forward(student: torch.nn.Module, image: torch.Tensor, key):
    """student(image, key=key) with its activations recomputed in the
    backward pass instead of stored, the running stats frozen in the
    recompute (module doc). No default generator is drawn from, so none is
    saved."""
    return checkpoint(lambda x: student(x, key=key), image, use_reentrant=False,
                      preserve_rng_state=False,
                      context_fn=lambda: (contextlib.nullcontext(),
                                          layers.frozen_running_stats()))


def build_train_step(cfg: TrainConfig, lr_schedule: Callable[[torch.Tensor], float | torch.Tensor],
                     shard: mesh.Shard | None = None, *, diagnostics: bool = True) -> Callable:
    """train_step(state, batch, key, scalars, noise=None) -> (the
    float32 vector of SCALAR_METRICS on the device, {"pred_fg",
    "embedding", "mask_con"}, or {} with `diagnostics` False); `state` is
    updated in place; `key` is a threefry key (ops/threefry.py), the JAX
    step's rng. `lr_schedule` maps the device step count to the
    learning rate (a float, or a device scalar). With `shard`, `batch`
    holds this rank's rows and `noise` (if given) is the global batch's
    (module doc); the returned scalars are the global step's."""
    if cfg.remat not in ("none", "full"):
        raise ValueError(f"remat must be 'none' or 'full', got {cfg.remat!r}")
    if cfg.remat == "full" and shard is not None:
        raise ValueError("remat 'full' is not supported with data parallelism: the recompute "
                         "in the backward pass would run the BatchNorms' cross-rank "
                         "all-reduces a second time, inside the backward")
    lbs = cfg.labeled_bs if shard is None else shard.labeled
    # per-rank weights of the batch means (1 on one device) and the Dice
    # sums' reduction
    if shard is None:
        w_lab = w_unl = w_all = w_dice = 1.0
        reduce = losses.no_reduce
    else:
        w_lab = shard.labeled / shard.global_labeled
        w_unl = shard.unlabeled / (shard.global_batch - shard.global_labeled)
        w_all = shard.batch / shard.global_batch
        w_dice = 1.0 / shard.world
        reduce = shard.all_sum

    def loss_fn(student, image, label, t_logits, t_features, key, scalars: StepScalars):
        if cfg.remat == "full":
            _, s_logits, s_features = remat_forward(student, image, key)
        else:
            _, s_logits, s_features = student(image, key=key)
        s_probs = torch.softmax(s_logits, dim=-1)
        t_probs = torch.softmax(t_logits, dim=-1)

        loss_ce = losses.cross_entropy_loss(s_logits[:lbs], label[:lbs])
        if cfg.dice_loss_kind == "binary":
            loss_dice = losses.dice_loss(s_probs[:lbs, ..., 1], label[:lbs] == 1, reduce=reduce)
        else:
            loss_dice = losses.dice_loss_nclass(s_probs[:lbs], label[:lbs], cfg.num_classes,
                                                reduce=reduce)

        stud_emb = normalized_embeddings(s_features)
        kernel = mask_kernel(cfg, image.shape[1:4], s_features.shape[1:4])
        mask = avg_pool_nonoverlap(label.to(torch.float32), kernel)
        mask = (mask > 0.5).to(torch.float32).reshape(label.shape[0], -1)
        teacher_emb = normalized_embeddings(t_features) if cfg.use_teacher_loss else None
        fecl_kwargs = dict(temperature=cfg.temp, gamma=cfg.gamma, use_focal=bool(cfg.use_focal),
                           pos_thresh=scalars.pos_thresh, neg_thresh=scalars.neg_thresh)
        if shard is not None:
            fecl_kwargs["shard"] = shard
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

        if shard is not None:  # this rank's terms of the global means
            loss_ce, loss_dice, u_loss, cons = (loss_ce * w_lab, loss_dice * w_dice,
                                                u_loss * w_all, cons * w_unl)
        total = (cfg.l_weight * (loss_ce + loss_dice) + scalars.consistency_weight * cons
                 + cfg.u_weight * (f_loss + u_loss))
        return total, (loss_ce, loss_dice, f_loss, u_loss, cons), (s_probs, stud_emb, mask)

    def train_step(state: TrainState, batch: dict, key, scalars: StepScalars,
                   noise: torch.Tensor | None = None):
        image = batch["image"].to(torch.float32)
        label = batch["label"].long()
        noise_key, student_key, teacher_key = threefry.split(key, 3)
        if noise is None:
            shape = image.shape if shard is None else (shard.global_batch,) + image.shape[1:]
            noise = threefry.teacher_noise(noise_key, shape, None if shard is None else shard.rows,
                                           image.device)
        elif shard is not None:
            noise = shard.rows_of(noise)
        teacher = state.teacher.train(cfg.teacher_train_mode)
        student = state.student.train()
        old_stats = [b.clone() for b in student.buffers()]
        student.zero_grad(set_to_none=True)
        with mesh.sharded(shard):
            with torch.no_grad():
                _, t_logits, t_features = teacher(
                    image + noise, key=teacher_key if cfg.teacher_train_mode else None)
            total, parts, (s_probs, stud_emb, mask) = loss_fn(student, image, label, t_logits,
                                                              t_features, student_key, scalars)
        total.backward()

        with torch.no_grad():
            fg = foreground(s_probs)
            pred_fg = fg.to(torch.float32)
            lab_f = label.to(torch.float32)
            inter = (pred_fg * lab_f).sum(dim=(1, 2, 3))
            dice_b = 2.0 * inter / (pred_fg.sum(dim=(1, 2, 3)) + lab_f.sum(dim=(1, 2, 3)) + 1e-8)
            values = torch.stack([total.detach(), *(p.detach() for p in parts)])
            if shard is None:
                train_dice = dice_b.mean()
            else:  # the global step's scalars, in one collective
                summed = shard.all_sum_(torch.cat([values, dice_b.sum()[None]]))
                values, train_dice = summed[:-1], summed[-1] / shard.global_batch
                total = values[0]

            # NaN/Inf guard, on the device: the whole update (parameters,
            # student stats, momentum, teacher EMA, step) takes its old
            # values, as the reference's `continue`; the teacher's stats
            # still advance, its forward has run. In a data-parallel step
            # the loss is the global one, so every rank decides alike.
            bad = ~torch.isfinite(total)
            if shard is not None:
                _all_sum_grads(student, shard)
            # a no-op for the device step of a TrainState (state.py)
            step = torch.as_tensor(state.step, dtype=torch.int64, device=total.device)
            new_params, new_momentum = sgd_candidate(state, lr_schedule(step), cfg.momentum,
                                                     cfg.weight_decay, cfg.grad_clip_norm)
            new_teacher = ema_candidate(state.teacher, new_params, ema_alpha(step, cfg.ema_decay))
            params = list(student.parameters())
            momentum = [state.momentum[k] for k, _ in student.named_parameters()]
            t_params = list(state.teacher.parameters())
            stats = list(student.buffers())
            select_(bad, params + momentum + t_params + stats,
                    params + momentum + t_params + old_stats,
                    new_params + new_momentum + new_teacher + stats)
            state.step = torch.where(bad, step, step + 1)
        student.zero_grad(set_to_none=True)
        vec = torch.cat([values, train_dice[None], bad.to(values.dtype)[None]])
        if not diagnostics:
            return vec, {}
        return vec, {"pred_fg": fg.view(torch.uint8), "embedding": stud_emb.detach(),
                     "mask_con": mask}

    return train_step


@torch.no_grad()
def _all_sum_grads(student: torch.nn.Module, shard: mesh.Shard) -> None:
    """Sum every parameter's gradient over the ranks, in one flat
    all-reduce (a parameter without one counts as a zero gradient)."""
    params = list(student.parameters())
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    flat = shard.all_sum_(torch.cat([p.grad.reshape(-1) for p in params]))
    offset = 0
    for p in params:
        p.grad.copy_(flat[offset:offset + p.numel()].view_as(p))
        offset += p.numel()
