"""The train state and its optimizer.

Counterpart of dycon_paper_replication_tpu/train/state.py. `TrainState`
holds what a step changes: the student and its BatchNorm running stats,
the teacher (the student's structural twin) and its stats, the momentum
buffers and the step count. Modules carry their parameters and stats, so
the state is two modules, a dict and the step: an int64 scalar tensor on
the student's device, as JAX keeps its step on the device, so that the
learning rate and the EMA alpha are computed there and a step needs no
host read (an int given to the constructor is moved there; checkpoints hold
it as an int).

The optimizer is the JAX package's optax chain in its order, written out:
  g <- clip_by_global_norm(g, c)   (g if ||g|| < c else (g / ||g||) * c)
  g <- g + wd * p                  (weight decay)
  m <- g + mu * m                  (momentum trace, no Nesterov)
  p <- p + (-lr) * m
optax's clip, not torch.nn.utils.clip_grad_norm_, whose c / (||g|| + 1e-6)
differs. `sgd_candidate` and `ema_candidate` compute the new values with
torch._foreach_* ops (a few launches for all ~150 tensors) without writing
them; `select_` writes the new values or keeps the old ones on the device,
which is how a NaN/Inf step is dropped (train/step.py).
"""

from __future__ import annotations

import copy
import dataclasses

import torch


@dataclasses.dataclass
class TrainState:
    student: torch.nn.Module
    teacher: torch.nn.Module
    momentum: dict[str, torch.Tensor]  # keyed by the student's parameter names
    step: torch.Tensor | int = 0  # applied updates; a NaN-skipped step does not count

    def __post_init__(self):
        device = next(self.student.parameters()).device
        self.step = torch.as_tensor(self.step, dtype=torch.int64, device=device)


def create_train_state(student: torch.nn.Module) -> TrainState:
    """The teacher starts as a copy of the student (without gradients), the
    momentum at zero."""
    teacher = copy.deepcopy(student).requires_grad_(False)
    momentum = {k: torch.zeros_like(p) for k, p in student.named_parameters()}
    return TrainState(student, teacher, momentum, 0)


@torch.no_grad()
def sgd_candidate(state: TrainState, lr: float | torch.Tensor, momentum: float,
                  weight_decay: float, clip_norm: float
                  ) -> tuple[list[torch.Tensor], list[torch.Tensor]]:
    """(new parameters, new momentum) of one step of the chain above on the
    student's `.grad`s, in the order of `named_parameters`; nothing is
    written. `lr` may be a device scalar. A parameter without a gradient
    (the SDF head, which no loss reads) counts as a zero gradient: it still
    decays, as under JAX's autodiff. The clip divides by d and multiplies by
    c, with d = c = 1 below the bar: g / 1 * 1 is g exactly, so the two
    sides of JAX's `where` come out of one pair of foreach ops."""
    named = list(state.student.named_parameters())
    params = [p for _, p in named]
    grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
    g_norm = torch.sqrt(sum(g.square().sum() for g in grads))
    keep = g_norm < clip_norm
    one = torch.ones((), dtype=g_norm.dtype, device=g_norm.device)
    g = torch._foreach_div(grads, torch.where(keep, one, g_norm))
    torch._foreach_mul_(g, torch.where(keep, one, one * clip_norm))
    torch._foreach_add_(g, torch._foreach_mul(params, weight_decay))
    m = torch._foreach_mul([state.momentum[k] for k, _ in named], momentum)
    torch._foreach_add_(m, g)
    step = torch._foreach_mul(m, -lr)
    return list(torch._foreach_add(params, step)), list(m)


@torch.no_grad()
def ema_candidate(teacher: torch.nn.Module, student_params: list[torch.Tensor],
                  alpha: float | torch.Tensor) -> list[torch.Tensor]:
    """alpha * teacher + (1 - alpha) * student, parameters only (each model
    keeps its own BatchNorm stats); nothing is written."""
    new = torch._foreach_mul(list(teacher.parameters()), alpha)
    torch._foreach_add_(new, torch._foreach_mul(student_params, 1.0 - alpha))
    return list(new)


@torch.no_grad()
def select_(bad: torch.Tensor, targets: list[torch.Tensor], old: list[torch.Tensor],
            new: list[torch.Tensor]) -> None:
    """targets[i] <- old[i] where the device bool `bad` holds, else new[i]:
    one flat torch.where per dtype, and the copies back in foreach
    launches, instead of one select per tensor."""
    by_dtype: dict[torch.dtype, list[int]] = {}
    for i, t in enumerate(targets):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = torch.where(bad, torch.cat([old[i].reshape(-1) for i in idx]),
                           torch.cat([new[i].reshape(-1) for i in idx]))
        parts = flat.split([targets[i].numel() for i in idx])
        torch._foreach_copy_([targets[i] for i in idx],
                             [p.view(targets[i].shape) for p, i in zip(parts, idx)])
