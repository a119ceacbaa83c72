"""The train state and its optimizer.

Counterpart of dycon_paper_replication_tpu/train/state.py. `TrainState`
holds what a step changes: the student and its BatchNorm running stats,
the teacher (the student's structural twin) and its stats, the momentum
buffers and the step count. Modules carry their parameters and stats, so
the state is two modules, a dict and an int.

The optimizer is the JAX package's optax chain in its order, written out:
  g <- clip_by_global_norm(g, c)   (g if ||g|| < c else (g / ||g||) * c)
  g <- g + wd * p                  (weight decay)
  m <- g + mu * m                  (momentum trace, no Nesterov)
  p <- p + (-lr) * m
optax's clip, not torch.nn.utils.clip_grad_norm_, whose c / (||g|| + 1e-6)
differs.
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
    step: int = 0  # applied updates; a NaN-skipped step does not count


def create_train_state(student: torch.nn.Module) -> TrainState:
    """The teacher starts as a copy of the student (without gradients), the
    momentum at zero."""
    teacher = copy.deepcopy(student).requires_grad_(False)
    momentum = {k: torch.zeros_like(p) for k, p in student.named_parameters()}
    return TrainState(student, teacher, momentum, 0)


@torch.no_grad()
def sgd_update(state: TrainState, lr: float, momentum: float, weight_decay: float,
               clip_norm: float) -> None:
    """One step of the chain above on the student's `.grad`s, in place. A
    parameter without a gradient (the SDF head, which no loss reads) counts
    as a zero gradient: it still decays, as under JAX's autodiff."""
    named = list(state.student.named_parameters())
    grads = [torch.zeros_like(p) if p.grad is None else p.grad for _, p in named]
    g_norm = torch.sqrt(sum(g.square().sum() for g in grads))
    keep = g_norm < clip_norm
    for (k, p), g in zip(named, grads):
        g = torch.where(keep, g, g / g_norm * clip_norm)
        g = g + weight_decay * p
        m = g + momentum * state.momentum[k]
        state.momentum[k] = m
        p.copy_(p + m * (-lr))


@torch.no_grad()
def ema_update(teacher: torch.nn.Module, student: torch.nn.Module, alpha: float) -> None:
    """teacher <- alpha * teacher + (1 - alpha) * student, parameters only
    (each model keeps its own BatchNorm stats)."""
    for t, s in zip(teacher.parameters(), student.parameters()):
        t.copy_(alpha * t + (1.0 - alpha) * s)
