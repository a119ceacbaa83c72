"""Hyper-parameter ramp schedules, evaluated on the host per iteration or
epoch and handed to the train step as Python floats.

Counterpart of dycon_paper_replication_tpu/ops/ramps.py: the schedules the
trainer uses, and the linear ramp-up and cosine ramp-down.
"""

from __future__ import annotations

import math


def sigmoid_rampup(current: float, rampup_length: float) -> float:
    """exp(-5 (1 - clip(t, 0, L) / L)^2): e^-5 at 0, 1 from L on."""
    if rampup_length == 0:
        return 1.0
    phase = 1.0 - min(max(float(current), 0.0), rampup_length) / rampup_length
    return math.exp(-5.0 * phase * phase)


def linear_rampup(current: float, rampup_length: float) -> float:
    """Linear ramp from 0 to 1 over `rampup_length` steps."""
    if current < 0 or rampup_length < 0:
        raise ValueError(f"need current >= 0 and rampup_length >= 0, got {current}, "
                         f"{rampup_length}")
    if current >= rampup_length:
        return 1.0
    return current / rampup_length


def cosine_rampdown(current: float, rampdown_length: float) -> float:
    """Cosine ramp from 1 down to 0 over `rampdown_length` steps."""
    if not 0 <= current <= rampdown_length:
        raise ValueError(f"need 0 <= current <= rampdown_length, got {current}, "
                         f"{rampdown_length}")
    return 0.5 * (math.cos(math.pi * current / rampdown_length) + 1.0)


def adaptive_beta(epoch: float, total_epochs: float, max_beta: float = 5.0,
                  min_beta: float = 0.5) -> float:
    """UnCL's entropy weight, decaying exponentially from max_beta at epoch
    0 to min_beta at `total_epochs`."""
    return max_beta * (min_beta / max_beta) ** (epoch / total_epochs)


def threshold_rampup(current_epoch: float, total_rampup_epochs: float, min_threshold: float,
                     max_threshold: float, steepness: float = 5.0) -> float:
    """Sigmoid-shaped ramp of a FeCL focal threshold from min_threshold to
    max_threshold over `total_rampup_epochs`."""
    if total_rampup_epochs == 0:
        return max_threshold
    t = min(max(0.0, float(current_epoch)), total_rampup_epochs)
    phase = 1.0 - t / total_rampup_epochs
    ramp = math.exp(-steepness * phase * phase)
    return min_threshold + (max_threshold - min_threshold) * ramp


def poly_lr(base_lr: float, step: int, max_steps: int, power: float = 0.9) -> float:
    """Polynomial decay base_lr * (1 - step / max_steps)^power (ISLES)."""
    return base_lr * (1.0 - step / max_steps) ** power
