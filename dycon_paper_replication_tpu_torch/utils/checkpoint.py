"""Checkpoints with torch.save: the student alone (evaluation) or the full
train state (resume), under the JAX package's naming.

Counterpart of dycon_paper_replication_tpu/utils/checkpoint.py. A
checkpoint is one file (the JAX package writes an orbax directory). Every
file holds the student's state_dict under "model" and a metadata dict
under "meta", so the test CLI loads a training checkpoint as it loads an
evaluation one; a full-state file adds the teacher's state_dict, the
momentum buffers and the step. The best dice of a run lives in the
metadata, as the JAX package's sidecar holds it. Saves are synchronous and
atomic (the JAX package hands its device fetch and write to a background
thread).
"""

from __future__ import annotations

import os
import re

import torch

from ..train.state import TrainState


def best_checkpoint_path(snapshot_path: str, model_name: str) -> str:
    return os.path.join(snapshot_path, f"{model_name}_best_model.pt")


def iter_checkpoint_path(snapshot_path: str, iter_num: int, dice: float | None = None) -> str:
    if dice is not None:
        return os.path.join(snapshot_path, f"iter_{iter_num}_dice_{round(dice, 4)}.pt")
    return os.path.join(snapshot_path, f"iter_{iter_num}.pt")


def _cpu(sd: dict) -> dict:
    return {k: v.detach().cpu() for k, v in sd.items()}


def _write(path: str, ckpt: dict) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(ckpt, tmp)
    os.replace(tmp, path)


def _read(path: str) -> dict:
    return torch.load(path, map_location="cpu", weights_only=True)


def save_checkpoint(path: str, model: torch.nn.Module, meta: dict | None = None) -> None:
    """Write `model`'s state_dict (on the CPU) and `meta` to `path`."""
    _write(path, {"model": _cpu(model.state_dict()), "meta": meta or {}})


def restore_checkpoint(path: str, model: torch.nn.Module) -> dict:
    """Load the student state_dict at `path` into `model` (strictly, onto
    the model's device) and return the checkpoint's metadata."""
    ckpt = _read(path)
    model.load_state_dict(ckpt["model"])
    return ckpt["meta"]


def save_train_state(path: str, state: TrainState, meta: dict | None = None) -> None:
    """Write the full train state: student, teacher (each with its BatchNorm
    stats), momentum and step, plus `meta`."""
    _write(path, {"model": _cpu(state.student.state_dict()),
                  "teacher": _cpu(state.teacher.state_dict()),
                  "momentum": _cpu(state.momentum), "step": int(state.step),
                  "meta": meta or {}})


def restore_train_state(path: str, state: TrainState) -> dict:
    """Load a full-state checkpoint into `state` (its modules' devices) and
    return the metadata."""
    ckpt = _read(path)
    state.student.load_state_dict(ckpt["model"])
    state.teacher.load_state_dict(ckpt["teacher"])
    if ckpt["momentum"].keys() != state.momentum.keys():
        raise ValueError(f"{path}: momentum buffers do not match the model")
    for k, v in ckpt["momentum"].items():
        state.momentum[k] = v.to(state.momentum[k].device)
    state.step = torch.tensor(int(ckpt["step"]), dtype=torch.int64,
                              device=next(state.student.parameters()).device)
    return ckpt["meta"]


def latest_checkpoint_path(snapshot_path: str, model_name: str) -> tuple[str, float]:
    """Resolve resume="auto": (the highest-step `iter_<N>[_dice_<D>].pt`,
    the best dice seen in their names and metadata), or the best-model file
    when no iter checkpoint exists. Raises FileNotFoundError when the run
    directory holds no checkpoint."""
    def meta_dice(path: str) -> float:
        return float(_read(path)["meta"].get("best_dice", 0.0))

    best_dice = 0.0
    latest: tuple[int, str] | None = None
    names = os.listdir(snapshot_path) if os.path.isdir(snapshot_path) else []
    for name in names:
        m = re.fullmatch(r"iter_(\d+)(?:_dice_([0-9.]+))?\.pt", name)
        if not m:
            continue
        full = os.path.join(snapshot_path, name)
        if m.group(2):
            best_dice = max(best_dice, float(m.group(2)))
        best_dice = max(best_dice, meta_dice(full))
        if latest is None or int(m.group(1)) > latest[0]:
            latest = (int(m.group(1)), full)
    if latest is not None:
        return latest[1], best_dice
    best = best_checkpoint_path(snapshot_path, model_name)
    if os.path.isfile(best):
        return best, max(best_dice, meta_dice(best))
    raise FileNotFoundError(f"no checkpoints to resume from in {snapshot_path}")
