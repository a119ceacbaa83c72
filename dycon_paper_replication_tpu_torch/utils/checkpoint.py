"""Checkpoints of the eval-relevant model state, with torch.save.

Counterpart of the naming and save/restore of
dycon_paper_replication_tpu/utils/checkpoint.py. A checkpoint here is one
file holding the student's state_dict (parameters and BatchNorm running
stats) and an optional metadata dict; the optimizer, teacher and step that
the JAX trainer also saves come with the training slice. Orbax has no
counterpart on the card.
"""

from __future__ import annotations

import os

import torch


def best_checkpoint_path(snapshot_path: str, model_name: str) -> str:
    return os.path.join(snapshot_path, f"{model_name}_best_model.pt")


def save_checkpoint(path: str, model: torch.nn.Module, meta: dict | None = None) -> None:
    """Write `model`'s state_dict (on the CPU) and `meta` to `path`,
    atomically."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    sd = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save({"model": sd, "meta": meta or {}}, tmp)
    os.replace(tmp, path)


def restore_checkpoint(path: str, model: torch.nn.Module) -> dict:
    """Load the state_dict at `path` into `model` (strictly, onto the model's
    device) and return the checkpoint's metadata."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(ckpt["model"])
    return ckpt["meta"]
