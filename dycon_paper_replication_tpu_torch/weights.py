"""Weight transfer between the JAX package's parameter trees and the port.

A JAX UNet3D is a pair (params, state) of nested dicts (the layout of
dycon_paper_replication_tpu/models/unet3d.py:init_unet3d): conv blocks
{"w": (kd,kh,kw,Ci,Co), "b": (Co,)}, BatchNorm {"scale", "bias"} in params
and {"mean", "var"} in state["projection"]. The port keeps the same names and
the same DHWIO layout, so a state_dict key is the dotted path of the leaf:
params["up_concat1"]["conv2"]["w"] <-> "up_concat1.conv2.w",
state["projection"]["bn1"]["mean"] <-> "projection.bn1.mean".
Trees here hold numpy arrays; the JAX side converts with np.asarray.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .models.unet3d import UNet3DConfig

_STATE_LEAVES = ("mean", "var")


def _flatten(tree: dict, prefix: str = "") -> dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, key + "."))
        else:
            out[key] = np.asarray(v)
    return out


def _insert(tree: dict, key: str, value) -> None:
    *path, leaf = key.split(".")
    for k in path:
        tree = tree.setdefault(k, {})
    tree[leaf] = value


def jax_tree_to_state_dict(params: dict, state: dict) -> dict[str, torch.Tensor]:
    """(params, state) numpy trees -> a UNet3D state_dict (float32 copies)."""
    if "aspp" in params:
        raise ValueError("ASPP is not ported yet")
    flat = _flatten(params)
    flat.update(_flatten(state))
    return {k: torch.tensor(np.asarray(v, np.float32)) for k, v in flat.items()}


def state_dict_to_jax_tree(sd: dict[str, torch.Tensor]) -> tuple[dict, dict]:
    """The inverse: a UNet3D state_dict -> (params, state) numpy trees."""
    params: dict = {}
    state: dict = {}
    for key, t in sd.items():
        target = state if key.rsplit(".", 1)[-1] in _STATE_LEAVES else params
        _insert(target, key, t.detach().cpu().numpy())
    return params, state


def init_jax_tree(cfg: UNet3DConfig, seed: int) -> tuple[dict, dict]:
    """Random (params, state) numpy trees in the JAX layout, from `seed`:
    Kaiming-normal kernels, U(+-1/sqrt(fan_in)) biases, BN scale N(1, 0.02),
    running mean 0 and var 1 (the JAX init scheme, not its numbers)."""
    rng = np.random.default_rng(seed)

    def conv(ci, co, k=3):
        fan_in = ci * k ** 3
        bound = 1.0 / math.sqrt(fan_in)
        return {
            "w": (rng.standard_normal((k, k, k, ci, co)) * math.sqrt(2.0 / fan_in)).astype(np.float32),
            "b": rng.uniform(-bound, bound, co).astype(np.float32),
        }

    def block(ci, co):
        return {"conv1": conv(ci, co), "conv2": conv(co, co)}

    def bn(ch):
        return ({"scale": (1.0 + 0.02 * rng.standard_normal(ch)).astype(np.float32),
                 "bias": np.zeros(ch, np.float32)},
                {"mean": np.zeros(ch, np.float32), "var": np.ones(ch, np.float32)})

    f = cfg.filters
    params = {
        "conv1": block(cfg.in_channels, f[0]),
        "conv2": block(f[0], f[1]),
        "conv3": block(f[1], f[2]),
        "conv4": block(f[2], f[3]),
        "center": block(f[3], f[4]),
        "up_concat4": block(f[4] + f[3], f[3]),
        "up_concat3": block(f[3] + f[2], f[2]),
        "up_concat2": block(f[2] + f[1], f[1]),
        "up_concat1": block(f[1] + f[0], f[0]),
        "final": conv(f[0], cfg.n_classes, 1),
        "out_conv2": conv(f[0], cfg.n_classes, 1),
    }
    bn1, bn1_state = bn(cfg.proj_hidden)
    bn2, bn2_state = bn(cfg.proj_out)
    params["projection"] = {
        "conv1": conv(f[4], cfg.proj_hidden, 1), "bn1": bn1,
        "conv2": conv(cfg.proj_hidden, cfg.proj_out, 1), "bn2": bn2,
    }
    state = {"projection": {"bn1": bn1_state, "bn2": bn2_state}}
    return params, state
