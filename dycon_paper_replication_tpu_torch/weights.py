"""Weight transfer between the JAX package's parameter trees and the port.

A JAX UNet3D is a pair (params, state) of nested dicts (the layout of
dycon_paper_replication_tpu/models/unet3d.py:init_unet3d): conv blocks
{"w": (kd,kh,kw,Ci,Co), "b": (Co,)}, BatchNorm {"scale", "bias"} in params
and {"mean", "var"} in state["projection"]. The port keeps the same names and
the same DHWIO layout, so a state_dict key is the dotted path of the leaf:
params["up_concat1"]["conv2"]["w"] <-> "up_concat1.conv2.w",
state["projection"]["bn1"]["mean"] <-> "projection.bn1.mean".
Trees here hold numpy arrays; the JAX side converts with np.asarray.

A JAX `TrainState` (step, params, model_state, teacher_params,
teacher_state, opt_state) with numpy leaves converts to the port's
`train.state.TrainState` and back, exactly: the momentum is the optax trace
state (a params-shaped tree) and the schedule's count equals the step. The
conversion reads the optax states by their field names, so it needs no
optax.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .models.unet3d import UNet3D, UNet3DConfig
from .train.state import TrainState

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
        _insert(target, key, t.detach().cpu().numpy().copy())  # no view of a live tensor
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


def jax_train_state_to_torch(js, cfg: UNet3DConfig,
                             device: torch.device | str = "cpu") -> TrainState:
    """A JAX TrainState with numpy leaves -> the port's TrainState of two
    `cfg` UNet3Ds on `device`."""
    nets = []
    for params, state in ((js.params, js.model_state), (js.teacher_params, js.teacher_state)):
        net = UNet3D(cfg).to(device)
        net.load_state_dict(jax_tree_to_state_dict(params, state))
        nets.append(net)
    trace = next(el.trace for el in js.opt_state if "trace" in el._fields)
    momentum = {k: torch.tensor(np.asarray(v, np.float32), device=device)
                for k, v in _flatten(trace).items()}
    return TrainState(nets[0], nets[1].requires_grad_(False), momentum, int(js.step))


def torch_train_state_to_jax(state: TrainState, template):
    """The inverse, into the structure of `template` (a JAX TrainState, or
    one with numpy leaves): numpy leaves, optax states rebuilt with
    `_replace`."""
    params, mstate = state_dict_to_jax_tree(state.student.state_dict())
    tparams, tstate = state_dict_to_jax_tree(state.teacher.state_dict())
    trace: dict = {}
    for k, v in state.momentum.items():
        _insert(trace, k, v.detach().cpu().numpy().copy())
    opt = []
    for el in template.opt_state:
        if "trace" in el._fields:
            el = el._replace(trace=trace)
        elif "count" in el._fields:
            el = el._replace(count=np.asarray(state.step, np.asarray(el.count).dtype))
        opt.append(el)
    return template._replace(step=np.asarray(state.step, np.asarray(template.step).dtype),
                             params=params, model_state=mstate, teacher_params=tparams,
                             teacher_state=tstate, opt_state=type(template.opt_state)(opt))
