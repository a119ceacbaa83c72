"""Weight transfer between the JAX package's parameter trees and the port.

A JAX UNet3D or VNet is a pair (params, state) of nested dicts (the layout
of dycon_paper_replication_tpu/models/unet3d.py:init_unet3d and
vnet.py:init_vnet): convs {"w": (kd,kh,kw,Ci,Co), "b": (Co,)} (ASPP's
without "b"), transposed convs the same, BatchNorm {"scale", "bias"} in
params and {"mean", "var"} in state at the same path. The port keeps the
names and the DHWIO layout, so a state_dict key is the dotted path of the
leaf: params["up_concat1"]["conv2"]["w"] <-> "up_concat1.conv2.w",
state["enc1"]["bn0"]["mean"] <-> "enc1.bn0.mean". One exception: the JAX
ASPP keeps a branch's running stats at state["aspp"]["aspp<i>"] itself, the
port at "aspp.aspp<i>.bn"; the mapper moves them both ways.
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
import re

import numpy as np
import torch

from .models.factory import build_model
from .models.unet3d import UNet3DConfig
from .models.vnet import DEC_STAGES, ENC_STAGES, VNetConfig
from .ops import threefry
from .train.state import TrainState

_STATE_LEAVES = ("mean", "var")
# an ASPP branch's running stats: the JAX tree's key and the port's
_ASPP_JAX = re.compile(r"^aspp\.aspp(\d+)\.(mean|var)$")
_ASPP_PORT = re.compile(r"^aspp\.aspp(\d+)\.bn\.(mean|var)$")


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
    """(params, state) numpy trees -> a UNet3D or VNet state_dict (float32
    copies)."""
    flat = _flatten(params)
    flat.update({_ASPP_JAX.sub(r"aspp.aspp\1.bn.\2", k): v for k, v in _flatten(state).items()})
    return {k: torch.tensor(np.asarray(v, np.float32)) for k, v in flat.items()}


def state_dict_to_jax_tree(sd: dict[str, torch.Tensor]) -> tuple[dict, dict]:
    """The inverse: a UNet3D or VNet state_dict -> (params, state) numpy
    trees."""
    params: dict = {}
    state: dict = {}
    for key, t in sd.items():
        value = t.detach().cpu().numpy().copy()  # no view of a live tensor
        if key.rsplit(".", 1)[-1] in _STATE_LEAVES:
            _insert(state, _ASPP_PORT.sub(r"aspp.aspp\1.\2", key), value)
        else:
            _insert(params, key, value)
    return params, state


def init_jax_tree(cfg: UNet3DConfig | VNetConfig, seed: int) -> tuple[dict, dict]:
    """The JAX package's initial (params, state) numpy trees of a UNet3D (with
    its ASPP subtree under `use_aspp`; the plain and folded layouts share one
    tree) or a VNet at jax.random.key(seed): its split trees
    (models/unet3d.py:init_unet3d, aspp.py:aspp3d_init, vnet.py:init_vnet)
    and its draws, through ops/threefry.py: Kaiming-normal kernels,
    U(+-1/sqrt(fan_in)) biases, running mean 0 and var 1; BatchNorm scale
    1 + 0.02 N(0, 1) in the projection head and 1 in the VNet's blocks and
    ASPP, bias 0. Uniform-drawn leaves are JAX's bit for bit, normal-drawn
    ones within a few ulp (threefry.normal)."""
    f32 = np.float32

    def conv(key, ci, co, k=3, bias=True):  # layers.conv3d_init / conv_transpose3d_init
        w_key, b_key = threefry.split(key)
        fan_in = ci * k ** 3
        p = {"w": threefry.normal(w_key, (k, k, k, ci, co)) * f32(math.sqrt(2.0 / fan_in))}
        if bias:
            bound = 1.0 / math.sqrt(fan_in)
            p["b"] = threefry.uniform(b_key, (co,), -bound, bound)
        return p

    def bn(ch, key=None):  # layers.batch_norm_init, or batch_norm_rand_init with a key
        scale = (np.ones(ch, f32) if key is None
                 else f32(1.0) + f32(0.02) * threefry.normal(key, (ch,)))
        return ({"scale": scale, "bias": np.zeros(ch, f32)},
                {"mean": np.zeros(ch, f32), "var": np.ones(ch, f32)})

    def projection(ci, bn1_key, bn2_key, conv1_key, conv2_key):
        bn1, bn1_state = bn(cfg.proj_hidden, bn1_key)
        bn2, bn2_state = bn(cfg.proj_out, bn2_key)
        return ({"conv1": conv(conv1_key, ci, cfg.proj_hidden, 1), "bn1": bn1,
                 "conv2": conv(conv2_key, cfg.proj_hidden, cfg.proj_out, 1), "bn2": bn2},
                {"bn1": bn1_state, "bn2": bn2_state})

    f = cfg.filters
    if isinstance(cfg, VNetConfig):
        params: dict = {}
        state: dict = {}
        keys = iter(threefry.split(threefry.key(seed), 32))

        def block(name, n_stages, ci, co):  # vnet._block_init
            bkeys = threefry.split(next(keys), 2 * n_stages)
            params[name], state[name] = {}, {}
            for i in range(n_stages):
                params[name][f"conv{i}"] = conv(bkeys[2 * i], ci if i == 0 else co, co)
                params[name][f"bn{i}"], state[name][f"bn{i}"] = bn(co)

        def resample(name, ci, co):  # vnet._resize_init
            conv_key, _ = threefry.split(next(keys))
            bn_p, bn_s = bn(co)
            params[name], state[name] = {"conv": conv(conv_key, ci, co, 2), "bn": bn_p}, {"bn": bn_s}

        ch = cfg.in_channels
        for lvl, stages in enumerate(ENC_STAGES):
            block(f"enc{lvl}", stages, ch, f[lvl])
            if lvl < 4:
                resample(f"down{lvl}", f[lvl], f[lvl + 1])
            ch = f[lvl + 1] if lvl < 4 else f[lvl]
        for lvl in range(4):
            resample(f"up{lvl}", f[4 - lvl], f[3 - lvl])
            block(f"dec{lvl}", DEC_STAGES[lvl], f[3 - lvl], f[3 - lvl])
        params["out_conv"] = conv(next(keys), f[0], cfg.n_classes, 1)
        params["out_conv_sdf"] = conv(next(keys), f[0], cfg.n_classes, 1)
        bn_keys = next(keys), next(keys)
        params["projection"], state["projection"] = projection(f[4], *bn_keys, next(keys),
                                                               next(keys))
        return params, state

    keys = threefry.split(threefry.key(seed), 16)

    def unet_block(key, ci, co):  # unet3d._conv_block_init
        k1, k2 = threefry.split(key)
        return {"conv1": conv(k1, ci, co), "conv2": conv(k2, co, co)}

    params = {
        "conv1": unet_block(keys[0], cfg.in_channels, f[0]),
        "conv2": unet_block(keys[1], f[0], f[1]),
        "conv3": unet_block(keys[2], f[1], f[2]),
        "conv4": unet_block(keys[3], f[2], f[3]),
        "center": unet_block(keys[4], f[3], f[4]),
        "up_concat4": unet_block(keys[5], f[4] + f[3], f[3]),
        "up_concat3": unet_block(keys[6], f[3] + f[2], f[2]),
        "up_concat2": unet_block(keys[7], f[2] + f[1], f[1]),
        "up_concat1": unet_block(keys[8], f[1] + f[0], f[0]),
        "final": conv(keys[9], f[0], cfg.n_classes, 1),
        "out_conv2": conv(keys[10], f[0], cfg.n_classes, 1),
    }
    state = {}
    params["projection"], state["projection"] = projection(f[4], *keys[11:15])
    if cfg.use_aspp:  # aspp.aspp3d_init
        akeys = threefry.split(keys[15], 8)
        ap, ast = {}, {}
        for i in range(4):
            ap[f"aspp{i + 1}"] = {"conv": conv(akeys[i], f[4], f[4], 1 if i == 0 else 3,
                                               bias=False)}
            ap[f"aspp{i + 1}"]["bn"], ast[f"aspp{i + 1}"] = bn(f[4])
        ap["pool_conv"] = conv(akeys[4], f[4], f[4], 1, bias=False)
        ap["pool_bn"], ast["pool_bn"] = bn(f[4])
        ap["fuse_conv"] = conv(akeys[5], 5 * f[4], f[4], 1, bias=False)
        ap["fuse_bn"], ast["fuse_bn"] = bn(f[4])
        params["aspp"], state["aspp"] = ap, ast
    return params, state


def init_scheme_tree(cfg: UNet3DConfig | VNetConfig, seed: int) -> tuple[dict, dict]:
    """Random (params, state) numpy trees in init_jax_tree's layout, by the
    JAX init scheme but from numpy's default_rng(seed), not JAX's numbers:
    Kaiming-normal kernels, U(+-1/sqrt(fan_in)) biases, running mean 0 and
    var 1; BatchNorm scale N(1, 0.02) in the projection head and 1 in the
    VNet's blocks and ASPP, bias 0. The weights that the card-against-CPU
    step check (train/device_check.py) and tests/test_torch_cli.py were
    calibrated on, kept as they were when init_jax_tree began to draw JAX's
    numbers."""
    rng = np.random.default_rng(seed)

    def conv(ci, co, k=3, bias=True):
        fan_in = ci * k ** 3
        bound = 1.0 / math.sqrt(fan_in)
        p = {"w": (rng.standard_normal((k, k, k, ci, co)) * math.sqrt(2.0 / fan_in))
             .astype(np.float32)}
        if bias:
            p["b"] = rng.uniform(-bound, bound, co).astype(np.float32)
        return p

    def bn(ch, rand=False):
        scale = 1.0 + 0.02 * rng.standard_normal(ch) if rand else np.ones(ch)
        return ({"scale": scale.astype(np.float32), "bias": np.zeros(ch, np.float32)},
                {"mean": np.zeros(ch, np.float32), "var": np.ones(ch, np.float32)})

    def projection(ci):
        bn1, bn1_state = bn(cfg.proj_hidden, rand=True)
        bn2, bn2_state = bn(cfg.proj_out, rand=True)
        return ({"conv1": conv(ci, cfg.proj_hidden, 1), "bn1": bn1,
                 "conv2": conv(cfg.proj_hidden, cfg.proj_out, 1), "bn2": bn2},
                {"bn1": bn1_state, "bn2": bn2_state})

    f = cfg.filters
    if isinstance(cfg, VNetConfig):
        params: dict = {}
        state: dict = {}

        def block(name, n_stages, ci, co):
            params[name], state[name] = {}, {}
            for i in range(n_stages):
                params[name][f"conv{i}"] = conv(ci if i == 0 else co, co)
                params[name][f"bn{i}"], state[name][f"bn{i}"] = bn(co)

        def resample(name, ci, co):
            bn_p, bn_s = bn(co)
            params[name], state[name] = {"conv": conv(ci, co, 2), "bn": bn_p}, {"bn": bn_s}

        ch = cfg.in_channels
        for lvl, stages in enumerate(ENC_STAGES):
            block(f"enc{lvl}", stages, ch, f[lvl])
            if lvl < 4:
                resample(f"down{lvl}", f[lvl], f[lvl + 1])
            ch = f[lvl + 1] if lvl < 4 else f[lvl]
        for lvl in range(4):
            resample(f"up{lvl}", f[4 - lvl], f[3 - lvl])
            block(f"dec{lvl}", DEC_STAGES[lvl], f[3 - lvl], f[3 - lvl])
        params["out_conv"] = conv(f[0], cfg.n_classes, 1)
        params["out_conv_sdf"] = conv(f[0], cfg.n_classes, 1)
        params["projection"], state["projection"] = projection(f[4])
        return params, state

    def unet_block(ci, co):
        return {"conv1": conv(ci, co), "conv2": conv(co, co)}

    params = {
        "conv1": unet_block(cfg.in_channels, f[0]),
        "conv2": unet_block(f[0], f[1]),
        "conv3": unet_block(f[1], f[2]),
        "conv4": unet_block(f[2], f[3]),
        "center": unet_block(f[3], f[4]),
        "up_concat4": unet_block(f[4] + f[3], f[3]),
        "up_concat3": unet_block(f[3] + f[2], f[2]),
        "up_concat2": unet_block(f[2] + f[1], f[1]),
        "up_concat1": unet_block(f[1] + f[0], f[0]),
        "final": conv(f[0], cfg.n_classes, 1),
        "out_conv2": conv(f[0], cfg.n_classes, 1),
    }
    state = {}
    params["projection"], state["projection"] = projection(f[4])
    if cfg.use_aspp:
        ap, ast = {}, {}
        for i in range(4):
            ap[f"aspp{i + 1}"] = {"conv": conv(f[4], f[4], 1 if i == 0 else 3, bias=False)}
            ap[f"aspp{i + 1}"]["bn"], ast[f"aspp{i + 1}"] = bn(f[4])
        ap["pool_conv"] = conv(f[4], f[4], 1, bias=False)
        ap["pool_bn"], ast["pool_bn"] = bn(f[4])
        ap["fuse_conv"] = conv(5 * f[4], f[4], 1, bias=False)
        ap["fuse_bn"], ast["fuse_bn"] = bn(f[4])
        params["aspp"], state["aspp"] = ap, ast
    return params, state


def jax_train_state_to_torch(js, cfg: UNet3DConfig | VNetConfig,
                             device: torch.device | str = "cpu") -> TrainState:
    """A JAX TrainState with numpy leaves -> the port's TrainState of two
    `cfg` models (UNet3D or VNet) on `device`."""
    nets = []
    for params, state in ((js.params, js.model_state), (js.teacher_params, js.teacher_state)):
        net = build_model(cfg).to(device)
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
            el = el._replace(count=np.asarray(int(state.step), np.asarray(el.count).dtype))
        opt.append(el)
    return template._replace(step=np.asarray(int(state.step), np.asarray(template.step).dtype),
                             params=params, model_state=mstate, teacher_params=tparams,
                             teacher_state=tstate, opt_state=type(template.opt_state)(opt))
