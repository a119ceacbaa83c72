"""`--compute_dtype bfloat16` through the port's train step against the JAX
package's, on the CPU (the CLIs: tests/test_torch_bf16_cli.py).

One train step of a full-width folded UNet3D (feature_scale 4, the Pancreas
step config) and one of a full-width folded VNet (n_filters 16), dropout
0, patch (32, 32, 16), batch 4 of which 2 labeled, from a JAX TrainState
mapped into the port, the port's step given the JAX step's key, from which
it draws the same teacher noise (ops/threefry.py).
Both packages compute every conv in bfloat16 with float32 parameters, norm
statistics, heads and losses. The port's step takes the JAX step's kink
sides (ReLU, max pool) within train/device_check.py's margin, recorded
inside the jitted JAX step (tests/test_torch_vnet_train.py:_JaxKinkSides).

Tolerance rule, stated before the first run and not tuned afterwards:
|port - JAX| <= STEP_K x |JAX_bf16 - float64| per leaf (max over the
leaf), where float64 is the port's step from the same state and inputs
with every conv in float64 (the same kink sides shared), and STEP_K = 4.
bfloat16 rounds every conv output to 8 bits; a step amplifies any change
at that level to the size of bfloat16's own error (train/device_check.py:
one bfloat16 ulp at 1e-3 of the folded conv outputs moves the leaves to
0.97 of 2x that yardstick), so k is 4 and not 2. No tolerance is below
tests/test_torch_train_step.py's float32 one for the same leaf, and a step
scalar, one number whose yardstick is one difference, is also allowed two
bfloat16 ulps of its value (2^-8 |value|).
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dycon_paper_replication_tpu import config as jconfig
from dycon_paper_replication_tpu.models.factory import Model
from dycon_paper_replication_tpu.models.unet3d import UNet3DConfig as JaxUNetConfig
from dycon_paper_replication_tpu.models.unet3d import init_unet3d, unet3d_apply
from dycon_paper_replication_tpu.models.vnet import VNetConfig as JaxVNetConfig
from dycon_paper_replication_tpu.models.vnet import init_vnet, vnet_apply
from dycon_paper_replication_tpu.train.state import create_train_state, make_optimizer
from dycon_paper_replication_tpu.train.step import StepScalars as JaxScalars
from dycon_paper_replication_tpu.train.step import build_train_step as jax_build_train_step
from dycon_paper_replication_tpu_torch import config as tconfig
from dycon_paper_replication_tpu_torch import weights
from dycon_paper_replication_tpu_torch.models import UNet3DConfig, VNetConfig
from dycon_paper_replication_tpu_torch.train.device_check import (
    CPU,
    _normalised_bias,
    state_on,
)
from dycon_paper_replication_tpu_torch.train.step import SCALAR_METRICS, StepScalars
from dycon_paper_replication_tpu_torch.train.step import build_train_step
from test_torch_vnet_train import _JaxKinkSides, _batch, _flat, _momentum, _np

torch.set_num_threads(1)
PATCH = (32, 32, 16)
B, LBS = 4, 2
SCALARS = (5.0, 0.1 * np.exp(-5.0), 1.3, 0.3)
STEP_K = 4.0
BF16_ULP = 2.0 ** -8


def _nets(model):
    """(JAX net config, init, apply, port config, train-config extras) of a
    family in bfloat16."""
    if model == "vnet":
        return (JaxVNetConfig(dropout_rate=0.0, layout="folded", compute_dtype=jnp.bfloat16),
                init_vnet, vnet_apply,
                VNetConfig(dropout_rate=0.0, layout="folded", compute_dtype=torch.bfloat16),
                dict(model="vnet"))
    return (JaxUNetConfig(dropout_rate=0.0, layout="folded", compute_dtype=jnp.bfloat16),
            init_unet3d, unet3d_apply,
            UNet3DConfig(dropout_rate=0.0, layout="folded", compute_dtype=torch.bfloat16), {})


def _scalar_tol(name, want, ref, label_min):
    tol = 1e-6 + 1e-5 * abs(want) + (2.0 / label_min if name == "train_dice" else 0.0)
    return max(tol, STEP_K * abs(want - ref), BF16_ULP * abs(want))


@pytest.mark.parametrize("model", ["unet_3D", "vnet"])
def test_bf16_train_step_matches_jax(model):
    jnet, init, apply, net_cfg, extra = _nets(model)
    jcfg = jconfig.make_config("pancreas", patch_size=PATCH, batch_size=B, labeled_bs=LBS,
                               compute_dtype="bfloat16", **extra)
    optimizer = make_optimizer(lambda step: jcfg.base_lr, jcfg.momentum, jcfg.weight_decay,
                               jcfg.grad_clip_norm)
    js0 = create_train_state(Model(jnet, init, apply), jax.random.key(11), optimizer)
    step = jax.jit(jax_build_train_step(Model(jnet, init, apply), optimizer, jcfg,
                                        diagnostics=False))
    port = weights.jax_train_state_to_torch(_np(js0), net_cfg)
    ref = state_on(weights.jax_train_state_to_torch(
        _np(js0), dataclasses.replace(net_cfg, compute_dtype=torch.float64)), CPU, torch.float64)

    batch, key = _batch(1), jax.random.key(21)
    recorded = _JaxKinkSides()
    with contextlib.ExitStack() as stack:
        for patch in recorded.patches():
            stack.enter_context(patch)
        js1, metrics = step(js0, {k: jnp.asarray(v) for k, v in batch.items()}, key,
                            JaxScalars.make(*SCALARS))
        want = np.asarray(metrics["scalars"])
        jax.effects_barrier()
    tcfg = tconfig.make_config("pancreas", patch_size=PATCH, batch_size=B, labeled_bs=LBS,
                               device="cpu", compute_dtype="bfloat16", **extra)
    sides = recorded.sides()
    out = []
    for state in (port, ref):
        with sides.share():
            vec, _ = build_train_step(tcfg, lambda s: tcfg.base_lr)(
                state, {k: torch.from_numpy(v) for k, v in batch.items()},
                np.asarray(jax.random.key_data(key)), StepScalars(*SCALARS))
        out.append(vec.numpy().astype(np.float64))
    got, got64 = out
    assert sides.counts["relu_near"] > 0
    assert got[SCALAR_METRICS.index("skipped")] == 0 == want[SCALAR_METRICS.index("skipped")]
    label_min = batch["label"].reshape(B, -1).sum(1).min()
    for i, name in enumerate(SCALAR_METRICS):
        tol = _scalar_tol(name, float(want[i]), got64[i], label_min)
        assert abs(got[i] - want[i]) <= tol, (name, got[i], want[i], got64[i])

    back = weights.torch_train_state_to_jax(port, _np(js0))
    back64 = weights.torch_train_state_to_jax(ref, _np(js0))
    assert int(back.step) == int(js1.step) == 1
    path = {k: float(np.abs(v).max()) for k, v in _momentum(js1).items()}
    lr = jcfg.base_lr
    worst = 0.0
    for name, unit, pick in (("params", lr, lambda s: s.params),
                             ("teacher", lr, lambda s: s.teacher_params),
                             ("momentum", 1.0, _momentum)):
        g, w, r = (_flat(pick(s)) if name != "momentum" else pick(s)
                   for s in (back, js1, back64))
        assert g.keys() == w.keys() == r.keys()
        for k in w:
            w_k = np.asarray(w[k], np.float64)
            tol = 5e-3 * unit * path[k[:-1] + "w" if _normalised_bias(k) else k]
            if name != "momentum":
                tol += 2 * float(np.spacing(np.abs(np.asarray(w[k])).max()))
            tol = max(tol, STEP_K * float(np.abs(w_k - r[k]).max()))
            diff = float(np.abs(np.asarray(g[k], np.float64) - w_k).max())
            worst = max(worst, diff / tol)
            assert diff <= tol, f"{name} {k}: {diff} > {tol}"
    for pick in (lambda s: s.model_state, lambda s: s.teacher_state):
        g, w, r = (_flat(pick(s)) for s in (back, js1, back64))
        for k in w:
            w_k = np.asarray(w[k], np.float64)
            scale = 1e-5 + 1e-4 * np.abs(w_k)
            tol = max(1.0, STEP_K * float((np.abs(w_k - r[k]) / scale).max()))
            ratio = float((np.abs(np.asarray(g[k], np.float64) - w_k) / scale).max())
            worst = max(worst, ratio / tol)
            assert ratio <= tol, f"stats {k}: {ratio} > {tol}"
    print(f"{model}: worst leaf at {worst:.3f} of its tolerance")
