"""`--model vnet` and `--use_aspp 1` through the port's train step against
the JAX package's, on the CPU in float32 (the trainer and the test CLIs:
tests/test_torch_vnet_cli.py).

One step of a full-width folded VNet (n_filters 16, dropout 0)
and one of a full-width folded UNet3D with ASPP, each from a JAX TrainState
mapped into the port, patch (32, 32, 16), batch 4 of which 2 labeled, the
teacher noise drawn as the JAX step draws it. ASPP's dropout (rate 0.5,
fixed) draws the same numpy masks in both packages: the JAX step's two
calls (teacher, then student) at its trace, handed to the port's in that
order. The port's step takes the JAX step's kink sides (ReLU, max pool)
within train/device_check.py's margin, recorded inside the jitted JAX step
(`_JaxKinkSides`): without them, the few dozen ReLUs of this case that lie
within float32 noise of 0 move the VNet's decoder weight gradients (in
front of train-mode BatchNorms) by up to 20x the tolerance below, as much
as the port's own folded and plain layouts differ; with them the port's
float32 step agrees with a float64 one to 2e-5 relative. Held to
tests/test_torch_train_step.py's tolerances: the 8 step scalars rtol 1e-5
+ atol 1e-6, train_dice (a count of probabilities thresholded at 0.5) also
within one flipped voxel per sample (train/device_check.py's allowance);
momentum 5e-3 x P, parameters and teacher parameters 5e-3 x lr x P + 2 ulp
(P = max|momentum of the leaf|, a normalised conv bias taking its
weight's); the running stats rtol 1e-4 + atol 1e-5.
"""

import contextlib
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dycon_paper_replication_tpu import config as jconfig
from dycon_paper_replication_tpu.models import layers as jlayers
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
from dycon_paper_replication_tpu_torch.models import UNet3DConfig, VNetConfig, layers
from dycon_paper_replication_tpu_torch.train.device_check import KinkSides, _normalised_bias
from dycon_paper_replication_tpu_torch.train.step import SCALAR_METRICS, StepScalars
from dycon_paper_replication_tpu_torch.train.step import build_train_step

torch.set_num_threads(1)
PATCH = (32, 32, 16)
B, LBS = 4, 2
SCALARS = (5.0, 0.1 * np.exp(-5.0), 1.3, 0.3)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _batch(seed):
    rng = np.random.default_rng(seed)
    grid = np.stack(np.meshgrid(*[np.arange(s) for s in PATCH], indexing="ij"), -1)
    labels = []
    for _ in range(B):
        center = rng.uniform(0.3, 0.7, 3) * PATCH
        radii = rng.uniform(0.3, 0.5, 3) * PATCH
        labels.append((((grid - center) / radii) ** 2).sum(-1) <= 1.0)
    label = np.stack(labels).astype(np.int32)
    image = (0.4 * label + 0.1 * rng.standard_normal(label.shape)).astype(np.float32)[..., None]
    return {"image": image, "label": label}


def _momentum(js):
    return _flat(next(el.trace for el in js.opt_state if "trace" in el._fields))


class _SharedMasks:
    """The JAX layers.dropout drawing numpy keep masks at its trace, and the
    port's taking the same masks in the same order from `queue`."""

    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)
        self.masks = []
        self.queue = iter(())

    def jax(self, x, rate, key, train):
        if not train or rate == 0.0 or key is None:
            return x
        m = self.rng.random(x.shape) < 1.0 - rate
        self.masks.append(m)
        return jnp.where(m, x / (1.0 - rate), 0.0).astype(x.dtype)

    def port(self, x, rate, generator, train):
        if not train or rate == 0.0 or generator is None:
            return x
        m = next(self.queue)
        assert m.shape == tuple(x.shape)
        return torch.where(torch.from_numpy(m), x / (1.0 - rate), torch.zeros((), dtype=x.dtype))


class _JaxKinkSides:
    """The JAX step's kink sides (train/device_check.py: KinkSides), taken
    inside its jitted program: jax.nn.relu and the UNet3D's max pools are
    wrapped, while the step is traced, with an ordered debug callback that
    hands each ReLU's input > 0 and each pool's argmax over its 2^3 blocks
    to the host when the step runs (teacher, then student, as the port's
    step runs them). Sides recorded from an eager rerun would not do: the
    eager program's float32 order differs from the jitted one, and in the
    VNet's train-mode BatchNorms a few ReLUs that flip between the two move
    a decoder weight's gradient by several percent."""

    def __init__(self):
        self.relu, self.pool = [], []

    def patches(self):
        from dycon_paper_replication_tpu.models import unet3d as junet
        from dycon_paper_replication_tpu.models import unet3d_folded as jfolded
        from dycon_paper_replication_tpu.ops import folding as jfolding

        real_relu = jax.nn.relu
        real_pool, real_consume = junet.max_pool_2x, jfolding.pool_consume_fold

        def record(store):
            return lambda v: store.append(torch.from_numpy(np.array(v)))

        def relu(x):
            jax.debug.callback(record(self.relu), x > 0, ordered=True)
            return real_relu(x)

        def max_pool_2x(x, data_format="NDHWC"):
            b, d1, d2, d3, c = x.shape
            blocks = x.reshape(b, d1 // 2, 2, d2 // 2, 2, d3 // 2, 2, c)
            blocks = blocks.transpose(0, 1, 3, 5, 7, 2, 4, 6).reshape(b, d1 // 2, d2 // 2, d3 // 2,
                                                                      c, 8)
            jax.debug.callback(record(self.pool), jnp.argmax(blocks, -1), ordered=True)
            return real_pool(x, data_format=data_format)

        def pool_consume_fold(x):
            b, g1, g2, g3, lanes = x.shape
            blocks = x.reshape(b, g1, g2, g3, lanes // 8, 8)
            jax.debug.callback(record(self.pool), jnp.argmax(blocks, -1), ordered=True)
            return real_consume(x)

        return [mock.patch.object(jax.nn, "relu", relu),
                mock.patch.object(junet, "max_pool_2x", max_pool_2x),
                mock.patch.object(jfolded, "max_pool_2x", max_pool_2x),
                mock.patch.object(jfolded, "pool_consume_fold", pool_consume_fold),
                mock.patch.object(jfolding, "pool_consume_fold", pool_consume_fold)]

    def sides(self):
        return KinkSides.given(self.relu, self.pool, [])


@pytest.mark.parametrize("model", ["vnet", "aspp"])
def test_train_step_matches_jax(monkeypatch, model):
    if model == "vnet":
        jnet, apply, init = JaxVNetConfig(dropout_rate=0.0, layout="folded"), vnet_apply, init_vnet
        net_cfg = VNetConfig(dropout_rate=0.0, layout="folded")
        extra = dict(model="vnet")
    else:
        jnet = JaxUNetConfig(dropout_rate=0.0, layout="folded", use_aspp=True)
        apply, init = unet3d_apply, init_unet3d
        net_cfg = UNet3DConfig(dropout_rate=0.0, layout="folded", use_aspp=True)
        extra = dict(use_aspp=True)
    masks = _SharedMasks(9)
    monkeypatch.setattr(jlayers, "dropout", masks.jax)
    monkeypatch.setattr(layers, "dropout", masks.port)

    jcfg = jconfig.make_config("pancreas", patch_size=PATCH, batch_size=B, labeled_bs=LBS,
                               **extra)
    optimizer = make_optimizer(lambda step: jcfg.base_lr, jcfg.momentum, jcfg.weight_decay,
                               jcfg.grad_clip_norm)
    js0 = create_train_state(Model(jnet, init, apply), jax.random.key(11), optimizer)
    step = jax.jit(jax_build_train_step(Model(jnet, init, apply), optimizer, jcfg,
                                        diagnostics=False))
    port = weights.jax_train_state_to_torch(_np(js0), net_cfg)
    back = weights.torch_train_state_to_jax(port, _np(js0))
    for w, g in zip(jax.tree.leaves(_np(js0)), jax.tree.leaves(back)):
        np.testing.assert_array_equal(g, w)  # the train-state mappers, exactly

    batch, key = _batch(1), jax.random.key(21)
    recorded = _JaxKinkSides()
    with contextlib.ExitStack() as stack:
        for patch in recorded.patches():
            stack.enter_context(patch)
        js1, metrics = step(js0, {k: jnp.asarray(v) for k, v in batch.items()}, key,
                            JaxScalars.make(*SCALARS))
        want = np.asarray(metrics["scalars"])
        jax.effects_barrier()
    assert len(masks.masks) == (2 if model == "aspp" else 0)  # teacher, student
    masks.queue = iter(masks.masks)
    noise = np.array(jnp.clip(0.1 * jax.random.normal(jax.random.split(key, 3)[0],
                                                      batch["image"].shape), -0.2, 0.2))
    tcfg = tconfig.make_config("pancreas", patch_size=PATCH, batch_size=B, labeled_bs=LBS,
                               device="cpu", **extra)
    sides = recorded.sides()
    with sides.share():
        got, _ = build_train_step(tcfg, lambda s: tcfg.base_lr)(
            port, {k: torch.from_numpy(v) for k, v in batch.items()}, torch.Generator(),
            StepScalars(*SCALARS), noise=torch.from_numpy(noise))
    assert next(masks.queue, None) is None and sides.counts["relu_near"] > 0
    assert got[SCALAR_METRICS.index("skipped")] == 0 == want[SCALAR_METRICS.index("skipped")]
    dice = SCALAR_METRICS.index("train_dice")
    others = [i for i in range(len(SCALAR_METRICS)) if i != dice]
    np.testing.assert_allclose(got.numpy()[others], want[others], rtol=1e-5, atol=1e-6)
    # train_dice counts probabilities thresholded at 0.5: one voxel per
    # sample may sit on the other side (train/device_check.py's allowance)
    label_min = batch["label"].reshape(B, -1).sum(1).min()
    assert abs(got[dice] - want[dice]) <= 1e-6 + 1e-5 * abs(want[dice]) + 2.0 / label_min

    back = weights.torch_train_state_to_jax(port, _np(js0))
    assert int(back.step) == int(js1.step) == 1
    path = {k: float(np.abs(v).max()) for k, v in _momentum(js1).items()}
    lr = jcfg.base_lr
    for name, got_tree, want_tree, unit in (
            ("params", back.params, js1.params, lr),
            ("teacher", back.teacher_params, js1.teacher_params, lr),
            ("momentum", _momentum(back), _momentum(js1), 1.0)):
        g, w = _flat(got_tree), _flat(want_tree)
        assert g.keys() == w.keys()
        for k in w:
            atol = 5e-3 * unit * path[k[:-1] + "w" if _normalised_bias(k) else k]
            if name != "momentum":
                atol += 2 * float(np.spacing(np.abs(w[k]).max()))
            np.testing.assert_allclose(g[k], w[k], rtol=0, atol=atol, err_msg=f"{name} {k}")
    for got_tree, want_tree in ((back.model_state, js1.model_state),
                                (back.teacher_state, js1.teacher_state)):
        g, w = _flat(got_tree), _flat(want_tree)
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4, atol=1e-5, err_msg=k)
