"""The port's train step against the JAX package's, on the CPU in float32.

One full-width UNet3D (feature_scale 4, filters 16..256) in the folded
layout with dropout 0, patch (32, 32, 16), batch 4 of which 2 labeled. The
JAX TrainState goes through the weight mapper into the port; the teacher
noise is drawn the way the JAX step draws it (the first key of
jax.random.split(rng, 3)) and handed to the port's step. The JAX step is
built and compiled once per module (it takes tens of seconds on a CPU).

Tolerances. The gradient of a conv in front of a norm is a sum over all
voxels of terms that largely cancel (the norm's backward removes their
mean), so float32 summation order shows in it, and the differences build up
along the optimizer's path. Each leaf is therefore held to its path length,
P = sum over the steps so far of max|momentum of the leaf| (from the JAX
states; for the bias of a conv followed by a norm, whose true gradient is
0, its conv weight's P). Measured on this test's inputs, in units of P
(parameters: of lr * P): the port and the JAX step differ by at most
8.2e-4 after one step and 2.8e-3 after two, and the port's own folded and
plain layouts, the same math summed in another order, by 8.3e-4 and
1.1e-3. So:
  * the 8 step scalars: rtol 1e-5, atol 1e-6;
  * momentum leaves: within 5e-3 x P;
  * parameters and teacher parameters: within 5e-3 x lr x P, plus 2 ulp of
    the leaf's largest magnitude (a BatchNorm scale of ~1 moves by ~2e-6 a
    step, and one float32 ulp of 1 is 1.2e-7);
  * the BatchNorm running stats, computed from forwards of parameters that
    already differ within the above: rtol 1e-4, atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dycon_paper_replication_tpu import config as jconfig
from dycon_paper_replication_tpu.models import layers as jlayers
from dycon_paper_replication_tpu.models.factory import Model
from dycon_paper_replication_tpu.models.unet3d import UNet3DConfig as JaxNetConfig
from dycon_paper_replication_tpu.models.unet3d import init_unet3d, projection_head, unet3d_apply
from dycon_paper_replication_tpu.train.state import create_train_state, make_optimizer
from dycon_paper_replication_tpu.train.step import StepScalars as JaxScalars
from dycon_paper_replication_tpu.train.step import build_train_step as jax_build_train_step
from dycon_paper_replication_tpu_torch import config as tconfig
from dycon_paper_replication_tpu_torch import weights
from dycon_paper_replication_tpu_torch.models import UNet3D, UNet3DConfig, layers
from dycon_paper_replication_tpu_torch.models.unet3d import projection_head as t_projection_head
from dycon_paper_replication_tpu_torch.train.step import (
    SCALAR_METRICS,
    StepScalars,
    build_train_step,
    ema_alpha,
)

torch.set_num_threads(1)
PATCH = (32, 32, 16)
B, LBS = 4, 2


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


@pytest.fixture(scope="module")
def jax_step():
    """The JAX model, config, step (compiled on first call) and a fresh state."""
    net_cfg = JaxNetConfig(dropout_rate=0.0, layout="folded")
    model = Model(net_cfg, init_unet3d, unet3d_apply)
    cfg = jconfig.make_config("pancreas", patch_size=PATCH, batch_size=B, labeled_bs=LBS)
    optimizer = make_optimizer(lambda step: cfg.base_lr, cfg.momentum, cfg.weight_decay,
                               cfg.grad_clip_norm)
    state = create_train_state(model, jax.random.key(11), optimizer)
    step = jax.jit(jax_build_train_step(model, optimizer, cfg, diagnostics=False))
    return cfg, step, state


def _port_step():
    cfg = tconfig.make_config("pancreas", patch_size=PATCH, batch_size=B, labeled_bs=LBS,
                              device="cpu")
    return build_train_step(cfg, lambda step: cfg.base_lr)


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


def _noise(key, shape):
    """The teacher noise exactly as the JAX step draws it from `key`."""
    noise_key = jax.random.split(key, 3)[0]
    return np.asarray(jnp.clip(0.1 * jax.random.normal(noise_key, shape, jnp.float32), -0.2, 0.2))


def _run_both(jax_step, js, port, batch, key, scalars):
    """One JAX step and one port step from equal states on the same inputs."""
    _, step, _ = jax_step
    new_js, metrics = step(js, {k: jnp.asarray(v) for k, v in batch.items()}, key,
                           JaxScalars.make(*scalars))
    got = _port_step()(port, {k: torch.from_numpy(v) for k, v in batch.items()},
                       torch.Generator().manual_seed(0), StepScalars(*scalars),
                       noise=torch.tensor(_noise(key, batch["image"].shape)))
    return new_js, np.asarray(metrics["scalars"]), got.numpy()


def _normalised_bias(key):
    """The bias of a conv followed by an InstanceNorm or BatchNorm."""
    return key.endswith(".b") and not key.startswith(("final.", "out_conv2."))


def _momentum(js):
    return _flat(next(el.trace for el in js.opt_state if "trace" in el._fields))


def _compare_states(port, js_steps, init_js, lr):
    """The port's state against the last of the JAX states `js_steps` (one
    per step from `init_js`), leaf by leaf (module doc)."""
    js = js_steps[-1]
    back = weights.torch_train_state_to_jax(port, init_js)
    assert int(back.step) == int(js.step)
    path = {}
    for st in js_steps:
        for k, v in _momentum(st).items():
            path[k] = path.get(k, 0.0) + float(np.abs(v).max())
    groups = [("params", back.params, js.params, lr),
              ("teacher", back.teacher_params, js.teacher_params, lr),
              ("momentum", _momentum(back), _momentum(js), 1.0)]
    for name, got_tree, want_tree, unit in groups:
        got, want = _flat(got_tree), _flat(want_tree)
        assert got.keys() == want.keys()
        for k in want:
            atol = 5e-3 * unit * path[k[:-1] + "w" if _normalised_bias(k) else k]
            if name != "momentum":
                atol += 2 * float(np.spacing(np.abs(want[k]).max()))
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=atol, err_msg=f"{name} {k}")
    for got_tree, want_tree in ((back.model_state, js.model_state),
                                (back.teacher_state, js.teacher_state)):
        got, want = _flat(got_tree), _flat(want_tree)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-5, err_msg=k)


@pytest.fixture(scope="module")
def two_steps(jax_step):
    """Step 1 (EMA alpha 0) and step 2 (alpha 0.5) on both sides."""
    cfg, _, js0 = jax_step
    cfg_net = UNet3DConfig(dropout_rate=0.0, layout="folded")
    port = weights.jax_train_state_to_torch(_np(js0), cfg_net)
    scalars = (5.0, 0.1 * np.exp(-5.0), 1.3, 0.3)
    js1, want1, got1 = _run_both(jax_step, js0, port, _batch(1), jax.random.key(21), scalars)
    snap1 = weights.torch_train_state_to_jax(port, _np(js0))
    js2, want2, got2 = _run_both(jax_step, js1, port, _batch(2), jax.random.key(22), scalars)
    return dict(js0=js0, js1=js1, js2=js2, snap1=snap1, port=port, cfg_net=cfg_net,
                lr=cfg.base_lr, scalars=[(got1, want1), (got2, want2)])


def test_train_state_round_trip_is_exact(jax_step):
    _, _, js = jax_step
    js = _np(js)
    port = weights.jax_train_state_to_torch(js, UNet3DConfig(layout="folded"))
    back = weights.torch_train_state_to_jax(port, js)
    want, got = jax.tree.leaves(js), jax.tree.leaves(back)
    assert jax.tree.structure(js) == jax.tree.structure(back)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
        assert np.asarray(g).dtype == np.asarray(w).dtype


@pytest.mark.parametrize("step", [0, 1])
def test_step_scalars_match(two_steps, step):
    got, want = two_steps["scalars"][step]
    assert got[SCALAR_METRICS.index("skipped")] == 0 == want[SCALAR_METRICS.index("skipped")]
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_first_step_state_matches(two_steps):
    port1 = weights.jax_train_state_to_torch(two_steps["snap1"], two_steps["cfg_net"])
    _compare_states(port1, [two_steps["js1"]], _np(two_steps["js0"]), two_steps["lr"])
    # alpha = 0 at the first step: the teacher is the updated student
    for t, s in zip(port1.teacher.parameters(), port1.student.parameters()):
        assert torch.equal(t, s)


def test_second_step_ema_matches(two_steps):
    assert ema_alpha(0, 0.99) == 0.0 and ema_alpha(1, 0.99) == 0.5
    assert ema_alpha(10 ** 6, 0.99) == np.float32(0.99)
    _compare_states(two_steps["port"], [two_steps["js1"], two_steps["js2"]],
                    _np(two_steps["js0"]), two_steps["lr"])


def test_nan_step_keeps_all_but_teacher_stats(jax_step, two_steps):
    """A NaN consistency weight makes the loss NaN with finite forwards."""
    js2, port = two_steps["js2"], two_steps["port"]
    before = weights.torch_train_state_to_jax(port, _np(js2))
    nan_scalars = (5.0, float("nan"), 1.3, 0.3)
    js3, want, got = _run_both(jax_step, js2, port, _batch(3), jax.random.key(23), nan_scalars)
    assert got[SCALAR_METRICS.index("skipped")] == 1 == want[SCALAR_METRICS.index("skipped")]
    after = weights.torch_train_state_to_jax(port, _np(js2))
    for field in ("step", "params", "model_state", "teacher_params", "opt_state"):
        for a, b in zip(jax.tree.leaves(getattr(after, field)),
                        jax.tree.leaves(getattr(before, field))):
            np.testing.assert_array_equal(a, b, err_msg=field)
    # the teacher's stats advanced, as the JAX step's did
    moved = _flat(after.teacher_state)
    old = _flat(before.teacher_state)
    assert any(not np.array_equal(moved[k], old[k]) for k in old)
    for k, v in _flat(js3.teacher_state).items():
        np.testing.assert_allclose(moved[k], v, rtol=1e-4, atol=1e-5, err_msg=k)


def test_batch_norm_train_matches(rng):
    x = (rng.normal(size=(2, 3, 4, 2, 6)) * 2 + 0.7).astype(np.float32)
    scale = rng.normal(size=6).astype(np.float32)
    bias = rng.normal(size=6).astype(np.float32)
    mean = rng.normal(size=6).astype(np.float32)
    var = rng.random(6).astype(np.float32) + 0.5
    want, want_state = jlayers.batch_norm({"scale": scale, "bias": bias},
                                          {"mean": mean, "var": var}, jnp.asarray(x), train=True)
    y, new_mean, new_var = layers.batch_norm_train(*(torch.from_numpy(a) for a in
                                                     (x, scale, bias, mean, var)))
    np.testing.assert_allclose(y.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(new_mean.numpy(), want_state["mean"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(new_var.numpy(), want_state["var"], rtol=1e-5, atol=1e-6)


def test_projection_head_train_matches(rng):
    jcfg = JaxNetConfig(feature_scale=16)
    params, state = _np(jax.jit(init_unet3d, static_argnums=1)(jax.random.key(4), jcfg))
    state = jax.tree.map(lambda v: v + 0.25, state)  # running stats away from 0 / 1
    center = rng.normal(size=(2, 2, 2, 1, 64)).astype(np.float32)
    want, updates = projection_head(params, state, jnp.asarray(center), jcfg, train=True,
                                    aspp_key=None)
    net = UNet3D(UNet3DConfig(feature_scale=16)).train()
    net.load_state_dict(weights.jax_tree_to_state_dict(params, state))
    got = t_projection_head(net, torch.from_numpy(center))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
    _, new_state = weights.state_dict_to_jax_tree(net.state_dict())
    for k, v in _flat(updates["projection"]).items():
        np.testing.assert_allclose(_flat(new_state["projection"])[k], v, rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    # eval mode reads the running stats and leaves them alone
    net.eval()
    before = {k: v.clone() for k, v in net.named_buffers()}
    want_eval, _ = projection_head(params, _np(new_state), jnp.asarray(center), jcfg,
                                   train=False, aspp_key=None)
    got_eval = t_projection_head(net, torch.from_numpy(center))
    np.testing.assert_allclose(got_eval.detach().numpy(), np.asarray(want_eval), rtol=1e-4,
                               atol=1e-5)
    assert all(torch.equal(v, before[k]) for k, v in net.named_buffers())
