"""The port's random streams (ops/threefry.py, and the models', step's and
trainer's use of them) against the JAX package's jax.random, on the CPU.

Tolerances, stated before the first run:
  * key, split, fold_in, bits, uniform (also over a range) and bernoulli
    bit-equal to jax.random, numpy and torch versions, for several seeds and
    shapes; a row range of a global shape, and the last rows of a shape of
    more than 2**32 elements against JAX's own threefry2x32 primitive on
    their counters (the counter layout itself is held on small shapes);
  * normal within 4 float32 ulp elementwise (XLA's log1p rounds otherwise);
  * the fused dropout's forward and its VJP, through the plain version
    (the autograd Function on the CPU), bit-equal to JAX's layers.dropout
    and jax.vjp of it in float32, and within one bf16 rounding in bf16;
  * weights.init_jax_tree against init_unet3d (with ASPP), the full-width
    Pancreas UNet3D (feature_scale 4) and init_vnet at jax.random.key(seed):
    the same leaves, uniform-drawn ones (biases) and the constant ones
    bit-equal, normal-drawn ones (kernels, the projection's BatchNorm
    scales) within 4 ulp;
  * every dropout call of the plain and folded UNet3D (with ASPP) and of the
    plain and folded VNet in training mode: the same keys, in the same
    order, on the same shapes as the JAX model's, and the port's output
    equal to where(JAX's mask, x / keep, 0) of its own input; the step's
    noise within 4 ulp of the JAX step's draw from the first of its three
    keys, the student's and teacher's forwards given the second and third;
  * in a 2-rank gloo data-parallel step, each rank's teacher noise and
    dropout masks equal to the rows of the single-process step's;
  * both packages' Trainers from one config and seed (Pancreas, the tiny
    tree of tests/test_torch_trainer_loop.py, patch (32, 32, 16), batch 2 of
    which 1 labeled, float32), with nothing random handed across (no
    weights, no noise, no dropout masks); only the JAX steps' kink sides
    (ReLU, max pool) are shared, as tests/test_torch_canonical_run.py shares
    them. Each run is killed in process at its 3rd dispatch, after the save
    at 2, and resumed with `auto` to 4 (JAX's fold_in of the step count
    applies there). The 8 step scalars within rtol 1e-5 + atol 1e-6 at step
    1 and rtol 1e-4 + atol 1e-5 after that; the keys each step gets equal.
"""

import contextlib
import dataclasses
import math
import shutil
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dycon_paper_replication_tpu import config as jconfig
from dycon_paper_replication_tpu.models import layers as jlayers
from dycon_paper_replication_tpu.models.unet3d import UNet3DConfig as JaxUNetConfig
from dycon_paper_replication_tpu.models.unet3d import init_unet3d, unet3d_apply
from dycon_paper_replication_tpu.models.vnet import VNetConfig as JaxVNetConfig
from dycon_paper_replication_tpu.models.vnet import init_vnet, vnet_apply
from dycon_paper_replication_tpu.train import trainer as jtrainer
from dycon_paper_replication_tpu.utils import checkpoint as jcheckpoint
from dycon_paper_replication_tpu_torch import config as tconfig
from dycon_paper_replication_tpu_torch import parallel, weights
from dycon_paper_replication_tpu_torch.data import synthetic
from dycon_paper_replication_tpu_torch.models import (
    UNet3DConfig,
    VNetConfig,
    build_model,
    layers,
)
from dycon_paper_replication_tpu_torch.ops import threefry
from dycon_paper_replication_tpu_torch.train import trainer as ttrainer
from dycon_paper_replication_tpu_torch.train.device_check import KinkSides
from dycon_paper_replication_tpu_torch.train.state import create_train_state
from dycon_paper_replication_tpu_torch.train.step import StepScalars, build_train_step
from test_torch_vnet_train import _JaxKinkSides

torch.set_num_threads(1)
ULP = 4
SEEDS = (0, 1, 1337, 2 ** 31 + 5)
SHAPES = ((7,), (3, 5, 4), (2, 9, 9, 7, 1), (4, 6, 6, 3, 16))
SPAWN_TIMEOUT = 300


def _words(key) -> np.ndarray:
    return np.asarray(jax.random.key_data(key))


def _ulps(a, b) -> int:
    def ordered(v):
        i = np.asarray(v, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return int(np.abs(ordered(a) - ordered(b)).max()) if np.size(a) else 0


# ---------------------------------------------------------------- the streams


@pytest.mark.parametrize("seed", SEEDS)
def test_key_split_fold_in_bit_equal(seed):
    k = jax.random.key(seed)
    np.testing.assert_array_equal(threefry.key(seed), _words(k))
    for n in (2, 3, 16, 32):
        np.testing.assert_array_equal(threefry.split(threefry.key(seed), n),
                                      _words(jax.random.split(k, n)))
    for d in (0, 1, 1200, 20000, 2 ** 32 - 1):
        np.testing.assert_array_equal(threefry.fold_in(threefry.key(seed), d),
                                      _words(jax.random.fold_in(k, d)))
    # a key twice removed, as the trainer's stream takes them
    k2 = jax.random.split(jax.random.fold_in(k, 7))[1]
    np.testing.assert_array_equal(threefry.split(threefry.fold_in(threefry.key(seed), 7))[1],
                                  _words(k2))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", SEEDS[:3])
def test_bits_uniform_bernoulli_bit_equal(seed, shape):
    k, tk = jax.random.key(seed), threefry.key(seed)
    want = np.asarray(jax.random.bits(k, shape))
    np.testing.assert_array_equal(threefry.bits(tk, shape), want)
    np.testing.assert_array_equal(threefry.bits(tk, shape, device="cpu").numpy(), want)
    for lo, hi in ((0.0, 1.0), (-0.3, 0.7), (-1 / math.sqrt(27), 1 / math.sqrt(27))):
        want = np.asarray(jax.random.uniform(k, shape, jnp.float32, lo, hi)).view(np.uint32)
        np.testing.assert_array_equal(threefry.uniform(tk, shape, lo, hi).view(np.uint32), want)
        got = threefry.uniform(tk, shape, lo, hi, device="cpu").numpy().view(np.uint32)
        np.testing.assert_array_equal(got, want)
    for p in (0.5, 0.7):
        want = np.asarray(jax.random.bernoulli(k, p, shape))
        np.testing.assert_array_equal(threefry.bernoulli(tk, p, shape), want)
        np.testing.assert_array_equal(threefry.bernoulli(tk, p, shape, device="cpu").numpy(),
                                      want)


def test_rows_and_counters_past_2_to_32():
    k, tk = jax.random.key(5), threefry.key(5)
    shape = (6, 5, 4, 3)
    rows = [1, 2, 4, 5]
    want = np.asarray(jax.random.bits(k, shape))[rows]
    np.testing.assert_array_equal(threefry.bits(tk, shape, rows=rows), want)
    np.testing.assert_array_equal(threefry.bits(tk, shape, rows=rows, device="cpu").numpy(),
                                  want)
    np.testing.assert_array_equal(
        threefry.uniform(tk, shape, rows=rows, device="cpu").numpy(),
        np.asarray(jax.random.uniform(k, shape))[rows])
    # the counter layout: element i hashes (i >> 32, i & 0xffffffff)
    from jax._src import prng

    hi, lo = prng.iota_2x32_shape(shape)
    o0, o1 = prng.threefry2x32_p.bind(*(jnp.uint32(w) for w in _words(k)), hi, lo)
    np.testing.assert_array_equal(np.asarray(o0 ^ o1), np.asarray(jax.random.bits(k, shape)))
    # the last 2 rows of (2**20 + 3, 4096): flat indices past 2**32
    big = (2 ** 20 + 3, 4096)
    last = [big[0] - 2, big[0] - 1]
    idx = np.asarray(last, np.uint64)[:, None] * np.uint64(big[1]) + np.arange(big[1],
                                                                               dtype=np.uint64)
    assert idx.max() >= 2 ** 32
    o0, o1 = prng.threefry2x32_p.bind(*(jnp.uint32(w) for w in _words(k)),
                                      jnp.asarray((idx >> np.uint64(32)).astype(np.uint32)),
                                      jnp.asarray((idx & np.uint64(0xFFFFFFFF)).astype(np.uint32)))
    want = np.asarray(o0 ^ o1)
    np.testing.assert_array_equal(threefry.bits(tk, big, rows=last), want)
    np.testing.assert_array_equal(threefry.bits(tk, big, rows=last, device="cpu").numpy(), want)


@pytest.mark.parametrize("seed", SEEDS[:3])
def test_normal_within_4_ulp(seed):
    for shape in ((1 << 16,), (2, 16, 16, 8, 1)):
        want = np.asarray(jax.random.normal(jax.random.key(seed), shape))
        assert _ulps(threefry.normal(threefry.key(seed), shape), want) <= ULP
        assert _ulps(threefry.normal(threefry.key(seed), shape, device="cpu").numpy(),
                     want) <= ULP
    # the step's teacher noise from the first of the step key's three keys
    key = jax.random.split(jax.random.key(seed), 3)[0]
    shape = (2, 16, 16, 8, 1)
    want = np.asarray(jnp.clip(0.1 * jax.random.normal(key, shape, jnp.float32), -0.2, 0.2))
    got = threefry.teacher_noise(threefry.split(threefry.key(seed), 3)[0], shape)
    assert got.dtype == torch.float32 and _ulps(got.numpy(), want) <= ULP


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rate", [0.3, 0.5])
def test_dropout_forward_and_vjp(dtype, rate):
    rng = np.random.default_rng(3)
    shape = (2, 8, 8, 6, 16)
    x32 = rng.standard_normal(shape).astype(np.float32)
    dy32 = rng.standard_normal(shape).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)
    jx, jdy = jnp.asarray(x32).astype(jdt), jnp.asarray(dy32).astype(jdt)
    k = jax.random.key(11)
    y, vjp = jax.vjp(lambda v: jlayers.dropout(v, rate, k, True), jx)
    (dx,) = vjp(jdy)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(tdt).requires_grad_(True)
    ty = layers.dropout(tx, rate, _words(k), True)
    (tdx,) = torch.autograd.grad(ty, tx, torch.from_numpy(np.array(jdy.astype(jnp.float32)))
                                 .to(tdt))
    for got, want in ((ty.detach(), y), (tdx, dx)):
        got = got.float().numpy()
        want = np.asarray(want.astype(jnp.float32))
        np.testing.assert_array_equal(got == 0, want == 0)
        if dtype == "float32":
            np.testing.assert_array_equal(got, want)
        else:  # one bf16 rounding: 2**-8 of the value
            np.testing.assert_allclose(got, want, rtol=2.0 ** -8, atol=0)
    # the identity without a key, outside training or at rate 0
    for args in ((None, True), (_words(k), False)):
        assert layers.dropout(tx, rate, *args) is tx
    assert layers.dropout(tx, 0.0, _words(k), True) is tx


# ---------------------------------------------------------------- initial weights


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


NORMAL_DRAWN = (".w", "projection.bn1.scale", "projection.bn2.scale")
INIT_CASES = {
    "unet_aspp": (UNet3DConfig(feature_scale=16, proj_hidden=32, proj_out=16, use_aspp=True),
                  lambda k: init_unet3d(k, JaxUNetConfig(feature_scale=16, proj_hidden=32,
                                                         proj_out=16, use_aspp=True))),
    "unet_pancreas": (UNet3DConfig(), lambda k: init_unet3d(k, JaxUNetConfig())),
    "vnet": (VNetConfig(n_filters=4, proj_hidden=32, proj_out=16),
             lambda k: init_vnet(k, JaxVNetConfig(n_filters=4, proj_hidden=32, proj_out=16))),
}


@pytest.mark.parametrize("case,seed", [("unet_aspp", 0), ("unet_aspp", 1337),
                                       ("unet_pancreas", 1337), ("vnet", 0), ("vnet", 1337)])
def test_init_jax_tree_draws_jax_numbers(case, seed):
    cfg, jax_init = INIT_CASES[case]
    jp, js = jax_init(jax.random.key(seed))  # eagerly, as the JAX Trainer inits
    tp, ts = weights.init_jax_tree(cfg, seed)
    want, got = _flat(jp), _flat(tp)
    assert got.keys() == want.keys()
    for name in want:
        assert got[name].shape == want[name].shape and got[name].dtype == np.float32, name
        if name.endswith(NORMAL_DRAWN):
            assert _ulps(got[name], want[name]) <= ULP, name
        else:
            np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    want, got = _flat(js), _flat(ts)
    assert got.keys() == want.keys()
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


# ---------------------------------------------------------------- the models' and step's draws


class _Recorder:
    """Both packages' layers.dropout, recording each call's key and shape;
    the JAX one its mask (jax.random.bernoulli), the port's its input and
    output."""

    def __init__(self):
        self.jax, self.port = [], []

    def jax_dropout(self, x, rate, key, train):
        """Inside the jitted JAX forward: the call's key and mask reach the
        host through an ordered debug callback."""
        if train and rate != 0.0 and key is not None:
            keep = 1.0 - rate

            def store(words, mask):
                self.jax.append(dict(key=np.array(words), shape=tuple(x.shape), keep=keep,
                                     mask=np.array(mask)))

            jax.debug.callback(store, jax.random.key_data(key),
                               jax.random.bernoulli(key, keep, x.shape), ordered=True)
        return jlayers_dropout(x, rate, key, train)

    def port_dropout(self, x, rate, key, train):
        y = layers_dropout(x, rate, key, train)
        if train and rate != 0.0 and key is not None:
            self.port.append(dict(key=np.asarray(key), shape=tuple(x.shape),
                                  x=x.detach().clone(), y=y.detach().clone()))
        return y

    def patches(self):
        return (mock.patch.object(jlayers, "dropout", self.jax_dropout),
                mock.patch.object(layers, "dropout", self.port_dropout))

    def check(self, n):
        assert len(self.jax) == len(self.port) == n
        for j, p in zip(self.jax, self.port):
            np.testing.assert_array_equal(p["key"], j["key"])
            assert p["shape"] == j["shape"]
            keep = torch.from_numpy(j["mask"])
            want = torch.where(keep, p["x"] / j["keep"], torch.zeros(()))
            torch.testing.assert_close(p["y"], want, rtol=0, atol=0)


jlayers_dropout, layers_dropout = jlayers.dropout, layers.dropout
MODEL_CASES = {  # (the port's config, the JAX config, JAX apply, dropout calls)
    "unet_plain": (UNet3DConfig(feature_scale=16, proj_hidden=32, proj_out=16, use_aspp=True),
                   JaxUNetConfig(feature_scale=16, proj_hidden=32, proj_out=16, use_aspp=True),
                   unet3d_apply, 3),
    "unet_folded": (UNet3DConfig(feature_scale=16, proj_hidden=32, proj_out=16, use_aspp=True,
                                 layout="folded"),
                    JaxUNetConfig(feature_scale=16, proj_hidden=32, proj_out=16, use_aspp=True,
                                  layout="folded"), unet3d_apply, 3),
    "vnet_plain": (VNetConfig(n_filters=4, proj_hidden=32, proj_out=16),
                   JaxVNetConfig(n_filters=4, proj_hidden=32, proj_out=16), vnet_apply, 2),
    "vnet_folded": (VNetConfig(n_filters=4, proj_hidden=32, proj_out=16, layout="folded"),
                    JaxVNetConfig(n_filters=4, proj_hidden=32, proj_out=16, layout="folded"),
                    vnet_apply, 2),
}


@pytest.mark.parametrize("case", list(MODEL_CASES))
def test_model_dropout_draws_jax_masks(case):
    cfg, jcfg, japply, n_calls = MODEL_CASES[case]
    params, state = weights.init_jax_tree(cfg, 3)
    net = build_model(cfg)
    net.load_state_dict(weights.jax_tree_to_state_dict(params, state))
    x = np.random.default_rng(4).standard_normal((2, 32, 32, 16, 1)).astype(np.float32)
    key = jax.random.key(9)
    rec = _Recorder()
    with contextlib.ExitStack() as stack:
        for p in rec.patches():
            stack.enter_context(p)
        forward = jax.jit(lambda p, s, v, k: japply(p, s, v, jcfg, train=True, rng=k))
        forward(params, state, jnp.asarray(x), key)
        jax.effects_barrier()
        net.train()(torch.from_numpy(x), key=_words(key))
    rec.check(n_calls)
    # a folded model drops out its last decoder map in the folded layout
    if cfg.layout == "folded":
        assert rec.port[1]["shape"][-1] == 8 * cfg.filters[0]


def test_step_draws_the_jax_steps_keys():
    """The step splits its key as the JAX step (train/step.py:191): noise,
    student, teacher; the student's and teacher's forwards get the second
    and third keys (the model tests above hold what each forward draws)."""
    cfg = tconfig.make_config("pancreas", patch_size=(32, 32, 16), batch_size=2, labeled_bs=1,
                              device="cpu")
    net_cfg = UNet3DConfig(feature_scale=16, proj_hidden=32, proj_out=16)
    params, mstate = weights.init_jax_tree(net_cfg, 0)
    student = build_model(net_cfg)
    student.load_state_dict(weights.jax_tree_to_state_dict(params, mstate))
    state = create_train_state(student)
    image = np.random.default_rng(1).standard_normal((2, 32, 32, 16, 1)).astype(np.float32)
    batch = {"image": torch.from_numpy(image),
             "label": torch.from_numpy((image[..., 0] > 0.5).astype(np.int32))}
    key = jax.random.key(21)
    noise_key, student_key, teacher_key = jax.random.split(key, 3)
    seen, noises = [], []
    real_forward, real_noise = type(student).forward, threefry.teacher_noise

    def forward(net, x, **kw):
        seen.append(("teacher" if net is state.teacher else "student", kw.get("key")))
        return real_forward(net, x, **kw)

    def noise(k, shape, rows, device):
        out = real_noise(k, shape, rows, device)
        noises.append((np.asarray(k), out))
        return out

    with mock.patch.object(type(student), "forward", forward), \
            mock.patch.object(threefry, "teacher_noise", noise):
        build_train_step(cfg, lambda s: cfg.base_lr)(state, batch, _words(key),
                                                     StepScalars(5.0, 0.01, 1.3, 0.3))
    np.testing.assert_array_equal(noises[0][0], _words(noise_key))
    want = np.asarray(jnp.clip(0.1 * jax.random.normal(noise_key, image.shape), -0.2, 0.2))
    assert _ulps(noises[0][1].numpy(), want) <= ULP
    assert [who for who, _ in seen] == ["teacher", "student"]
    np.testing.assert_array_equal(seen[0][1], _words(teacher_key))
    np.testing.assert_array_equal(seen[1][1], _words(student_key))


# ---------------------------------------------------------------- data parallelism


DP_B, DP_LBS, DP_PATCH = 4, 2, (32, 32, 16)


def _dp_draws(rank, world, device, seed):
    """One step of a tiny folded UNet3D (dropout 0.3), on this rank's rows
    under `world` > 1 ranks or the whole batch in one process: the teacher
    noise, and each dropout call's mask (the layer's own function on ones
    with the layer's key and rows)."""
    shard = parallel.Shard(rank, world, DP_B, DP_LBS) if world > 1 else None
    net_cfg = UNet3DConfig(feature_scale=16, proj_hidden=32, proj_out=16, layout="folded")
    params, mstate = weights.init_jax_tree(net_cfg, seed)
    student = build_model(net_cfg)
    student.load_state_dict(weights.jax_tree_to_state_dict(params, mstate))
    state = create_train_state(student)
    rng = np.random.default_rng(seed)
    image = (0.1 * rng.standard_normal((DP_B, *DP_PATCH, 1))).astype(np.float32)
    batch = parallel.shard_batch(shard, {"image": image,
                                         "label": (image[..., 0] > 0).astype(np.int32)})
    cfg = tconfig.make_config("pancreas", patch_size=DP_PATCH, batch_size=DP_B,
                              labeled_bs=DP_LBS, device="cpu")
    draws = {"noise": None, "masks": []}
    real_noise, real_dropout = threefry.teacher_noise, threefry.dropout

    def noise(k, shape, rows, device):
        draws["noise"] = real_noise(k, shape, rows, device)
        return draws["noise"]

    def dropout(x, k, keep, rows=None):
        draws["masks"].append(real_dropout(torch.ones_like(x), k, keep, rows) != 0)
        return real_dropout(x, k, keep, rows)

    with mock.patch.object(threefry, "teacher_noise", noise), \
            mock.patch.object(threefry, "dropout", dropout):
        build_train_step(cfg, lambda s: cfg.base_lr, shard)(
            state, {k: torch.from_numpy(v) for k, v in batch.items()},
            threefry.key(seed), StepScalars(5.0, 0.01, 1.3, 0.3))
    if shard is None:
        return draws
    every = [None] * world  # every rank's, returned by rank 0
    torch.distributed.all_gather_object(every, draws)
    return every


def test_data_parallel_ranks_draw_their_rows():
    whole = _dp_draws(0, 1, "cpu", 8)
    ranks = parallel.launch(_dp_draws, 2, device="cpu", args=(8,), timeout=SPAWN_TIMEOUT)
    assert len(whole["masks"]) == 4  # teacher and student, centre and decoder
    for rank, got in enumerate(ranks):
        rows = list(parallel.Shard(rank, 2, DP_B, DP_LBS).rows)
        torch.testing.assert_close(got["noise"], whole["noise"][rows], rtol=0, atol=0)
        assert len(got["masks"]) == len(whole["masks"])
        for g, w in zip(got["masks"], whole["masks"]):
            assert torch.equal(g, w[rows])


# ---------------------------------------------------------------- the Trainers


TRAIN_KW = dict(patch_size=(32, 32, 16), batch_size=2, labeled_bs=1, labelnum=2,
                max_iterations=4, val_every=2, save_every=2, compute_dtype="float32")
CRASH_AT = 3  # killed at the 3rd dispatch: saved at 2, resumed at 3
DICE = {2: 0.3, 4: 0.4}
SCALAR_TOL, DRIFT_TOL = (1e-5, 1e-6), (1e-4, 1e-5)


class _Crash(Exception):
    """The in-process kill."""


def _jax_run(cfg, recorded, steps, crash):
    jt = jtrainer.Trainer(cfg)
    jt.validate = lambda: DICE[int(jt.state.step)]
    real = jt.train_step

    def step(state, batch, key, scalars):
        if crash and len(steps) == CRASH_AT - 1:
            raise _Crash
        n_relu, n_pool = len(recorded.relu), len(recorded.pool)
        new_state, m = real(state, batch, key, scalars)
        jax.effects_barrier()
        steps.append(dict(key=_words(key), vec=np.array(m["scalars"]),
                          relu=(n_relu, len(recorded.relu)), pool=(n_pool, len(recorded.pool)),
                          fg=np.unpackbits(np.array(m["pred_fg_bits"]), axis=-1,
                                           bitorder="little")[..., :16].astype(bool)))
        return new_state, m

    jt.train_step = jt.train_step_light = step
    if crash:
        with pytest.raises(_Crash):
            jt.run()
        jcheckpoint.wait_until_finished()
    else:
        jt.run()
    return jt


def _port_run(cfg, recorded, jax_steps, crash):
    port = ttrainer.Trainer(cfg)
    port.validate = lambda: DICE[int(port.state.step)]
    real = port.train_step
    steps = []

    def step(state, batch, key, scalars):
        if crash and len(steps) == CRASH_AT - 1:
            raise _Crash
        rec = jax_steps[len(steps)]
        sides = KinkSides.given(recorded.relu[slice(*rec["relu"])],
                                recorded.pool[slice(*rec["pool"])], [],
                                [torch.from_numpy(rec["fg"])])
        with sides.share():
            vec, diag = real(state, batch, key, scalars)
        steps.append(dict(key=np.asarray(key), vec=vec.numpy().copy()))
        return vec, diag

    port.train_step = port.train_step_light = step
    if crash:
        with pytest.raises(_Crash):
            port.run()
    else:
        port.run()
    return port, steps


def test_trainers_agree_with_nothing_random_handed_across(tmp_path):
    root = str(tmp_path / "data")
    synthetic.make_pancreas(root, n_train=6, n_test=1, shape=(40, 40, 24), seed=1)
    jcfg = jconfig.make_config("pancreas", root_dir=root, snapshot_root=str(tmp_path / "jax"),
                               data_parallel=1, **TRAIN_KW)
    pcfg = tconfig.make_config("pancreas", root_dir=root, snapshot_root=str(tmp_path / "port"),
                               device="cpu", **TRAIN_KW)
    recorded = _JaxKinkSides()
    legs = []
    try:
        with contextlib.ExitStack() as stack:
            for patch in recorded.patches():
                stack.enter_context(patch)
            for resume, crash in (("", True), ("auto", False)):
                steps = []
                _jax_run(dataclasses.replace(jcfg, resume=resume), recorded, steps, crash)
                legs.append(steps)
        port_legs = []
        for (resume, crash), jax_steps in zip((("", True), ("auto", False)), legs):
            port, steps = _port_run(dataclasses.replace(pcfg, resume=resume), recorded,
                                    jax_steps, crash)
            port_legs.append(steps)
        assert [len(s) for s in legs] == [len(s) for s in port_legs] == [CRASH_AT - 1, 2]
        assert int(port.state.step) == 4 and port.best_performance == DICE[4]
        for leg, (jax_steps, port_steps) in enumerate(zip(legs, port_legs)):
            for i, (j, p) in enumerate(zip(jax_steps, port_steps)):
                np.testing.assert_array_equal(p["key"], j["key"])
                rtol, atol = SCALAR_TOL if (leg, i) == (0, 0) else DRIFT_TOL
                np.testing.assert_allclose(p["vec"], j["vec"], rtol=rtol, atol=atol,
                                           err_msg=f"leg {leg} step {i}")
    finally:  # full train states of ~70 MB a file
        shutil.rmtree(tmp_path / "jax", ignore_errors=True)
        shutil.rmtree(tmp_path / "port", ignore_errors=True)
