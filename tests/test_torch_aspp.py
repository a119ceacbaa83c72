"""The port's ASPP (models/aspp.py) and the UNet3D with ASPP on its
bottleneck against the JAX package's, on the CPU in float32; the flags.

Inputs and weights come from numpy seeds (the JAX init of the UNet3D with
`use_aspp`, through the weight mapper, running stats moved off 0 / 1).
Tolerances: ASPP alone within 1e-5 x max|output| (a few float32 sums), its
running stats rtol 1e-5 + atol 1e-6; the UNet3D with ASPP within 1e-4 x
max|output| in eval mode and 1e-3 in train mode (the projection head's
BatchNorms and ASPP's take batch statistics over a 2 x 2 x 1 centre,
tests/test_torch_vnet.py says why), running stats rtol 1e-4 + atol 1e-5
(tests/test_torch_train_step.py's). At batch 1 the pooled branch skips its
BatchNorm, and its running stats stay as they were, in both packages. The
weight mapper must round-trip exactly, ASPP's running stats moving between
the JAX tree's aspp<i> and the port's aspp<i>.bn.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dycon_paper_replication_tpu.models.aspp import aspp3d_apply, aspp3d_init
from dycon_paper_replication_tpu.models.unet3d import UNet3DConfig as JaxConfig
from dycon_paper_replication_tpu.models.unet3d import init_unet3d, unet3d_apply
from dycon_paper_replication_tpu_torch import config as tconfig
from dycon_paper_replication_tpu_torch import weights
from dycon_paper_replication_tpu_torch.cli import test_pancreas
from dycon_paper_replication_tpu_torch.data.synthetic import make_pancreas
from dycon_paper_replication_tpu_torch.models import (
    ASPP3D,
    UNet3D,
    UNet3DConfig,
    net_factory_3d,
)
from dycon_paper_replication_tpu_torch.train.trainer import Trainer
from dycon_paper_replication_tpu_torch.utils import checkpoint

torch.set_num_threads(1)


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


def _close_rel(got, want, rel):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * float(np.abs(want).max()))


@pytest.fixture(scope="module")
def jax_unet():
    cfg = JaxConfig(feature_scale=16, use_aspp=True, dropout_rate=0.0)
    params, state = jax.jit(init_unet3d, static_argnums=1)(jax.random.key(5), cfg)
    return cfg, _np(params), jax.tree.map(lambda v: v + 0.25, _np(state))


def _aspp_module(params, state):
    """The port's ASPP3D loaded from a JAX (params, state) pair of ASPP."""
    mod = ASPP3D(8, 8)
    sd = weights.jax_tree_to_state_dict({"aspp": params}, {"aspp": state})
    mod.load_state_dict({k.removeprefix("aspp."): v for k, v in sd.items()})
    return mod


@pytest.mark.parametrize("batch", [2, 1])
@pytest.mark.parametrize("mode", ["eval", "train", "train_dropout"])
def test_aspp_matches_jax(batch, mode):
    """train_dropout: both packages draw the fused map's dropout mask from
    one key (the port JAX's streams, ops/threefry.py)."""
    params, state = _np(aspp3d_init(jax.random.key(2), 8, 8))
    state = jax.tree.map(lambda v: v + 0.25, state)
    x = np.random.default_rng(3).normal(size=(batch, 4, 3, 2, 8)).astype(np.float32)
    train = mode != "eval"
    rng = jax.random.key(0) if mode == "train_dropout" else None
    want, want_state = aspp3d_apply(params, state, jnp.asarray(x), train=train, rng=rng)
    mod = _aspp_module(params, state).train(train)
    key = None if rng is None else np.asarray(jax.random.key_data(rng))
    with torch.no_grad():
        got = mod(torch.from_numpy(x), key=key)
    _close_rel(got, want, 1e-5)
    _, got_state = weights.state_dict_to_jax_tree({f"aspp.{k}": v for k, v in
                                                   mod.state_dict().items()})
    for k, v in _flat(_np(want_state)).items():
        np.testing.assert_allclose(_flat(got_state["aspp"])[k], v, rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    # the pooled branch's BatchNorm: skipped at batch 1 (its stats unmoved)
    moved = not np.array_equal(_flat(got_state["aspp"])["pool_bn.mean"], state["pool_bn"]["mean"])
    assert moved == (train and batch > 1)


@pytest.mark.parametrize("layout", ["NDHWC", "folded"])
@pytest.mark.parametrize("train", [False, True])
def test_unet_with_aspp_matches_jax(jax_unet, layout, train):
    cfg, params, state = jax_unet
    jcfg = JaxConfig(feature_scale=16, use_aspp=True, dropout_rate=0.0, layout=layout)
    x = np.random.default_rng(6).normal(size=(2, 32, 32, 16, 1)).astype(np.float32)
    (jsdf, jseg, jfeat), jstate = jax.jit(
        lambda p, s, v: unet3d_apply(p, s, v, jcfg, train=train))(params, state, jnp.asarray(x))
    net = UNet3D(UNet3DConfig(feature_scale=16, use_aspp=True, dropout_rate=0.0, layout=layout))
    net.load_state_dict(weights.jax_tree_to_state_dict(params, state))
    net.train(train)
    with torch.no_grad():
        sdf, seg, feat = net(torch.from_numpy(x))
    rel = 1e-3 if train else 1e-4
    for got, want in ((sdf, jsdf), (seg, jseg), (feat, jfeat)):
        _close_rel(got, want, rel)
    _, got_state = weights.state_dict_to_jax_tree(net.state_dict())
    got_flat, want_flat = _flat(got_state), _flat(_np(jstate))
    assert got_flat.keys() == want_flat.keys()
    assert sum(k.startswith("aspp.") for k in want_flat) == 2 * 6
    for k, v in want_flat.items():
        np.testing.assert_allclose(got_flat[k], v, rtol=1e-4, atol=1e-5, err_msg=k)


def test_mapper_round_trip_and_init_layout(jax_unet):
    _, params, state = jax_unet
    sd = weights.jax_tree_to_state_dict(params, state)
    assert "aspp.aspp2.bn.mean" in sd and "aspp.pool_bn.var" in sd
    assert not any(k.startswith("aspp.") and k.endswith(".b") for k in sd)  # bias-free convs
    p2, s2 = weights.state_dict_to_jax_tree(sd)
    leaves = lambda t: jax.tree_util.tree_flatten_with_path(t)[0]  # noqa: E731
    assert len(leaves((params, state))) == len(leaves((p2, s2)))
    for (ka, a), (kb, b) in zip(leaves((params, state)), leaves((p2, s2))):
        assert ka == kb
        np.testing.assert_array_equal(a, b)
    net = UNet3D(UNet3DConfig(feature_scale=16, use_aspp=True))
    assert {k: tuple(v.shape) for k, v in net.state_dict().items()} == {
        k: tuple(v.shape) for k, v in sd.items()}
    ip, is_ = weights.init_jax_tree(UNet3DConfig(feature_scale=16, use_aspp=True), seed=0)
    shapes = lambda t: jax.tree.map(np.shape, t)  # noqa: E731
    assert shapes(ip) == shapes(params) and shapes(is_) == shapes(state)


def test_factory_and_flags():
    net = net_factory_3d("unet_3D", use_aspp=True, layout="folded", device="cpu")
    assert isinstance(net.aspp, ASPP3D) and net.cfg.use_aspp and not net.training
    assert not hasattr(net_factory_3d("unet_3D", device="cpu"), "aspp")
    cfg = tconfig.config_from_args("pancreas", ["--use_aspp", "1", "--model", "vnet"])
    assert cfg.use_aspp is True and cfg.model == "vnet"
    assert cfg.resolved_layout("cuda") == "folded" and cfg.resolved_layout("cpu") == "NDHWC"
    assert tconfig.config_from_args("brats19", []).use_aspp is False
    for bad in (["--use_aspp", "2"], ["--model", "unet_2D"]):
        with pytest.raises(SystemExit):
            tconfig.config_from_args("pancreas", bad)


def test_train_cli_with_aspp_saves_and_restores_its_state(tmp_path):
    """--use_aspp 1 on the CPU: 2 steps with finite losses, ASPP's
    parameters and running stats in the checkpoint, a resume restoring
    them exactly, and the test CLI reading the best model with --use_aspp 1. Patch 32x32x16: at 16^3 the centre is one voxel, which
    its InstanceNorm makes 0, and ASPP's convs (bias-free) keep it 0."""
    root = tmp_path / "Pancreas"
    make_pancreas(str(root), n_train=4, n_test=1, shape=(40, 36, 24), seed=2, suffix=".npz")
    argv = ["--root_dir", str(root), "--snapshot_root", str(tmp_path / "runs"), "--device", "cpu",
            "--patch_size", "32", "32", "16", "--batch_size", "2", "--labeled_bs", "1",
            "--labelnum", "2", "--max_iterations", "2", "--val_every", "2", "--save_every", "2",
            "--use_aspp", "1"]
    first = Trainer(tconfig.config_from_args("pancreas", argv))
    first.run()
    assert first.state.step == 2
    records = [json.loads(line) for line in open(f"{first.snapshot_path}/metrics.jsonl")]
    assert [r["step"] for r in records if r["tag"] == "info/loss"] == [1, 2]
    assert all(np.isfinite(r["value"]) for r in records)
    saved = checkpoint.iter_checkpoint_path(first.snapshot_path, 2)
    model = torch.load(saved, weights_only=True)["model"]
    assert {"aspp.fuse_bn.mean", "aspp.aspp4.bn.var", "aspp.aspp4.conv.w"} <= set(model)
    assert not torch.equal(model["aspp.fuse_bn.mean"], torch.full_like(model["aspp.fuse_bn.mean"],
                                                                       0.0))
    resumed = Trainer(tconfig.config_from_args("pancreas", argv + ["--resume", saved]))
    for a, b in ((first.state.student, resumed.state.student),
                 (first.state.teacher, resumed.state.teacher)):
        want, got = a.state_dict(), b.state_dict()
        assert want.keys() == got.keys() and all(torch.equal(got[k], want[k]) for k in want)
    # the test CLI reads the run's best model with --use_aspp 1
    avg = test_pancreas.main(["--root_path", str(root), "--snapshot_root", str(tmp_path / "runs"),
                              "--device", "cpu", "--use_aspp", "1", "--labelnum", "2",
                              "--max_iterations", "2", "--patch_size", "32", "32", "16",
                              "--stride_xy", "16", "--stride_z", "8"])
    assert len(avg) == 4 and np.isfinite(avg).all()
