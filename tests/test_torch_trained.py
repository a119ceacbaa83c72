"""The port on weights that a JAX training run produced, on the CPU.

`trained/pancreas_unet3d_r05_best.pt` is the best checkpoint of the JAX
package's canonical Pancreas run (20k iterations, bf16 compute, the
UNet3D at feature_scale 4, 2 classes), `unet_3D_best_model` of
`bench_results/r05_ckpt_latest.tar.gz`, converted by
scripts/convert_jax_checkpoint.py. The tests, with their tolerances stated
before their first run:
  * the committed file loads strictly into the port's UNet3D (needs no
    JAX);
  * converting `unet_3D_best_model` out of the archive gives a state_dict
    bit-equal to the committed file's, and `iter_20000` a full train state
    whose every leaf is bit-equal to orbax's;
  * one 96^3 patch, the centre crop of the first volume of test1.list of
    the canonical tree (the port's make_pancreas(n_train=62, n_test=20,
    shape=(128, 128, 112), seed=1)), through JAX's UNet3D (float32, NDHWC)
    at the archive's weights and the port's plain and folded UNet3D at the
    committed file's: softmax probabilities within 1e-4, and the same label
    at every voxel whose JAX margin |p1 - p0| exceeds 2e-4;
  * a JAX Trainer run of 2 steps (patch 32x32x16, batch 4 of which 2
    labeled, full width: the trainer has no width flag) saves `iter_2`;
    converted, the port's Trainer resumes it bit-exactly at step 2, and one
    more step on each side (dropout 0, the same batch, noise and the
    trainer's scalars) agrees within tests/test_torch_train_step.py's
    tolerances. The port's step takes the JAX step's side at its kinks
    within train/device_check.py's margin (ReLUs and max pools recorded
    inside the jitted JAX step, as in tests/test_torch_vnet_train.py, and
    the foreground threshold p1 > 0.5 of the train Dice): the first run,
    without them, had one voxel at JAX p1 = 0.5 + 2.4e-7 on the other side
    of 0.5, and train_dice off by 3.2e-5 relative;
  * chip_smoke.py's copy of the TPU's per-volume scores equals
    bench_results/r05_canonical20k_test_eval.log's rows.
Every test that needs orbax (and so JAX) skips without it: the file
collects on a machine with torch alone.
"""

import contextlib
import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

from dycon_paper_replication_tpu_torch.models import UNet3D, UNet3DConfig, net_factory_3d

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAINED = os.path.join(REPO, "trained", "pancreas_unet3d_r05_best.pt")
ARCHIVE = os.path.join(REPO, "bench_results", "r05_ckpt_latest.tar.gz")
CANONICAL = dict(n_train=62, n_test=20, shape=(128, 128, 112), seed=1)
PROB_ATOL, MARGIN = 1e-4, 2e-4


def _converter():
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import convert_jax_checkpoint

    return convert_jax_checkpoint


def _trained_state_dict():
    return torch.load(TRAINED, map_location="cpu", weights_only=True)["model"]


@pytest.fixture(scope="module")
def archive_states(tmp_path_factory):
    """{member: (the JAX TrainState restored by orbax, the port's file)}."""
    pytest.importorskip("orbax.checkpoint")
    from dycon_paper_replication_tpu_torch.config import make_config

    conv = _converter()
    cfg = make_config("pancreas", device="cpu")
    tmp = tmp_path_factory.mktemp("archive")
    out = {}
    for member in ("unet_3D_best_model", "iter_20000"):
        js = conv.restore_jax(conv.extract(ARCHIVE, member, str(tmp)), cfg)
        out[member] = (js, conv.save_port(js, member, cfg, str(tmp / f"{member}.pt")))
    return out


def test_trained_checkpoint_loads_strictly():
    ckpt = torch.load(TRAINED, map_location="cpu", weights_only=True)
    assert ckpt["meta"]["member"] == "unet_3D_best_model" and ckpt["meta"]["step"] == 16800
    sd = ckpt["model"]
    assert all(v.dtype == torch.float32 for v in sd.values())
    assert sum(v.numel() for v in sd.values()) == 6_150_068
    for layout in ("NDHWC", "folded"):
        net = UNet3D(UNet3DConfig(feature_scale=4, n_classes=2, layout=layout))
        net.load_state_dict(sd)  # strict
    # the test CLI's model (scaler = its --feature_scaler default)
    net_factory_3d("unet_3D", class_num=2, scaler=2, device="cpu").load_state_dict(sd)


def test_best_model_conversion_is_exact(archive_states):
    js, path = archive_states["unet_3D_best_model"]
    got = torch.load(path, map_location="cpu", weights_only=True)
    want = _trained_state_dict()
    assert got["model"].keys() == want.keys()
    for k, v in want.items():
        assert got["model"][k].dtype == v.dtype and torch.equal(got["model"][k], v), k
    assert got["meta"]["step"] == int(js.step) == 16800


def test_train_state_conversion_is_exact(archive_states):
    import jax

    from dycon_paper_replication_tpu_torch import weights
    from dycon_paper_replication_tpu_torch.train.state import create_train_state
    from dycon_paper_replication_tpu_torch.utils import checkpoint

    js, path = archive_states["iter_20000"]
    state = create_train_state(UNet3D(UNet3DConfig()))
    meta = checkpoint.restore_train_state(path, state)
    assert state.step == meta["step"] == 20000
    back = weights.torch_train_state_to_jax(state, js)
    assert jax.tree.structure(back) == jax.tree.structure(js)
    for got, want in zip(jax.tree.leaves(back), jax.tree.leaves(js)):
        assert np.asarray(got).dtype == np.asarray(want).dtype
        np.testing.assert_array_equal(got, want)


def test_trained_forward_matches_jax(archive_states, tmp_path):
    import jax
    import jax.numpy as jnp

    from dycon_paper_replication_tpu.models.unet3d import UNet3DConfig as JaxConfig
    from dycon_paper_replication_tpu.models.unet3d import unet3d_apply
    from dycon_paper_replication_tpu_torch.data.synthetic import make_pancreas

    root = str(tmp_path / "Pancreas")
    make_pancreas(root, **CANONICAL, suffix=".npz")
    with open(os.path.join(root, "test1.list")) as f:
        first = f.readline().strip()
    image = np.load(os.path.join(root, "Pancreas_data", first))["image"]
    assert image.shape == CANONICAL["shape"]
    lo = [(s - 96) // 2 for s in image.shape]
    x = np.ascontiguousarray(image[lo[0]:lo[0] + 96, lo[1]:lo[1] + 96,
                                   lo[2]:lo[2] + 96])[None, ..., None]

    js, _ = archive_states["unet_3D_best_model"]
    cfg = JaxConfig(layout="NDHWC")
    seg = jax.jit(lambda p, s, v: unet3d_apply(p, s, v, cfg, with_projection=False)[0][1])(
        js.params, js.model_state, jnp.asarray(x))
    want = np.asarray(jax.nn.softmax(seg, axis=-1))
    margin = np.abs(want[..., 1] - want[..., 0])
    outside = margin > MARGIN
    print(f"{first}: {int((~outside).sum())} of {margin.size} voxels within the JAX margin "
          f"{MARGIN}; JAX foreground {int((want.argmax(-1) == 1).sum())}")
    for layout in ("NDHWC", "folded"):
        net = UNet3D(UNet3DConfig(layout=layout)).eval()
        net.load_state_dict(_trained_state_dict())
        with torch.no_grad():
            got = torch.softmax(net(torch.from_numpy(x), with_projection=False)[1], -1).numpy()
        diff = float(np.abs(got - want).max())
        print(f"{layout}: max |p_port - p_jax| {diff}")
        assert diff <= PROB_ATOL, layout
        assert (got.argmax(-1) == want.argmax(-1))[outside].all(), layout


def test_jax_run_resumed_by_port(tmp_path):
    pytest.importorskip("orbax.checkpoint")
    import jax
    import jax.numpy as jnp

    from dycon_paper_replication_tpu import config as jconfig
    from dycon_paper_replication_tpu.models.factory import Model
    from dycon_paper_replication_tpu.models.unet3d import UNet3DConfig as JaxConfig
    from dycon_paper_replication_tpu.models.unet3d import init_unet3d, unet3d_apply
    from dycon_paper_replication_tpu.train import trainer as jtrainer
    from dycon_paper_replication_tpu.train.state import make_optimizer
    from dycon_paper_replication_tpu.train.step import StepScalars as JaxScalars
    from dycon_paper_replication_tpu.train.step import build_train_step as jax_build_train_step
    from dycon_paper_replication_tpu_torch import config as tconfig
    from dycon_paper_replication_tpu_torch import weights
    from dycon_paper_replication_tpu_torch.data import synthetic
    from dycon_paper_replication_tpu_torch.train import trainer as ttrainer
    from dycon_paper_replication_tpu_torch.train.device_check import KinkSides
    from dycon_paper_replication_tpu_torch.train.step import StepScalars
    from dycon_paper_replication_tpu_torch.utils import checkpoint
    from test_torch_train_step import B, LBS, PATCH, _batch, _compare_states, _noise
    from test_torch_vnet_train import _JaxKinkSides

    root = str(tmp_path / "data")
    synthetic.make_pancreas(root, n_train=6, n_test=1, shape=(40, 40, 24), seed=1)
    kw = dict(root_dir=root, patch_size=PATCH, batch_size=B, labeled_bs=LBS, labelnum=2,
              max_iterations=2, val_every=100, save_every=2)
    jt = jtrainer.Trainer(jconfig.make_config(
        "pancreas", snapshot_root=str(tmp_path / "jax"), step_diagnostics="always", **kw))
    jt.validate = lambda: 0.0
    jt.run()
    src = os.path.join(jt.snapshot_path, "iter_2")
    assert os.path.isdir(src)

    conv = _converter()
    cfg = tconfig.make_config("pancreas", snapshot_root=str(tmp_path / "port"), device="cpu",
                              layout="folded", **kw)
    path = conv.convert(src, cfg)
    assert path == checkpoint.iter_checkpoint_path(cfg.snapshot_path(), 2)
    js2 = conv.restore_jax(src, cfg)

    port = ttrainer.Trainer(dataclasses.replace(cfg, max_iterations=3, resume=path))
    assert port.state.step == 2
    for got, want in zip(jax.tree.leaves(weights.torch_train_state_to_jax(port.state, js2)),
                         jax.tree.leaves(js2)):
        np.testing.assert_array_equal(got, want)

    # one more step on each side: dropout off, the same batch and noise, and
    # the port trainer's scalars at iteration 2 (equal to the JAX trainer's:
    # tests/test_torch_trainer_loop.py)
    for net in (port.state.student, port.state.teacher):
        net.cfg = dataclasses.replace(net.cfg, dropout_rate=0.0)
    beta, pos_th, neg_th = port._epoch_scalars(2 // port.iters_per_epoch)
    scalars = (beta, port._consistency_weight(2), pos_th, neg_th)
    jcfg = jt.cfg
    optimizer = make_optimizer(lambda step: jcfg.base_lr, jcfg.momentum, jcfg.weight_decay,
                               jcfg.grad_clip_norm)
    model = Model(JaxConfig(dropout_rate=0.0, layout="folded"), init_unet3d, unet3d_apply)
    step = jax.jit(jax_build_train_step(model, optimizer, jcfg))
    batch, key = _batch(3), jax.random.key(23)
    recorded = _JaxKinkSides()
    with contextlib.ExitStack() as stack:
        for patch in recorded.patches():
            stack.enter_context(patch)
        js3, metrics = step(js2, {k: jnp.asarray(v) for k, v in batch.items()}, key,
                            JaxScalars.make(*scalars))
        want = np.asarray(metrics["scalars"])
        jax.effects_barrier()
    fg = np.unpackbits(np.asarray(metrics["pred_fg_bits"]), axis=-1,
                       bitorder="little")[..., :PATCH[2]].astype(bool)
    sides = KinkSides.given(recorded.relu, recorded.pool, [], [torch.from_numpy(fg)])
    with sides.share():
        got, _ = port.train_step(port.state, {k: torch.from_numpy(v) for k, v in batch.items()},
                                 torch.Generator().manual_seed(0), StepScalars(*scalars),
                                 noise=torch.tensor(_noise(key, batch["image"].shape)))
    print(f"kink sides {sides.counts}")
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    assert port.state.step == int(js3.step) == 3
    _compare_states(port.state, [js3], js2, cfg.base_lr)


def test_smoke_holds_the_tpu_log():
    """chip_smoke.py's copy of the TPU's per-volume scores (the card does not
    get bench_results/) equals the log's rows."""
    sys.path.insert(0, REPO)
    import chip_smoke

    rows = []
    with open(os.path.join(REPO, "bench_results", "r05_canonical20k_test_eval.log")) as f:
        for line in f:
            cells = [c.strip() for c in line.split("|")]
            if len(cells) == 5 and cells[0].isdigit():
                assert int(cells[0]) == len(rows)
                rows.append(tuple(float(c) for c in cells[1:]))
    assert chip_smoke.TPU_LOG == rows and len(rows) == CANONICAL["n_test"]
    assert chip_smoke.CANONICAL_TREE == CANONICAL
    assert chip_smoke.TRAINED_CKPT == os.path.relpath(TRAINED, REPO)
