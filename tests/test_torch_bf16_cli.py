"""`--compute_dtype bfloat16` through the port's train CLI and its three test
CLIs against the JAX package's, on the CPU.

Trainer: the port's and the JAX Trainer with --compute_dtype bfloat16 on a
tiny Pancreas tree, 4 steps with validation replaced by the same Dice
values (tests/test_torch_vnet_cli.py's harness): the same snapshot path,
logged iterations, tags and checkpoints, student and teacher computing in
bfloat16 with float32 parameters, finite losses. Both draw the same
initial weights, noise and dropout from one seed (ops/threefry.py), but
without shared kink sides bf16 rounding splits their steps, so their step
values are held to JAX's by tests/test_torch_bf16_train.py, not here.

Test CLIs: a seeded full-width UNet3D checkpoint at the flag-derived path,
the port's test_pancreas, test_brats19 (sliding window) and test_isles22
(whole volume) with --compute_dtype bfloat16 on the CPU against the JAX
engines on the same weights with the JAX bfloat16 CLI's settings (compute
dtype bfloat16, the image rounded through float16). Tolerance rule
(tests/test_torch_bf16.py's, K = 2): max |port - JAX| <= K x max |JAX -
float64| for the score maps (sliding window) or the seg logits (whole
volume), float64 being the port's plain model in double on the same
float16-rounded image; and a label may differ only where JAX's score lies
within that max |port - JAX| of 0.5 (or its two logits within twice it of
each other).
"""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dycon_paper_replication_tpu import config as jconfig
from dycon_paper_replication_tpu.eval import SlidingWindowInference as JaxSW
from dycon_paper_replication_tpu.eval import evaluator as jeval
from dycon_paper_replication_tpu.models import net_factory_3d as jax_factory
from dycon_paper_replication_tpu.train import trainer as jtrainer
from dycon_paper_replication_tpu_torch import config as tconfig
from dycon_paper_replication_tpu_torch import weights
from dycon_paper_replication_tpu_torch.cli import test_brats19, test_isles22, test_pancreas
from dycon_paper_replication_tpu_torch.data import synthetic
from dycon_paper_replication_tpu_torch.data.datasets import brats_case_paths
from dycon_paper_replication_tpu_torch.eval import SlidingWindowInference, iter_volumes
from dycon_paper_replication_tpu_torch.eval import evaluator as teval
from dycon_paper_replication_tpu_torch.models import UNet3D, UNet3DConfig
from dycon_paper_replication_tpu_torch.train import trainer as ttrainer
from dycon_paper_replication_tpu_torch.utils import checkpoint
from test_torch_vnet_cli import _run

torch.set_num_threads(1)
K = 2.0
BF = torch.bfloat16


def test_bf16_host_loop_matches_jax_trainer(tmp_path, monkeypatch):
    root = str(tmp_path / "data")
    synthetic.make_pancreas(root, n_train=6, n_test=1, shape=(40, 40, 24), seed=1)
    kw = dict(root_dir=root, patch_size=(32, 32, 16), batch_size=2, labeled_bs=1, labelnum=2,
              max_iterations=4, val_every=2, save_every=3, compute_dtype="bfloat16")
    jax_trainer, jax_fired = _run(jtrainer, jconfig.make_config(
        "pancreas", snapshot_root=str(tmp_path / "jax"), **kw), monkeypatch)
    port, port_fired = _run(ttrainer, tconfig.make_config(
        "pancreas", snapshot_root=str(tmp_path / "port"), device="cpu", **kw), monkeypatch)
    assert jax_trainer.model.cfg.compute_dtype == jnp.bfloat16
    for net in (port.state.student, port.state.teacher):
        assert net.cfg.compute_dtype == BF and net.conv1.conv1.compute_dtype == BF
        assert all(p.dtype == torch.float32 for p in net.parameters())
    assert port.state.step == int(jax_trainer.state.step) == 4
    rel = port.snapshot_path.replace(str(tmp_path / "port"), "")
    assert rel == jax_trainer.snapshot_path.replace(str(tmp_path / "jax"), "")
    assert port_fired == jax_fired and jax_fired["validation"] == [2, 4]
    assert jax_fired["checkpoints"] == ["iter_2_dice_0.3", "iter_3", "iter_4_dice_0.5",
                                        "unet_3D_best_model"]
    for side in ("jax", "port"):  # their full train states, read (~550 MB)
        shutil.rmtree(tmp_path / side, ignore_errors=True)


@pytest.fixture(scope="module")
def unet_weights():
    return weights.init_jax_tree(UNet3DConfig(), seed=4)


def _save_unet(snapshot, params, state):
    net = UNet3D(UNet3DConfig())
    net.load_state_dict(weights.jax_tree_to_state_dict(params, state))
    checkpoint.save_checkpoint(checkpoint.best_checkpoint_path(snapshot, "unet_3D"), net)


def _reference(params, state, layout="NDHWC"):
    """The port's plain UNet3D in float64 with these weights."""
    net = UNet3D(UNet3DConfig(layout=layout, compute_dtype=torch.float64))
    net.load_state_dict(weights.jax_tree_to_state_dict(params, state))
    return net.double().eval()


def _jax_model(params, state):
    model = jax_factory("unet_3D", in_chns=1, class_num=2, scaler=2, compute_dtype=jnp.bfloat16)
    return model, jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, state)


def _tee(monkeypatch, cls, engines, preds):
    real = cls.map

    def tee(self, volumes, *args, **kwargs):
        engines.append(self)
        for item in real(self, volumes, *args, **kwargs):
            preds.append(item[0])
            yield item

    monkeypatch.setattr(cls, "map", tee)


@pytest.mark.parametrize("dataset", ["pancreas", "brats19"])
def test_sliding_window_clis_bf16_match_jax(tmp_path, monkeypatch, unet_weights, dataset):
    params, state = unet_weights
    root = tmp_path / "data"
    if dataset == "pancreas":
        _, names = synthetic.make_pancreas(str(root), n_train=0, n_test=1, shape=(40, 36, 32),
                                           seed=3)
        paths = [str(root / "Pancreas_data" / n) for n in names]
        main, argv = test_pancreas.main, ["--root_path", str(root)]
    else:
        names = synthetic.make_brats19(str(root), n_train=0, n_test=1, shape=(40, 36, 34),
                                       seed=3)["val"]
        paths = brats_case_paths(str(root), names)
        main, argv = test_brats19.main, ["--root_path", str(root)]
    snapshot = tconfig.make_config(dataset, snapshot_root=str(tmp_path / "runs")).snapshot_path()
    _save_unet(snapshot, params, state)
    engines, preds = [], []
    _tee(monkeypatch, SlidingWindowInference, engines, preds)
    avg = main(argv + ["--snapshot_root", str(tmp_path / "runs"), "--device", "cpu",
                       "--compute_dtype", "bfloat16", "--layout", "folded", "--patch_size", "32",
                       "32", "16", "--stride_xy", "16", "--stride_z", "8"])
    engine = engines[0]
    assert len(avg) == 4 and np.isfinite(avg).all() and len(preds) == 1
    assert engine.model.cfg.compute_dtype == BF and engine.transfer_dtype == np.float16
    model, jp, js = _jax_model(params, state)
    jsw = JaxSW(model, (32, 32, 16), 16, 8, patch_batch=2, transfer_dtype=np.float16)
    ref = SlidingWindowInference(_reference(params, state), (32, 32, 16), 16, 8,
                                 transfer_dtype=np.float16)
    image, _ = next(iter_volumes(paths))
    label, score = engine(image)
    jlabel, jscore = (np.asarray(a) for a in jsw(jp, js, image))
    _, score64 = ref(image)
    diff = np.abs(score - jscore).max()
    assert np.array_equal(label, preds[0]) and diff <= K * np.abs(jscore - score64).max()
    assert (np.abs(jscore - 0.5)[label != jlabel] <= diff).all()


def test_isles_cli_bf16_matches_jax(tmp_path, monkeypatch, unet_weights):
    params, state = unet_weights
    root = str(tmp_path / "ISLES22")
    _, (name,) = synthetic.make_isles22(root, n_train=0, n_val=1, shape=(36, 36, 20), seed=3)
    snapshot = tconfig.make_config("isles22", feature_scaler=2, snapshot_root=str(
        tmp_path / "runs")).snapshot_path()
    _save_unet(snapshot, params, state)
    engines, preds = [], []
    _tee(monkeypatch, teval.WholeVolumeInference, engines, preds)
    got = test_isles22.main(["--root_dir", root, "--snapshot_root", str(tmp_path / "runs"),
                             "--device", "cpu", "--feature_scaler", "2", "--compute_dtype",
                             "bfloat16", "--patch_size", "32", "32", "16"])
    engine = engines[0]
    assert len(got["cases"]) == len(preds) == 1
    assert engine.model.cfg.compute_dtype == BF and engine.transfer_dtype == np.float16
    image, _ = next(iter_volumes([f"{root}/{name}.h5"], label_key="mask"))
    model, jp, js = _jax_model(params, state)
    want = np.asarray(jeval.WholeVolumeInference(model, (32, 32, 16)).predict(jp, js, image))
    padded, sl = engine._pad(np.asarray(image, np.float16))
    x = torch.from_numpy(padded.astype(np.float32))[None, ..., None]
    with torch.no_grad():
        out = engine.model(x, with_projection=False)[1][0].numpy()
        out64 = _reference(params, state)(x.double(), with_projection=False)[1][0].numpy()
    jout = np.asarray(model.apply(jp, js, jnp.asarray(x.numpy()), with_projection=False)[0][1][0])
    diff = np.abs(out - jout).max()
    assert diff <= K * np.abs(jout - out64).max()
    gap = np.abs(jout[..., 1] - jout[..., 0])[sl]
    assert preds[0].shape == want.shape == image.shape
    assert (gap[preds[0] != want] <= 2 * diff).all()
