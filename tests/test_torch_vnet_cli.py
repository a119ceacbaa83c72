"""`--model vnet` through the port's trainer and test CLIs against the JAX
package's, on the CPU.

Trainer: the port's and the JAX Trainer with --model vnet on a tiny
Pancreas tree, 8 steps with validation replaced by the same Dice values, as
tests/test_torch_trainer_loop.py does: the same snapshot path (VNET_...),
checkpoint names (vnet_best_model), logged iterations and tags.

Test CLIs: a seeded VNet checkpoint at the flag-derived path, the port's
test_pancreas, test_brats19 and test_isles22 with --model vnet on the CPU
against the JAX evaluator on the same weights and one small volume; the
sliding window takes its plain accumulator for the VNet.
"""

import json
import os

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
from dycon_paper_replication_tpu_torch.cli import (
    test_brats19,
    test_isles22,
    test_pancreas,
    train_brats19,
    train_isles22,
)
from dycon_paper_replication_tpu_torch.data import ISLESDataset, synthetic
from dycon_paper_replication_tpu_torch.data.datasets import brats_case_paths
from dycon_paper_replication_tpu_torch.eval import SlidingWindowInference, iter_volumes
from dycon_paper_replication_tpu_torch.eval import evaluator as teval
from dycon_paper_replication_tpu_torch.models import VNet, VNetConfig
from dycon_paper_replication_tpu_torch.train import trainer as ttrainer
from dycon_paper_replication_tpu_torch.utils import checkpoint

torch.set_num_threads(1)

STEPS, VAL_EVERY, SAVE_EVERY = 8, 4, 6
DICE = [0.3, 0.5]  # validation at 4 and 8: best saves at both


def _run(trainer_mod, cfg, monkeypatch):
    """Build and run one package's Trainer; returns it and what fired (as
    tests/test_torch_trainer_loop.py)."""
    fired = {"monitor": []}
    monkeypatch.setattr(trainer_mod, "monitor_similarity_distributions",
                        lambda feat, mask, it, path: fired["monitor"].append(it))
    trainer = trainer_mod.Trainer(cfg)
    dice = iter(DICE)
    trainer.validate = lambda: next(dice)
    trainer.run()
    tags = {}
    with open(os.path.join(trainer.snapshot_path, "metrics.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            tags.setdefault(rec["tag"], []).append(rec["step"])
    fired["tags"] = set(tags)
    fired["hd95"] = tags.get("train/HD95", [])
    fired["losses"] = tags["info/loss"]
    fired["validation"] = tags["info/Dice"]
    fired["checkpoints"] = sorted(
        n.removesuffix(".pt") for n in os.listdir(trainer.snapshot_path)
        if n.startswith("iter_") or n.endswith(("_best_model", "_best_model.pt")))
    return trainer, fired


def test_vnet_host_loop_matches_jax_trainer(tmp_path, monkeypatch):
    root = str(tmp_path / "data")
    synthetic.make_pancreas(root, n_train=6, n_test=1, shape=(40, 40, 24), seed=1)
    kw = dict(root_dir=root, patch_size=(32, 32, 16), batch_size=2, labeled_bs=1, labelnum=2,
              max_iterations=STEPS, val_every=VAL_EVERY, save_every=SAVE_EVERY, model="vnet")
    jax_trainer, jax_fired = _run(jtrainer, jconfig.make_config(
        "pancreas", snapshot_root=str(tmp_path / "jax"), **kw), monkeypatch)
    port, port_fired = _run(ttrainer, tconfig.make_config(
        "pancreas", snapshot_root=str(tmp_path / "port"), device="cpu", **kw), monkeypatch)
    assert isinstance(port.state.student, VNet) and isinstance(port.state.teacher, VNet)
    assert port.state.step == int(jax_trainer.state.step) == STEPS
    rel = port.snapshot_path.replace(str(tmp_path / "port"), "")
    assert rel == jax_trainer.snapshot_path.replace(str(tmp_path / "jax"), "")
    assert "/VNET_2labels_" in rel
    assert port_fired == jax_fired
    assert jax_fired["losses"] == list(range(1, STEPS + 1)) and jax_fired["validation"] == [4, 8]
    assert jax_fired["checkpoints"] == ["iter_4_dice_0.3", "iter_6", "iter_8_dice_0.5",
                                        "vnet_best_model"]
    meta = checkpoint.restore_checkpoint(
        checkpoint.best_checkpoint_path(port.snapshot_path, "vnet"), VNet(VNetConfig()))
    assert meta["step"] == 8 and meta["best_dice"] == 0.5


# --- the test CLIs ---------------------------------------------------------

@pytest.fixture(scope="module")
def vnet_weights():
    return weights.init_jax_tree(VNetConfig(), seed=4)


def _save_vnet(snapshot, params, state):
    net = VNet(VNetConfig())
    net.load_state_dict(weights.jax_tree_to_state_dict(params, state))
    checkpoint.save_checkpoint(checkpoint.best_checkpoint_path(snapshot, "vnet"), net)


def _jax_sw_model(params, state):
    model = jax_factory("vnet", in_chns=1, class_num=2, scaler=2)
    return model, jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, state)


@pytest.mark.parametrize("dataset", ["pancreas", "brats19"])
def test_sliding_window_clis_with_vnet_match_jax(tmp_path, monkeypatch, vnet_weights, dataset):
    """test_pancreas / test_brats19 --model vnet: the averages of the JAX
    engine and evaluator on the same weights and volume, within 1e-6, and every
    patch through the VNet's forward (the plain accumulator)."""
    params, state = vnet_weights
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
    snapshot = tconfig.make_config(dataset, model="vnet",
                                   snapshot_root=str(tmp_path / "runs")).snapshot_path()
    _save_vnet(snapshot, params, state)
    folded_calls = []
    real = SlidingWindowInference._accum_folded
    monkeypatch.setattr(SlidingWindowInference, "_accum_folded",
                        lambda self, *a: folded_calls.append(1) or real(self, *a))
    avg = main(argv + ["--snapshot_root", str(tmp_path / "runs"), "--device", "cpu", "--model",
                       "vnet", "--layout", "folded", "--patch_size", "32", "32", "16",
                       "--stride_xy", "16", "--stride_z", "8"])
    assert folded_calls == [] and len(avg) == 4 and np.isfinite(avg).all()
    model, jp, js = _jax_sw_model(params, state)
    sw = JaxSW(model, (32, 32, 16), 16, 8, patch_batch=2)
    want = jeval.test_all_case(sw, jp, js, iter_volumes(paths), nms=True)
    np.testing.assert_allclose(avg, want, atol=1e-6, rtol=0)


def test_isles_cli_with_vnet_matches_jax(tmp_path, monkeypatch, vnet_weights):
    """test_isles22 --model vnet: one whole-volume forward per case, the
    seg head. Its labels against the JAX evaluator's on the same weights,
    as tests/test_torch_isles.py holds the UNet3D's: a label may differ only
    where the two classes' logits (JAX's) lie within twice the largest
    output difference of each other, and >= 99.9 % agree. The volume is
    float16-exact: the JAX engine sends it as float16."""
    params, state = vnet_weights
    root = str(tmp_path / "ISLES22")
    _, (name,) = synthetic.make_isles22(root, n_train=0, n_val=1, shape=(36, 36, 20), seed=3)
    image, label = next(iter_volumes([f"{root}/{name}.h5"], label_key="mask"))
    synthetic.write_case(f"{root}/{name}.h5", image.astype(np.float16).astype(np.float32),
                         label.astype(np.float64), "mask")
    snapshot = tconfig.make_config("isles22", model="vnet", feature_scaler=2, snapshot_root=str(
        tmp_path / "runs")).snapshot_path()
    _save_vnet(snapshot, params, state)
    preds, engines = [], []
    real_map = teval.WholeVolumeInference.map

    def tee(self, volumes, group=1):
        engines.append(self)
        for pred, label in real_map(self, volumes, group):
            preds.append(pred)
            yield pred, label

    monkeypatch.setattr(teval.WholeVolumeInference, "map", tee)
    got = test_isles22.main(["--root_dir", root, "--snapshot_root", str(tmp_path / "runs"),
                             "--device", "cpu", "--model", "vnet", "--feature_scaler", "2",
                             "--patch_size", "32", "32", "16"])
    assert len(got["cases"]) == len(preds) == 1 and isinstance(engines[0].model, VNet)
    assert all(np.isfinite(got[k]) for k in ("dice", "hd95", "asd", "sensitivity", "specificity"))
    model, jp, js = _jax_sw_model(params, state)
    image, _ = next(iter_volumes(ISLESDataset(root, split="val").paths, label_key="mask"))
    want = np.asarray(jeval.WholeVolumeInference(model, (32, 32, 16)).predict(jp, js, image))
    padded, sl = engines[0]._pad(np.asarray(image, np.float32))
    with torch.no_grad():
        out = engines[0].model(torch.from_numpy(padded)[None, ..., None],
                               with_projection=False)[1][0].numpy()
    ref = np.asarray(model.apply(jp, js, jnp.asarray(padded)[None, ..., None],
                                 with_projection=False)[0][1][0])
    diff = np.abs(out - ref).max()
    assert diff <= 1e-4 * np.abs(ref).max()
    gap = np.abs(ref[..., 1] - ref[..., 0])[sl]
    assert preds[0].shape == want.shape == image.shape
    assert (gap[preds[0] != want] <= 2 * diff).all()
    assert (preds[0] == want).mean() >= 0.999


@pytest.mark.parametrize("dataset", ["brats19", "isles22"])
def test_train_clis_with_vnet_on_cpu(tmp_path, dataset):
    """The BraTS and ISLES train CLIs with --model vnet: 2 steps with finite
    losses, a validation, the VNet's run directory and best model."""
    root = str(tmp_path / "data")
    if dataset == "brats19":
        synthetic.make_brats19(root, n_train=4, n_test=1, shape=(40, 36, 34), seed=1,
                               suffix=".npz")
        flags, main = ["--labelnum", "2"], train_brats19.main
    else:
        synthetic.make_isles22(root, n_train=24, n_val=1, shape=(20, 24, 18), seed=1,
                               suffix=".npz")
        flags, main = ["--labelnum", "18", "--fecl_chunk", "24"], train_isles22.main
    argv = ["--root_dir", root, "--snapshot_root", str(tmp_path / "runs"), "--device", "cpu",
            "--model", "vnet", "--patch_size", "16", "16", "16", "--batch_size", "2",
            "--labeled_bs", "1", "--max_iterations", "2", "--val_every", "2", *flags]
    main(argv)
    (snap,) = (tmp_path / "runs").glob("*/*")
    assert snap.name.startswith("VNET_" if dataset == "brats19" else "DyCON_vnet_")
    assert (snap / "vnet_best_model.pt").exists()
    records = [json.loads(line) for line in open(snap / "metrics.jsonl")]
    assert [r["step"] for r in records if r["tag"] == "info/loss"] == [1, 2]
    assert [r["step"] for r in records if r["tag"] == "info/Dice"] == [2]
    assert all(np.isfinite(r["value"]) for r in records)
    meta = checkpoint.restore_checkpoint(str(next(snap.glob("iter_*.pt"))), VNet(VNetConfig(
        scale_factor=tconfig.make_config(dataset).feature_scaler)))
    assert meta["step"] == 2
