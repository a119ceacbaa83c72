"""The port's trainer host loop against the JAX Trainer, on the CPU.

For Pancreas, BraTS-2019 and ISLES-2022 on tiny synthetic trees (patch
32x32x16, batch 2 of which 1 labeled), each package's Trainer is built from
the same config and run for 12 steps at val_every 4 and save_every 6, with
validation replaced on both sides by the same sequence of Dice values, so
that the best-model saves are decided alike and this file holds the host
loop alone (both draw JAX's initial weights, noise and dropout from one
seed, ops/threefry.py, and agree step by step only to float32 summation
order: tests/test_torch_jax_random.py holds their scalars).
Equal: iters_per_epoch, max_epoch, hd95_every, the snapshot path, the
checkpoint names (the port's carry ".pt"), the iterations on which
train-HD95, the similarity monitor, validation and the saves fire, and the
set of logged scalar tags. Within 1e-7 relative: beta and the FeCL focal
thresholds per epoch and the consistency weight for the first 400
iterations.
"""

import json
import os
import shutil

import jax  # noqa: F401  (the JAX Trainer's backend, on the CPU)
import numpy as np
import pytest
import torch

from dycon_paper_replication_tpu import config as jconfig
from dycon_paper_replication_tpu.train import trainer as jtrainer
from dycon_paper_replication_tpu_torch import config as tconfig
from dycon_paper_replication_tpu_torch.data import synthetic
from dycon_paper_replication_tpu_torch.train import trainer as ttrainer

torch.set_num_threads(1)
STEPS, VAL_EVERY, SAVE_EVERY = 12, 4, 6
DICE = [0.3, 0.2, 0.5]  # validation at 4, 8, 12: best saves at 4 and 12
TREES = {
    "pancreas": (lambda root: synthetic.make_pancreas(root, n_train=6, n_test=1,
                                                      shape=(40, 40, 24), seed=1), 2),
    "brats19": (lambda root: synthetic.make_brats19(root, n_train=6, n_test=1,
                                                    shape=(40, 36, 34), seed=1), 2),
    "isles22": (lambda root: synthetic.make_isles22(root, n_train=26, n_val=1,
                                                    shape=(36, 36, 20), seed=1), 18),
}


def _run(trainer_mod, cfg, monkeypatch):
    """Build and run one package's Trainer; returns it and what fired."""
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
    fired["validation"] = tags["info/Dice"]
    fired["checkpoints"] = sorted(
        n.removesuffix(".pt") for n in os.listdir(trainer.snapshot_path)
        if n.startswith("iter_") or n.endswith(("_best_model", "_best_model.pt")))
    return trainer, fired


@pytest.mark.parametrize("dataset", ["pancreas", "brats19", "isles22"])
def test_host_loop_matches_jax_trainer(tmp_path, monkeypatch, dataset):
    make_tree, labelnum = TREES[dataset]
    root = str(tmp_path / "data")
    make_tree(root)
    kw = dict(root_dir=root, patch_size=(32, 32, 16), batch_size=2, labeled_bs=1,
              labelnum=labelnum, max_iterations=STEPS, val_every=VAL_EVERY,
              save_every=SAVE_EVERY, fecl_chunk=64 if dataset == "isles22" else 0)
    jax_trainer, jax_fired = _run(jtrainer, jconfig.make_config(
        dataset, snapshot_root=str(tmp_path / "jax"), **kw), monkeypatch)
    port, port_fired = _run(ttrainer, tconfig.make_config(
        dataset, snapshot_root=str(tmp_path / "port"), device="cpu", **kw), monkeypatch)

    assert port.state.step == int(jax_trainer.state.step) == STEPS
    for attr in ("iters_per_epoch", "max_epoch", "hd95_every"):
        assert getattr(port, attr) == getattr(jax_trainer, attr), attr
    assert port.snapshot_path.replace(str(tmp_path / "port"), "") == \
        jax_trainer.snapshot_path.replace(str(tmp_path / "jax"), "")
    assert port_fired == jax_fired
    assert jax_fired["hd95"] == list(range(1, STEPS + 1))  # hd95_every 1 at val_every 4
    assert jax_fired["monitor"] == [] and jax_fired["validation"] == [4, 8, 12]
    assert jax_fired["checkpoints"] == ["iter_12", "iter_12_dice_0.5", "iter_4_dice_0.3",
                                        "iter_6", "unet_3D_best_model"]
    assert {"perf/step_ms_p50", "perf/host_rss_gb", "train/HD95"} <= jax_fired["tags"]

    for epoch in range(jax_trainer.max_epoch + 2):
        np.testing.assert_allclose(port._epoch_scalars(epoch), jax_trainer._epoch_scalars(epoch),
                                   rtol=1e-7, atol=0, err_msg=f"epoch {epoch}")
    got = [port._consistency_weight(i) for i in range(400)]
    want = [jax_trainer._consistency_weight(i) for i in range(400)]
    np.testing.assert_allclose(got, want, rtol=1e-7, atol=0)
    for side in ("jax", "port"):  # their full train states, read (~690 MB)
        shutil.rmtree(tmp_path / side, ignore_errors=True)


def test_port_diagnostics_cadence(monkeypatch):
    """The monitor's and HD95's iterations, which a 12-step run cannot reach
    for the monitor (every 200)."""
    trainer = ttrainer.Trainer.__new__(ttrainer.Trainer)
    trainer.cfg = tconfig.make_config("brats19", patch_size=(32, 32, 16), device="cpu")
    trainer.snapshot_path = "unused"
    monitored = []
    monkeypatch.setattr(ttrainer, "monitor_similarity_distributions",
                        lambda feat, mask, it, path: monitored.append(it))

    class Pool:
        def submit(self, fn, *args):
            return None

    diag = {"pred_fg": torch.zeros(1, 32, 32, 16, dtype=torch.uint8), "embedding": None,
            "mask_con": None}
    for hd95_every, last, want_hd95 in (
            (50, 500, [1, 50, 100, 150, 200, 250, 300, 350, 400, 450, 500]),
            (30, 240, [1, 30, 60, 90, 120, 150, 180, 210, 240])):
        trainer.hd95_every, trainer._hd95_pending = hd95_every, []
        monitored.clear()
        for i in range(1, last + 1):
            trainer._diagnostics(diag, None, i, Pool())
        assert [it for it, _ in trainer._hd95_pending] == want_hd95
        assert monitored == [200, 400][:last // 200]
