"""The port's Pancreas CLIs, end to end on the CPU.

Test CLI: a synthetic .h5 tree written under tmp_path, a full-width
checkpoint saved by the port's checkpoint module at the flag-derived
snapshot path, and the metric table printed. The same weights through the
JAX CLI's engine and driver must give the same averages.

Train CLI (`--device cpu`, full-width UNet3D at patch 16^3, a synthetic
.npz tree): 3 iterations with a validation and a full-state save, then
`--resume auto`, which must restore exactly the saved state; and a time
budget that stops cleanly after one step with a resumable checkpoint.

`--layout NCDHW` (the JAX parser's choice, an alias of the port's NDHWC
path): the test CLI's averages and one train step's state equal NDHWC's.
`--compute_dtype auto` resolves to bfloat16 on cuda and float32 on the CPU.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dycon_paper_replication_tpu.eval import SlidingWindowInference as JaxSW
from dycon_paper_replication_tpu.eval import evaluator as jeval
from dycon_paper_replication_tpu.models import net_factory_3d as jax_factory
from dycon_paper_replication_tpu_torch import weights
from dycon_paper_replication_tpu_torch.cli import test_isles22, test_pancreas, train_pancreas
from dycon_paper_replication_tpu_torch.config import config_from_args, make_config
from dycon_paper_replication_tpu_torch.data.synthetic import make_pancreas
from dycon_paper_replication_tpu_torch.eval import iter_h5_volumes
from dycon_paper_replication_tpu_torch.models import UNet3D, UNet3DConfig
from dycon_paper_replication_tpu_torch.train.trainer import Trainer
from dycon_paper_replication_tpu_torch.utils import checkpoint

torch.set_num_threads(1)
FLAGS = ["--patch_size", "32", "32", "16", "--stride_xy", "16", "--stride_z", "8"]


def test_cli_runs_on_cpu(tmp_path, capsys):
    root = tmp_path / "Pancreas"
    _, test_names = make_pancreas(str(root), n_train=0, n_test=2, shape=(40, 36, 32), seed=3)
    snapshot = make_config("pancreas", snapshot_root=str(tmp_path / "runs")).snapshot_path()
    params, state = weights.init_jax_tree(UNet3DConfig(), seed=0)
    net = UNet3D(UNet3DConfig())
    net.load_state_dict(weights.jax_tree_to_state_dict(params, state))
    checkpoint.save_checkpoint(checkpoint.best_checkpoint_path(snapshot, "unet_3D"), net)

    avg = test_pancreas.main(["--root_path", str(root), "--snapshot_root",
                              str(tmp_path / "runs"), "--device", "cpu", *FLAGS])
    out = capsys.readouterr().out
    assert "init weight from" in out and "FINAL AVERAGE METRICS:" in out
    assert out.count(" | ") >= 3 * 4  # header + one row per case
    assert len(avg) == 4 and np.isfinite(avg).all()
    assert (root / "test1.list").exists()

    # the JAX engine and driver on the same weights and volumes
    model = jax_factory("unet_3D", in_chns=1, class_num=2, scaler=2)
    jp = jax.tree.map(jnp.asarray, params)
    js = jax.tree.map(jnp.asarray, state)
    sw = JaxSW(model, (32, 32, 16), 16, 8, patch_batch=2)
    paths = [str(root / "Pancreas_data" / n) for n in test_names]
    want = jeval.test_all_case(sw, jp, js, iter_h5_volumes(paths), nms=True)
    np.testing.assert_allclose(avg, want, atol=1e-6, rtol=0)


def _train_argv(tmp_path, *extra):
    root = tmp_path / "Pancreas"
    if not root.exists():
        make_pancreas(str(root), n_train=4, n_test=1, shape=(24, 24, 20), seed=2, suffix=".npz")
    return ["--root_dir", str(root), "--snapshot_root", str(tmp_path / "runs"), "--device", "cpu",
            "--patch_size", "16", "16", "16", "--batch_size", "2", "--labeled_bs", "1",
            "--labelnum", "2", "--max_iterations", "3", "--val_every", "2", "--save_every", "3",
            *extra]


def _state_tensors(state):
    return {**{f"s.{k}": v for k, v in state.student.state_dict().items()},
            **{f"t.{k}": v for k, v in state.teacher.state_dict().items()},
            **{f"m.{k}": v for k, v in state.momentum.items()}}


def test_train_cli_runs_and_resumes_on_cpu(tmp_path):
    argv = _train_argv(tmp_path)
    first = Trainer(config_from_args("pancreas", argv))
    assert first.device == torch.device("cpu") and first.state.student.cfg.layout == "NDHWC"
    best = first.run()
    assert first.state.step == 3
    snap = first.snapshot_path
    assert (tmp_path / "runs").exists() and snap.startswith(str(tmp_path / "runs"))
    records = [json.loads(line) for line in open(f"{snap}/metrics.jsonl")]
    losses = [r for r in records if r["tag"] == "info/loss"]
    assert [r["step"] for r in losses] == [1, 2, 3]
    assert all(np.isfinite(r["value"]) for r in records)
    assert [r["step"] for r in records if r["tag"] == "info/Dice"] == [2]
    saved = checkpoint.iter_checkpoint_path(snap, 3)
    assert checkpoint.latest_checkpoint_path(snap, "unet_3D")[0] == saved

    resumed = Trainer(config_from_args("pancreas", argv + ["--resume", "auto"]))
    assert resumed.state.step == 3 and resumed.best_performance == best
    want, got = _state_tensors(first.state), _state_tensors(resumed.state)
    assert want.keys() == got.keys()
    assert all(torch.equal(got[k], want[k]) for k in want)
    # the CLI itself, resumed at its last step: no step runs, the best stays
    assert train_pancreas.main(argv + ["--resume", "auto"]) == best


def test_train_cli_time_budget_stops_resumably(tmp_path):
    argv = _train_argv(tmp_path, "--time_budget_s", "1e-9", "--max_iterations", "5")
    trainer = Trainer(config_from_args("pancreas", argv))
    trainer.run()
    assert trainer.state.step == 1
    path, _ = checkpoint.latest_checkpoint_path(trainer.snapshot_path, "unet_3D")
    assert path == checkpoint.iter_checkpoint_path(trainer.snapshot_path, 1)


@pytest.mark.parametrize("cli", ["test", "train"])
def test_layout_ncdhw_is_the_ndhwc_path(tmp_path, cli):
    """`--layout NCDHW`, the JAX parser's choice, is accepted as an alias of
    the NDHWC path: the same model layout and the same outputs."""
    assert test_isles22.build_parser().parse_args(["--layout", "NCDHW"]).layout == "NCDHW"
    runs = {}
    for layout in ("NDHWC", "NCDHW"):
        if cli == "test":
            root = tmp_path / "Pancreas"
            if not root.exists():
                make_pancreas(str(root), n_train=0, n_test=2, shape=(40, 36, 32), seed=3)
                snapshot = make_config("pancreas",
                                       snapshot_root=str(tmp_path / "runs")).snapshot_path()
                params, state = weights.init_jax_tree(UNet3DConfig(), seed=0)
                net = UNet3D(UNet3DConfig())
                net.load_state_dict(weights.jax_tree_to_state_dict(params, state))
                checkpoint.save_checkpoint(checkpoint.best_checkpoint_path(snapshot, "unet_3D"),
                                           net)
            args = test_pancreas.build_parser().parse_args(["--layout", layout, "--device", "cpu"])
            assert test_pancreas.resolve_perf_flags(args)[1] == "NDHWC"
            runs[layout] = test_pancreas.main(["--root_path", str(root), "--snapshot_root",
                                               str(tmp_path / "runs"), "--device", "cpu",
                                               "--layout", layout, *FLAGS])
        else:
            argv = _train_argv(tmp_path / layout, "--layout", layout, "--max_iterations", "1")
            trainer = Trainer(config_from_args("pancreas", argv))
            assert trainer.state.student.cfg.layout == "NDHWC"
            trainer.run()
            runs[layout] = _state_tensors(trainer.state)
    if cli == "test":
        assert runs["NCDHW"] == runs["NDHWC"]
    else:
        assert runs["NCDHW"].keys() == runs["NDHWC"].keys()
        assert all(torch.equal(runs["NCDHW"][k], v) for k, v in runs["NDHWC"].items())


def test_compute_dtype_auto_is_bf16_on_cuda_only():
    """`--compute_dtype auto` in the test CLIs: bfloat16 on cuda (the rule
    and its measurement: test_pancreas.resolve_perf_flags), float32 on the
    CPU; an explicit dtype stands."""
    for parser in (test_pancreas.build_parser(), test_isles22.build_parser()):
        for device, want in (("cuda", "bfloat16"), ("cpu", "float32")):
            args = parser.parse_args(["--device", device])
            assert test_pancreas.resolve_perf_flags(args)[0] == want
            args = parser.parse_args(["--device", device, "--compute_dtype", "float32"])
            assert test_pancreas.resolve_perf_flags(args)[0] == "float32"
