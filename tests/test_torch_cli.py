"""The port's Pancreas test CLI, end to end on the CPU: a synthetic .h5 tree
written under tmp_path, a full-width checkpoint saved by the port's
checkpoint module at the flag-derived snapshot path, and the metric table
printed. The same weights through the JAX CLI's engine and driver must give
the same averages."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from dycon_paper_replication_tpu.eval import SlidingWindowInference as JaxSW
from dycon_paper_replication_tpu.eval import evaluator as jeval
from dycon_paper_replication_tpu.models import net_factory_3d as jax_factory
from dycon_paper_replication_tpu_torch import weights
from dycon_paper_replication_tpu_torch.cli import test_pancreas
from dycon_paper_replication_tpu_torch.config import make_config
from dycon_paper_replication_tpu_torch.data.synthetic import make_pancreas
from dycon_paper_replication_tpu_torch.eval import iter_h5_volumes
from dycon_paper_replication_tpu_torch.models import UNet3D, UNet3DConfig
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
