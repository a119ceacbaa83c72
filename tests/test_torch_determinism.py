"""`--deterministic 1` on the port, on the CPU: reruns are bit-identical, as
the JAX package promises (dycon_paper_replication_tpu/config.py) and
tests/test_train.py::TestDeterminism::test_same_seed_same_losses checks.

  * Two port Trainer runs of 2 steps from one seed give bit-identical
    logged scalars (every info/ and train/ one, the losses among them) and
    states (student, teacher, momentum, BatchNorm running stats), for the
    UNet3D, the VNet, the UNet3D with ASPP and the ISLES config (fused
    FeCL, whose plain twin runs on the CPU); the Trainer turns
    torch.use_deterministic_algorithms on.
  * Under the mode, ops/resize.py's one-axis resample (whose backward, on
    CUDA, the mode runs as a sorted index_put_) against jax.vjp of the JAX
    package's _axis_lerp, the forward within 1e-6 and the gradient within
    1e-6 x max|ref|, both align_corners modes, sizes 7 -> 14, 6 -> 12,
    1 -> 7 and 14 -> 7 on two axes; gradcheck in float64; the whole
    trilinear_resize at the projection head's shape.
  * ops/losses.py:pick_label, which picks each voxel's log-probability by a
    where over the classes (an elementwise backward, in place of gather's
    scatter_add_): the cross-entropy and focal losses bit-equal to their
    gather forms in value and gradient, and within 1e-6 of the JAX
    package's.

Sizes are small and torch runs one intra-op thread. A fixture restores the
deterministic mode and the cuDNN flags after each test, since the Trainer
sets them process-wide.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dycon_paper_replication_tpu.ops import losses as jlosses
from dycon_paper_replication_tpu.ops import resize as jresize
from dycon_paper_replication_tpu_torch import config as tconfig
from dycon_paper_replication_tpu_torch.data.synthetic import make_isles22, make_pancreas
from dycon_paper_replication_tpu_torch.ops import losses, resize
from dycon_paper_replication_tpu_torch.train.trainer import Trainer

SIZES = [(7, 14), (6, 12), (1, 7), (14, 7)]


@pytest.fixture(autouse=True)
def _one_thread_and_restored_mode():
    threads = torch.get_num_threads()
    mode = torch.are_deterministic_algorithms_enabled()
    warn = torch.is_deterministic_algorithms_warn_only_enabled()
    cudnn = torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    torch.use_deterministic_algorithms(mode, warn_only=warn)
    torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic = cudnn


def _pancreas_argv(root, runs, *extra):
    return ["--root_dir", str(root), "--snapshot_root", str(runs), "--device", "cpu",
            "--patch_size", "32", "32", "16", "--batch_size", "2", "--labeled_bs", "1",
            "--labelnum", "2", "--max_iterations", "2", "--val_every", "4", "--save_every", "100",
            *extra]


CONFIGS = {
    "unet_3D": ("pancreas", ()),
    "vnet": ("pancreas", ("--model", "vnet")),
    "aspp": ("pancreas", ("--use_aspp", "1")),
    "isles": ("isles22", ()),
}


def _run(dataset, root, runs, extra):
    if dataset == "isles22":
        argv = ["--root_dir", str(root), "--snapshot_root", str(runs), "--device", "cpu",
                "--patch_size", "16", "16", "16", "--batch_size", "2", "--labeled_bs", "1",
                "--labelnum", "18", "--max_iterations", "2", "--val_every", "4",
                "--save_every", "100", "--fecl_chunk", "24"]
    else:
        argv = _pancreas_argv(root, runs, *extra)
    trainer = Trainer(tconfig.config_from_args(dataset, argv))
    assert torch.are_deterministic_algorithms_enabled()
    trainer.run()
    assert trainer.state.step == 2
    state = {}
    for part, tensors in (("student", trainer.state.student.state_dict()),
                          ("teacher", trainer.state.teacher.state_dict()),
                          ("momentum", trainer.state.momentum)):
        state.update({f"{part}.{k}": v.detach().clone() for k, v in tensors.items()})
    with open(f"{trainer.snapshot_path}/metrics.jsonl") as f:
        logged = {(r["step"], r["tag"]): r["value"] for r in map(json.loads, f)
                  if r["tag"].startswith(("info/", "train/"))}
    return state, logged


@pytest.mark.parametrize("name", list(CONFIGS))
def test_same_seed_same_losses(tmp_path, name):
    """The port's counterpart of the JAX package's test_same_seed_same_losses,
    bit-identical in every logged scalar and every state tensor."""
    dataset, extra = CONFIGS[name]
    root = tmp_path / "data"
    if dataset == "isles22":
        make_isles22(str(root), n_train=24, n_val=2, shape=(20, 24, 18), seed=1, suffix=".npz")
    else:
        make_pancreas(str(root), n_train=4, n_test=1, shape=(40, 36, 24), seed=2, suffix=".npz")
    (state_a, logged_a), (state_b, logged_b) = (_run(dataset, root, tmp_path / f"runs{i}", extra)
                                                for i in range(2))
    assert sorted({step for step, tag in logged_a if tag == "info/loss"}) == [1, 2]
    assert all(np.isfinite(v) for v in logged_a.values())
    assert logged_a == logged_b
    assert state_a.keys() == state_b.keys()
    assert [k for k in state_a if not torch.equal(state_a[k], state_b[k])] == []
    # the step moved the state: the comparison is not of two initial states
    assert any(k.startswith("momentum.") and bool(state_a[k].abs().max() > 0) for k in state_a)


def _case(n_in, axis, seed):
    rng = np.random.default_rng(seed)
    shape = [2, 3, 4, 5, 3]
    shape[axis] = n_in
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("align_corners", [True, False])
@pytest.mark.parametrize("n_in,n_out", SIZES)
@pytest.mark.parametrize("axis", [1, 3])
def test_axis_lerp_with_the_mode_on_against_jax(axis, n_in, n_out, align_corners):
    x_np = _case(n_in, axis, 1)
    out_shape = list(x_np.shape)
    out_shape[axis] = n_out
    g_np = np.random.default_rng(2).standard_normal(out_shape).astype(np.float32)
    torch.use_deterministic_algorithms(True)
    x = torch.from_numpy(x_np).requires_grad_(True)
    y = resize._axis_lerp(x, axis, n_out, align_corners)
    got, = torch.autograd.grad(y, x, torch.from_numpy(g_np))
    want_y, vjp = jax.vjp(lambda t: jresize._axis_lerp(t, axis, n_out, align_corners),
                          jnp.asarray(x_np))
    want = np.asarray(vjp(jnp.asarray(g_np))[0])
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want_y), rtol=0, atol=1e-6)
    assert got.shape == want.shape
    assert np.abs(got.numpy() - want).max() <= 1e-6 * np.abs(want).max()


@pytest.mark.parametrize("align_corners", [True, False])
@pytest.mark.parametrize("n_in,n_out", SIZES)
def test_axis_lerp_gradcheck(n_in, n_out, align_corners):
    torch.use_deterministic_algorithms(True)
    x = torch.from_numpy(_case(n_in, 2, 3)).double().requires_grad_(True)
    assert torch.autograd.gradcheck(lambda t: resize._axis_lerp(t, 2, n_out, align_corners), (x,))


@pytest.mark.parametrize("align_corners", [True, False])
def test_trilinear_resize_against_jax(align_corners):
    """The projection head's resample, (B, 4, 4, 3, C) -> (8, 8, 6), and its
    vjp, against the JAX package's."""
    rng = np.random.default_rng(4)
    x_np = rng.standard_normal((2, 4, 4, 3, 8)).astype(np.float32)
    g_np = rng.standard_normal((2, 8, 8, 6, 8)).astype(np.float32)
    torch.use_deterministic_algorithms(True)
    x = torch.from_numpy(x_np).requires_grad_(True)
    y = resize.trilinear_resize(x, (8, 8, 6), align_corners=align_corners)
    got, = torch.autograd.grad(y, x, torch.from_numpy(g_np))
    want_y, vjp = jax.vjp(lambda t: jresize.trilinear_resize(t, (8, 8, 6),
                                                             align_corners=align_corners),
                          jnp.asarray(x_np))
    want = np.asarray(vjp(jnp.asarray(g_np))[0])
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want_y), rtol=0, atol=1e-6)
    assert np.abs(got.numpy() - want).max() <= 1e-6 * np.abs(want).max()


@pytest.mark.parametrize("loss", ["cross_entropy", "focal", "focal_alpha"])
@pytest.mark.parametrize("classes", [2, 4])
def test_pick_label_losses_are_their_gather_forms(loss, classes):
    rng = np.random.default_rng(5)
    logits_np = rng.standard_normal((2, 6, 5, 4, classes)).astype(np.float32) * 3.0
    labels_np = rng.integers(0, classes, (2, 6, 5, 4))
    alpha_np = rng.uniform(0.2, 1.0, classes).astype(np.float32)
    labels = torch.from_numpy(labels_np)
    alpha = torch.from_numpy(alpha_np) if loss == "focal_alpha" else None

    def gathered(logits):
        logp = torch.log_softmax(logits, dim=-1).gather(-1, labels[..., None])[..., 0]
        if loss == "cross_entropy":
            return -logp.mean()
        pt = logp.detach().exp()
        if alpha is not None:
            logp = logp * alpha[labels]
        return (-((1.0 - pt) ** 2.0) * logp).mean()

    def port(logits):
        if loss == "cross_entropy":
            return losses.cross_entropy_loss(logits, labels)
        return losses.focal_loss(logits, labels, alpha=alpha)

    torch.use_deterministic_algorithms(True)
    got_x = torch.from_numpy(logits_np).requires_grad_(True)
    want_x = torch.from_numpy(logits_np).requires_grad_(True)
    got, want = port(got_x), gathered(want_x)
    got.backward()
    want.backward()
    assert torch.equal(got, want) and torch.equal(got_x.grad, want_x.grad)
    if loss == "cross_entropy":
        ref = jlosses.cross_entropy_loss(jnp.asarray(logits_np), jnp.asarray(labels_np))
    else:
        ref = jlosses.focal_loss(jnp.asarray(logits_np), jnp.asarray(labels_np),
                                 alpha=None if alpha is None else jnp.asarray(alpha_np))
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-6, atol=0)
