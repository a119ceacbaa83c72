"""The port's BraTS-2019 slice against the JAX package's, on the CPU.

  * data: the synthetic tree (the port's writer, .h5 and .npz, against the
    JAX writer), SagittalToAxial, the volume readers' axial view, and the
    BraTS2019 samples (crop + RandomRotFlip + ToArray) for 4 seeds each,
    windowed, full-read and through the small-volume pad: all exact;
  * the BraTS train CLI (2 steps, patch 32x32x16) then the test CLI with
    --axial 0 and --axial 1 on its checkpoint; then, on seeded weights
    saved at the same path, the test CLI's averages within atol 1e-6 of
    the JAX engine and test_all_case on the same weights (weights.py) and
    the same volumes, read in the same view, as tests/test_torch_cli.py
    holds the Pancreas test CLI (CLI_STORED: no view is padded);
  * the padded view: at STORED, whose axial view (20, 36, 40) the sliding
    window zero-pads up to the patch, the score maps of the port's engine
    (folded and plain) and of the JAX engine against the same sliding
    window in float64, in both views, and the test CLI's averages within
    atol 1e-6 of JAX's. The JAX engine is held to 2e-5 (2.6 times the
    port's largest float64 reading here, 7.6e-6) with its InstanceNorm
    statistics summed one axis at a time (a test-side stand-in for
    dycon_paper_replication_tpu/models/layers.py:instance_norm, the same
    formula), and to 5e-4 as it stands: XLA's CPU reduction sums each
    whole patch in float32, with an error that grows with the runs of
    equal values a zero pad makes. Its readings here are 2.8e-4 and 3.4e-4
    padded and 1.9e-5 and 1.6e-5 unpadded as it stands, and at most 5.9e-6
    with the stand-in; the port's are at most 7.6e-6 in both views.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dycon_paper_replication_tpu import data as jdata
from dycon_paper_replication_tpu.data import synthetic as jsynthetic
from dycon_paper_replication_tpu.eval import SlidingWindowInference as JaxSW
from dycon_paper_replication_tpu.eval import evaluator as jeval
from dycon_paper_replication_tpu.models import layers as jlayers
from dycon_paper_replication_tpu.models import net_factory_3d as jax_factory
from dycon_paper_replication_tpu_torch import config as tconfig
from dycon_paper_replication_tpu_torch import data as tdata
from dycon_paper_replication_tpu_torch import weights
from dycon_paper_replication_tpu_torch.cli import test_brats19, train_brats19
from dycon_paper_replication_tpu_torch.eval import SlidingWindowInference, iter_volumes
from dycon_paper_replication_tpu_torch.eval.sliding_window import compute_origins
from dycon_paper_replication_tpu_torch.models import UNet3D, UNet3DConfig, layers
from dycon_paper_replication_tpu_torch.utils import checkpoint

torch.set_num_threads(1)
STORED = (40, 36, 20)  # axial view (20, 36, 40)
CLI_STORED = (40, 36, 34)  # axial view (34, 36, 40), no pad at patch (32, 32, 16)
SEEDS = (0, 1, 2, 3)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """The same seed through the JAX writer (.h5) and the port's (.h5, .npz)."""
    root = tmp_path_factory.mktemp("brats")
    out = {"jax": str(root / "jax")}
    jsynthetic.make_brats19(out["jax"], n_train=4, n_test=2, shape=STORED, seed=5)
    for suffix in (".h5", ".npz"):
        out[suffix] = str(root / suffix[1:])
        tdata.make_brats19(out[suffix], n_train=4, n_test=2, shape=STORED, seed=5, suffix=suffix)
    return out


def test_synthetic_tree_matches_jax(trees):
    for suffix in (".h5", ".npz"):
        for split in ("train", "test", "val"):
            assert (open(os.path.join(trees[suffix], f"{split}.txt")).read()
                    == open(os.path.join(trees["jax"], f"{split}.txt")).read())
        names = [f"case_{i:03d}" for i in range(4)] + [f"case_t{i:03d}" for i in range(2)]
        want = iter_volumes([os.path.join(trees["jax"], "data", n + ".h5") for n in names])
        got = iter_volumes([os.path.join(trees[suffix], "data", n + suffix) for n in names])
        for (wi, wl), (gi, gl) in zip(want, got):
            np.testing.assert_array_equal(gi, wi)
            np.testing.assert_array_equal(gl, wl)
            assert gi.dtype == wi.dtype == np.float32 and gi.shape == STORED


def test_sagittal_to_axial_is_exact(rng):
    sample = {"image": rng.normal(size=(5, 4, 3)).astype(np.float32),
              "label": rng.integers(0, 2, size=(5, 4, 3)).astype(np.uint8)}
    want = jdata.transforms.SagittalToAxial()(dict(sample), rng)
    got = tdata.SagittalToAxial()(dict(sample), rng)
    for k in ("image", "label"):
        np.testing.assert_array_equal(got[k], want[k])
        assert got[k].shape == (3, 4, 5)
    bad = {"image": sample["image"], "label": sample["label"][:4]}
    for t in (jdata.transforms.SagittalToAxial(), tdata.SagittalToAxial()):
        with pytest.raises(ValueError):
            t(bad, rng)


@pytest.mark.parametrize("axial", [False, True])
def test_iter_volumes_matches_jax(trees, axial):
    names = ["case_t000", "case_t001"]
    want = list(jeval.iter_h5_volumes(
        [os.path.join(trees["jax"], "data", n + ".h5") for n in names], axial_transpose=axial))
    for suffix in (".h5", ".npz"):
        got = list(iter_volumes([os.path.join(trees[suffix], "data", n + suffix) for n in names],
                                axial_transpose=axial))
        assert len(got) == len(want) == 2
        for (gi, gl), (wi, wl) in zip(got, want):
            np.testing.assert_array_equal(gi, wi)
            np.testing.assert_array_equal(gl, wl)
            assert gl.dtype == wl.dtype == np.uint8
            assert gi.shape == (STORED[::-1] if axial else STORED)


# the axial view is (20, 36, 40): windowed, the pad-with-margin path (20 <=
# 24), and the whole volume
@pytest.mark.parametrize("crop", [(16, 32, 16), (24, 16, 32), None])
@pytest.mark.parametrize("suffix", [".h5", ".npz"])
def test_dataset_samples_match_jax(trees, suffix, crop):
    def ds(pkg, root):
        transform = pkg.Compose([pkg.RandomRotFlip(), pkg.ToArray()])
        return pkg.BraTS2019(root, split="train", transform=transform, crop_size=crop)

    want_ds, got_ds = ds(jdata, trees["jax"]), ds(tdata, trees[suffix])
    assert len(got_ds) == len(want_ds) == 4
    assert all(p.endswith(suffix) for p in got_ds.paths)
    assert got_ds.shape(0) == want_ds.shape(0) == STORED[::-1]
    for i, seed in enumerate(SEEDS):
        want = want_ds.get(i, np.random.default_rng(seed))
        got = got_ds.get(i, np.random.default_rng(seed))
        for k in ("image", "label"):
            np.testing.assert_array_equal(got[k], want[k])
            assert got[k].dtype == want[k].dtype
        if crop is not None:  # RandomRotFlip may swap the first two axes
            assert sorted(got["label"].shape) == sorted(crop)
    # the test split, read whole in the axial view
    want = jdata.BraTS2019(trees["jax"], split="test").get(1, np.random.default_rng(0))
    got = tdata.BraTS2019(trees[suffix], split="test").get(1, np.random.default_rng(0))
    for k in ("image", "label"):
        np.testing.assert_array_equal(got[k], want[k])


def test_brats_train_and_test_clis_on_cpu(tmp_path, capsys):
    """Train 2 steps, then test the trained checkpoint in both views; then
    the test CLI's averages against the JAX evaluator on seeded weights (as
    tests/test_torch_cli.py: two steps leave most scores within 1e-4 of the
    threshold, where float32 summation order flips voxels)."""
    root, runs = tmp_path / "BraTS", tmp_path / "runs"
    tdata.make_brats19(str(root), n_train=4, n_test=2, shape=CLI_STORED, seed=3, suffix=".h5")
    flags = ["--snapshot_root", str(runs), "--device", "cpu", "--patch_size", "32", "32", "16",
             "--labelnum", "2", "--max_iterations", "2"]
    best = train_brats19.main(["--root_dir", str(root), *flags, "--batch_size", "2",
                               "--labeled_bs", "1", "--val_every", "2", "--save_every", "2"])
    snap = tconfig.config_from_args("brats19", ["--root_dir", str(root), *flags]).snapshot_path()
    records = [json.loads(line) for line in open(f"{snap}/metrics.jsonl")]
    assert [r["step"] for r in records if r["tag"] == "info/loss"] == [1, 2]
    assert [r["step"] for r in records if r["tag"] == "train/HD95"] == [1, 2]
    assert [r["step"] for r in records if r["tag"] == "info/Dice"] == [2]
    assert all(np.isfinite(r["value"]) for r in records)
    best_path = checkpoint.best_checkpoint_path(snap, "unet_3D")
    assert best > 0 and os.path.isfile(best_path)
    test_flags = ["--root_path", str(root), *flags, "--stride_xy", "16", "--stride_z", "8"]
    for axial in (0, 1):
        avg = test_brats19.main([*test_flags, "--axial", str(axial)])
        out = capsys.readouterr().out
        assert f"init weight from {best_path}" in out and "FINAL AVERAGE METRICS:" in out
        assert len(avg) == 4 and np.isfinite(avg).all()

    params, state = weights.init_jax_tree(UNet3DConfig(), seed=0)
    net = UNet3D(UNet3DConfig())
    net.load_state_dict(weights.jax_tree_to_state_dict(params, state))
    checkpoint.save_checkpoint(best_path, net)
    model = jax_factory("unet_3D", in_chns=1, class_num=2, scaler=2)
    jp, js = jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, state)
    sw = JaxSW(model, (32, 32, 16), 16, 8, patch_batch=2)
    paths = [str(root / "data" / f"case_t{i:03d}.h5") for i in range(2)]
    for axial in (0, 1):
        avg = test_brats19.main([*test_flags, "--axial", str(axial)])
        want = jeval.test_all_case(sw, jp, js,
                                   jeval.iter_h5_volumes(paths, axial_transpose=bool(axial)),
                                   nms=True)
        np.testing.assert_allclose(avg, want, atol=1e-6, rtol=0)


def _instance_norm_f64(x, eps=1e-5):
    """The port's InstanceNorm without its float32 cast."""
    mean = x.mean(dim=(1, 2, 3), keepdim=True)
    var = (x - mean).square().mean(dim=(1, 2, 3), keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps)


def _jax_instance_norm_per_axis(x, eps=1e-5, channel_axis=-1):
    """JAX's instance_norm with each spatial sum taken one axis at a time,
    so that no float32 sum is longer than one axis."""
    ca = channel_axis % x.ndim
    spatial = [a for a in range(1, x.ndim) if a != ca]
    n = int(np.prod([x.shape[a] for a in spatial]))

    def total(v):  # the barrier keeps XLA from merging the sums into one
        for a in reversed(spatial):
            v = jax.lax.optimization_barrier(jnp.sum(v, axis=a, keepdims=True))
        return v

    xf = x.astype(jnp.float32)
    mean = total(xf) / n
    var = total(jnp.square(xf - mean)) / n
    return ((xf - mean) * jax.lax.rsqrt(var + eps)).astype(x.dtype)


def _scores_f64(net, image, patch, stride_xy, stride_z, monkeypatch):
    """The sliding window's score map in float64: `net` (plain layout) in
    double, the same centered pad, origins and overlap average."""
    pads = [max(p - s, 0) // 2 for s, p in zip(image.shape, patch)]
    padded = tuple(max(s, p) for s, p in zip(image.shape, patch))
    raw = tuple(slice(lo, lo + s) for lo, s in zip(pads, image.shape))
    vol, score, cnt = np.zeros(padded), np.zeros(padded), np.zeros(padded)
    vol[raw] = image
    with monkeypatch.context() as m, torch.no_grad():
        m.setattr(layers, "instance_norm", _instance_norm_f64)
        for origin in compute_origins(padded, patch, stride_xy, stride_z):
            sl = tuple(slice(o, o + p) for o, p in zip(origin, patch))
            _, logits, _ = net(torch.from_numpy(vol[sl])[None, ..., None], with_projection=False)
            score[sl] += torch.softmax(logits, -1)[0, ..., 1].numpy()
            cnt[sl] += 1
    return (score / cnt)[raw]


@pytest.mark.parametrize("axial", [0, 1])
def test_brats_test_cli_padded_view(trees, tmp_path, monkeypatch, capsys, axial):
    """At STORED the axial view (20, 36, 40) is zero-padded up to the patch
    (32, 32, 16) and the stored view is not (module doc)."""
    root, patch = trees[".h5"], (32, 32, 16)
    params, state = weights.init_jax_tree(UNet3DConfig(), seed=0)
    sd = weights.jax_tree_to_state_dict(params, state)
    flags = ["--snapshot_root", str(tmp_path / "runs"), "--device", "cpu", "--patch_size",
             "32", "32", "16", "--labelnum", "2", "--max_iterations", "2"]
    snap = tconfig.config_from_args("brats19", ["--root_dir", root, *flags]).snapshot_path()
    os.makedirs(snap)
    nets = {}
    for layout in ("folded", "NDHWC"):
        nets[layout] = UNet3D(UNet3DConfig(layout=layout))
        nets[layout].load_state_dict(sd)
        nets[layout].eval()
    checkpoint.save_checkpoint(checkpoint.best_checkpoint_path(snap, "unet_3D"), nets["folded"])
    net64 = UNet3D(UNet3DConfig()).double().eval()
    net64.load_state_dict(sd)

    jp, js = jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, state)
    paths = [os.path.join(root, "data", f"case_t{i:03d}.h5") for i in range(2)]
    volumes = list(iter_volumes(paths, axial_transpose=bool(axial)))
    want = [_scores_f64(net64, image.astype(np.float64), patch, 16, 8, monkeypatch)
            for image, _ in volumes]

    def jax_engine():
        return JaxSW(jax_factory("unet_3D", in_chns=1, class_num=2, scaler=2), patch, 16, 8,
                     patch_batch=2)

    def held(name, tol, engine):
        for (image, _), score64 in zip(volumes, want):
            assert image.shape == (STORED[::-1] if axial else STORED)
            score = np.asarray(engine(image)[1], np.float64)
            assert score.shape == image.shape
            err = np.abs(score - score64).max()
            assert err <= tol, f"{name}: {err}"

    as_it_stands = jax_engine()  # traced here, before the stand-in
    held("jax as it stands", 5e-4, lambda image: as_it_stands(jp, js, image))
    monkeypatch.setattr(jlayers, "instance_norm", _jax_instance_norm_per_axis)
    jax_sw = jax_engine()
    held("jax", 2e-5, lambda image: jax_sw(jp, js, image))
    for layout, net in nets.items():
        held(layout, 2e-5, SlidingWindowInference(net, patch, 16, 8, patch_batch=2))

    avg = test_brats19.main(["--root_path", root, *flags, "--stride_xy", "16", "--stride_z", "8",
                             "--axial", str(axial)])
    assert "FINAL AVERAGE METRICS:" in capsys.readouterr().out
    want = jeval.test_all_case(jax_sw, jp, js,
                               jeval.iter_h5_volumes(paths, axial_transpose=bool(axial)),
                               nms=True)
    np.testing.assert_allclose(avg, want, atol=1e-6, rtol=0)
