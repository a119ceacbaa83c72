"""Volume groups, pipelining and replicas of the port's evaluation engines,
on the CPU (one intra-op thread), against the JAX engines' `map(group=...)`
on the same mapped weights and against the port's own group-1 runs.

  * the sliding window's `map(group=2)` over 5 same-shape volumes (two
    groups and a one-volume tail; plain layout) and `map(group=4)` folded,
    against the JAX engine's map with the same group, at
    tests/test_torch_sliding_window.py's SCORE_ATOL (labels equal except
    within SCORE_ATOL of 0.5), and against the port's group-1 scores within
    1e-6 (here they are bit-identical);
  * a shape change flushes the group (results in input order);
  * the zero-weight tail keeps the average: patch batches that pad the
    origin list (5 and 7) against one that does not (2), within 1e-6 (a
    CPU forward of batch 1 rounds differently, by ~7e-6 here);
  * the staging buffers leak nothing across raw shapes (JAX
    tests/test_sliding_window.py's stale-margin regression): a small volume
    after a larger one equals a fresh engine's;
  * two replicas (`devices=[cpu, cpu]`) against one device within 1e-6;
    `device_resident_runner` equals `map`;
  * WholeVolumeInference groups (with a shape change) against JAX's groups
    (tests/test_evaluator.py's TestWholeVolumeGrouping) and the port's
    single predictions, and round-robin over two replicas;
  * `--group 2` in test_pancreas, test_brats19 and test_isles22 against
    `--group 1`: the same metrics and predictions.
"""

import jax
import numpy as np
import pytest
import torch

from dycon_paper_replication_tpu.eval.evaluator import WholeVolumeInference as JaxWV
from dycon_paper_replication_tpu.eval.sliding_window import SlidingWindowInference as JaxSW
from dycon_paper_replication_tpu.models.factory import Model
from dycon_paper_replication_tpu.models.unet3d import UNet3DConfig as JaxConfig
from dycon_paper_replication_tpu.models.unet3d import init_unet3d, unet3d_apply
from dycon_paper_replication_tpu.models.unet3d_folded import unet3d_seg_folded_io
from dycon_paper_replication_tpu_torch import config as tconfig
from dycon_paper_replication_tpu_torch import weights
from dycon_paper_replication_tpu_torch.cli import test_brats19, test_isles22, test_pancreas
from dycon_paper_replication_tpu_torch.data import synthetic
from dycon_paper_replication_tpu_torch.data.synthetic import _ellipsoid_volume
from dycon_paper_replication_tpu_torch.eval import (
    SlidingWindowInference,
    WholeVolumeInference,
    evaluator as teval,
)
from dycon_paper_replication_tpu_torch.models import UNet3D, UNet3DConfig
from dycon_paper_replication_tpu_torch.utils import checkpoint

torch.set_num_threads(1)
PATCH = (32, 32, 16)
STRIDES = (8, 8)
EVEN = (40, 36, 32)  # 12 origins, all even
SCORE_ATOL = 2.5e-5  # tests/test_torch_sliding_window.py's


@pytest.fixture(scope="module")
def tree():
    params, state = jax.jit(init_unet3d, static_argnums=1)(
        jax.random.key(7), JaxConfig(feature_scale=16))
    return jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, state)


def _jax_model(layout):
    cfg = JaxConfig(feature_scale=16, layout=layout)
    model = Model(cfg, init_unet3d, unet3d_apply)
    if layout == "folded":
        model.apply_seg_folded = lambda p, s, xf: unet3d_seg_folded_io(p, s, xf, cfg)
    return model


def _net(tree, layout):
    net = UNet3D(UNet3DConfig(feature_scale=16, layout=layout)).eval()
    net.load_state_dict(weights.jax_tree_to_state_dict(*tree))
    return net


def _volumes(n, shape=EVEN, seed=11):
    rng = np.random.default_rng(seed)
    return [_ellipsoid_volume(rng, shape)[0] for _ in range(n)]


def _assert_maps(got, want, atol):
    """Scores within atol; labels equal except within atol of 0.5."""
    (label_g, score_g), (label_w, score_w) = got, want
    np.testing.assert_allclose(score_g, score_w, atol=atol, rtol=0)
    sure = np.abs(np.asarray(score_w, np.float64) - 0.5) > atol
    np.testing.assert_array_equal(np.asarray(label_g)[sure], np.asarray(label_w)[sure])


@pytest.mark.parametrize("layout,group,n", [("NDHWC", 2, 5), ("folded", 4, 4)])
def test_groups_match_jax_and_group_one(tree, layout, group, n):
    vols = _volumes(n)
    sw = SlidingWindowInference(_net(tree, layout), PATCH, *STRIDES, patch_batch=3)
    got = list(sw.map(((v, i) for i, v in enumerate(vols)), return_score=True, group=group))
    assert [g[2] for g in got] == list(range(n))
    singles = [sw(v) for v in vols]
    jsw = JaxSW(_jax_model(layout), PATCH, *STRIDES, patch_batch=3)
    want = list(jsw.map(*tree, iter(vols), return_score=True, group=group))
    assert any(k[4] == group for k in jsw._compiled)
    for g, s, w in zip(got, singles, want):
        _assert_maps(g[:2], s, 1e-6)
        _assert_maps(g[:2], w[:2], SCORE_ATOL)


def test_shape_change_flushes_group(tree):
    vols = _volumes(1) + _volumes(2, shape=(36, 36, 32), seed=12)
    sw = SlidingWindowInference(_net(tree, "folded"), PATCH, *STRIDES, patch_batch=2)
    dispatched = []
    real = sw._dispatch_many
    sw._dispatch_many = lambda images, *a: dispatched.append(len(images)) or real(images, *a)
    got = list(sw.map(vols, return_score=True, group=2))
    assert dispatched == [1, 2] and len(got) == 3
    for g, v in zip(got, vols):
        assert g[0].shape == v.shape
        _assert_maps(g[:2], sw(v), 1e-6)


def test_zero_weight_tail_keeps_the_average(tree):
    vols = _volumes(2, shape=(37, 34, 30))  # 12 origins, odd ones: the plain accumulator
    net = _net(tree, "folded")
    # 12 origins a volume: patch batch 2 pads nothing, 5 and 7 pad the tail
    want = [SlidingWindowInference(net, PATCH, *STRIDES, patch_batch=2)(v) for v in vols]
    for pb in (5, 7):
        sw = SlidingWindowInference(net, PATCH, *STRIDES, patch_batch=pb)
        for g, w in zip(sw.map(vols, return_score=True, group=2), want):
            _assert_maps(g[:2], w, 1e-6)


def test_no_stale_margin_across_shapes(tree):
    net = _net(tree, "NDHWC")
    sw = SlidingWindowInference(net, PATCH, *STRIDES, patch_batch=2)
    big = np.full((40, 40, 32), 50.0, np.float32)
    small = _volumes(2, shape=(33, 40, 32))
    list(sw.map([big, big], group=2))
    got = list(sw.map(small, return_score=True, group=2))
    fresh = SlidingWindowInference(net, PATCH, *STRIDES, patch_batch=2)
    for g, v in zip(got, small):
        _assert_maps(g[:2], fresh(v), 1e-6)


def test_replicas_and_resident_runner(tree):
    vols = _volumes(3)
    net = _net(tree, "folded")
    one = SlidingWindowInference(net, PATCH, *STRIDES, patch_batch=3)
    two = SlidingWindowInference(net, PATCH, *STRIDES, patch_batch=3, devices=["cpu", "cpu"])
    want = list(one.map(vols, return_score=True, group=2))
    got = list(two.map(vols, return_score=True, group=2))
    for g, w in zip(got, want):
        _assert_maps(g[:2], w[:2], 1e-6)
    assert len(two.replicas()) == 2 and two.replicas()[0] is net
    label, score = one.device_resident_runner(vols[:2])()
    for i in range(2):
        _assert_maps((label[i].numpy(), score[i].numpy()), want[i][:2], 0.0)


def test_whole_volume_groups_match_jax(tree):
    params, state = tree
    net = _net(tree, "NDHWC")
    rng = np.random.default_rng(5)
    vols = [rng.normal(size=(16, 16, 16)).astype(np.float32) for _ in range(3)]
    vols.append(rng.normal(size=(16, 16, 32)).astype(np.float32))  # shape change
    labels = [np.zeros(v.shape, np.uint8) for v in vols]
    wv = WholeVolumeInference(net, (16, 16, 16))
    singles = [wv.predict(v) for v in vols]
    jwv = JaxWV(_jax_model("NDHWC"), (16, 16, 16))
    want = list(jwv.map(params, state, zip(vols, labels), group=2))
    for engine in (wv, WholeVolumeInference(net, (16, 16, 16), devices=["cpu", "cpu"])):
        got = list(engine.map(zip(vols, labels), group=2))
        assert len(got) == len(vols)
        for (g, _), s, (w, _) in zip(got, singles, want):
            np.testing.assert_array_equal(g, s)
            assert (g == np.asarray(w)).mean() >= 0.999


def _save_unet(snapshot):
    params, state = weights.init_jax_tree(UNet3DConfig(), seed=0)
    net = UNet3D(UNet3DConfig())
    net.load_state_dict(weights.jax_tree_to_state_dict(params, state))
    checkpoint.save_checkpoint(checkpoint.best_checkpoint_path(snapshot, "unet_3D"), net)


def _tee(monkeypatch, cls, preds):
    real = cls.map

    def tee(self, volumes, *args, **kwargs):
        for item in real(self, volumes, *args, **kwargs):
            preds.append(item[0])
            yield item

    monkeypatch.setattr(cls, "map", tee)


@pytest.mark.parametrize("cli", ["pancreas", "brats19", "isles22"])
def test_cli_group_two_matches_group_one(tmp_path, monkeypatch, cli):
    root, runs = str(tmp_path / "data"), str(tmp_path / "runs")
    if cli == "isles22":
        synthetic.make_isles22(root, n_train=0, n_val=3, shape=(36, 36, 20), seed=3)
        main, cls = test_isles22.main, WholeVolumeInference
        argv = ["--root_dir", root, "--patch_size", "32", "32", "16"]
        cfg = tconfig.make_config("isles22", snapshot_root=runs)
    else:
        if cli == "pancreas":
            synthetic.make_pancreas(root, n_train=0, n_test=3, shape=(32, 32, 16), seed=3)
            main = test_pancreas.main
        else:
            synthetic.make_brats19(root, n_train=0, n_test=3, shape=(32, 32, 16), seed=3)
            main = test_brats19.main
        cls = SlidingWindowInference
        argv = ["--root_path", root, "--patch_size", "32", "32", "16", "--stride_xy", "16",
                "--stride_z", "8"]
        cfg = tconfig.make_config(cli, snapshot_root=runs)
    _save_unet(cfg.snapshot_path())
    out = {}
    for group in (1, 2):
        preds = []
        _tee(monkeypatch, cls, preds)
        got = main(argv + ["--snapshot_root", runs, "--device", "cpu", "--group", str(group)])
        monkeypatch.undo()
        out[group] = (got, preds)
    (m1, p1), (m2, p2) = out[1], out[2]
    assert len(p1) == len(p2) == 3
    for a, b in zip(p1, p2):
        np.testing.assert_array_equal(a, b)
    if cli == "isles22":
        assert m1["cases"] == m2["cases"]
    else:
        np.testing.assert_allclose(m2, m1, atol=1e-6, rtol=0)
