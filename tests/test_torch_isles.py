"""The port's ISLES-2022 slice against the JAX package's, on the CPU.

  * data: the synthetic tree (the port's writer, .h5 and .npz) and the
    ISLESDataset crops with RandomRotFlip + ToArray, bit-identical to the
    JAX dataset's for the same rng; missing cases listed;
  * whole-volume inference on odd volume shapes (the pad to the patch, then
    to a multiple of 16), heads "sdf" and "seg", the port's plain and
    folded UNet3D against the JAX engine with the same weights (weights.py):
    the head's outputs within 5e-3 x max|JAX's|, the label maps equal on
    >= 99.9 % of voxels and unequal only where the two classes' outputs lie
    within twice the measured difference (an argmax that float32 sums in
    another order can flip). The output tolerance is wider than
    test_torch_model.py's 1e-4 because the whole volume is zero-padded:
    on the random-init weights, flat zero regions drive channels whose
    InstanceNorm variance is far below its eps, which multiplies float32
    differences by up to ~300 (measured 1.2e-3 at 48x48x32 and 2.1e-3 at
    64x64x48 for the SDF head, 1.9e-4 and 4.2e-4 for the seg head; 1e-4 and
    below without padding). The difference is JAX's: against a float64
    forward the port's outputs lie within 3.1e-5 and are held to 1e-4
    there, JAX's lie 1.0e-3 to 3.1e-3 off (its whole-extent float32
    InstanceNorm sum over the pad's equal values). The image is rounded to
    float16 first, the JAX engine's host wire type, so both see one volume;
  * the whole-volume validation and test functions: the empty-mask rules
    and the soft Dice, equal to the JAX package's on the same predictions;
  * one ISLES train step (teacher in eval mode, n-class Dice, derived mask
    kernel, projection scale 4, fecl_chunk 96 > 0), port against JAX, for
    fecl_impl "fused" and "chunked", on tests/test_torch_train_step.py's
    first-step case (state key 11, batch 1, noise key 21) with its
    tolerances (its module doc), neg_thresh 0.05 so the FeCL cross term has
    pairs (train/device_check.py, SCALARS_ISLES). As in the card-against-
    CPU check, the port's step takes the JAX step's side at every ReLU, max
    pool and cross-threshold value within train/device_check.py's margin:
    without that, a JAX-against-port step flips kinks at other seeds (state
    key 13: 34x the tolerance at conv3.conv2.w, and 13.5x in the Pancreas
    config) and passes with it (0.79 and 0.54);
  * the ISLES train CLI then the test CLI on the CPU at a tiny patch.
"""

import json
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_brats import _instance_norm_f64
from test_torch_train_step import _batch, _compare_states, _noise, _np, _words

from dycon_paper_replication_tpu import config as jconfig
from dycon_paper_replication_tpu import data as jdata
from dycon_paper_replication_tpu.eval import evaluator as jeval
from dycon_paper_replication_tpu.models import net_factory_3d as jax_factory
from dycon_paper_replication_tpu.models.factory import Model
from dycon_paper_replication_tpu.models.unet3d import UNet3DConfig as JaxNetConfig
from dycon_paper_replication_tpu.models.unet3d import init_unet3d, unet3d_apply
from dycon_paper_replication_tpu.train.state import create_train_state, make_optimizer
from dycon_paper_replication_tpu.train.step import StepScalars as JaxScalars
from dycon_paper_replication_tpu.train.step import build_train_step as jax_build_train_step
from dycon_paper_replication_tpu_torch import config as tconfig
from dycon_paper_replication_tpu_torch import data as tdata
from dycon_paper_replication_tpu_torch import weights
from dycon_paper_replication_tpu_torch.cli import test_isles22, train_isles22
from dycon_paper_replication_tpu_torch.data import synthetic as tsynthetic
from dycon_paper_replication_tpu_torch.eval import evaluator as teval
from dycon_paper_replication_tpu_torch.models import UNet3D, UNet3DConfig
from dycon_paper_replication_tpu_torch.models import layers as tlayers
from dycon_paper_replication_tpu_torch.train.device_check import KinkSides
from dycon_paper_replication_tpu_torch.train.step import SCALAR_METRICS, StepScalars
from dycon_paper_replication_tpu_torch.train.step import build_train_step
from dycon_paper_replication_tpu_torch.train.trainer import ISLES_PATIENTS_TO_SLICES, Trainer

torch.set_num_threads(1)
PATCH = (32, 32, 16)
B, LBS = 4, 2


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("isles")
    out = {}
    for suffix in (".h5", ".npz"):
        path = str(root / suffix[1:])
        tsynthetic.make_isles22(path, n_train=4, n_val=2, shape=(36, 30, 20), seed=5,
                                suffix=suffix)
        out[suffix] = path
    return out


def test_synthetic_tree_matches_jax(tmp_path):
    from dycon_paper_replication_tpu.data import synthetic as jsynthetic

    jsynthetic.make_isles22(str(tmp_path / "j"), n_train=2, n_val=1, shape=(12, 10, 8), seed=3)
    tsynthetic.make_isles22(str(tmp_path / "t"), n_train=2, n_val=1, shape=(12, 10, 8), seed=3,
                            suffix=".npz")
    for name in ("train.list", "val.list"):
        assert (tmp_path / "j" / name).read_text() == (tmp_path / "t" / name).read_text()
    j_ds = jdata.ISLESDataset(str(tmp_path / "j"), split="train")
    t_ds = tdata.ISLESDataset(str(tmp_path / "t"), split="train")
    assert [p.endswith(".npz") for p in t_ds.paths] == [True, True]
    for i in range(2):
        a, b = j_ds.get(i, np.random.default_rng(0)), t_ds.get(i, np.random.default_rng(0))
        for k in ("image", "label"):
            np.testing.assert_array_equal(b[k], a[k])
            assert b[k].dtype == a[k].dtype


@pytest.mark.parametrize("crop", [PATCH, (40, 24, 16)])  # windowed, and pad-with-margin
def test_dataset_crops_match_jax(trees, crop):
    def ds(pkg, root):
        transform = pkg.Compose([pkg.RandomRotFlip(), pkg.ToArray()])
        return pkg.ISLESDataset(root, split="train", transform=transform, crop_size=crop)

    want_ds = ds(jdata, trees[".h5"])
    for suffix in (".h5", ".npz"):
        got_ds = ds(tdata, trees[suffix])
        assert len(got_ds) == len(want_ds) == 4 and got_ds.missing == []
        for i in range(4):
            want = want_ds.get(i, np.random.default_rng(10 + i))
            got = got_ds.get(i, np.random.default_rng(10 + i))
            for k in ("image", "label"):
                np.testing.assert_array_equal(got[k], want[k])
                assert got[k].dtype == want[k].dtype


def test_dataset_lists_missing_cases(tmp_path):
    tsynthetic.make_isles22(str(tmp_path), n_train=3, n_val=1, shape=(8, 8, 8), suffix=".npz")
    (tmp_path / "sub-strokecase0001.npz").unlink()
    ds = tdata.ISLESDataset(str(tmp_path), split="train")
    assert len(ds) == 2 and ds.missing == [str(tmp_path / "sub-strokecase0001.h5")]
    with pytest.raises(FileNotFoundError):
        tdata.ISLESDataset(str(tmp_path), split="test")


@pytest.fixture(scope="module")
def net_weights():
    return weights.init_jax_tree(UNet3DConfig(scale_factor=4), seed=7)


@pytest.mark.parametrize("layout", ["NDHWC", "folded"])
@pytest.mark.parametrize("head", ["sdf", "seg"])
@pytest.mark.parametrize("shape", [(20, 37, 13), (33, 32, 17)])
def test_whole_volume_matches_jax(net_weights, layout, head, shape):
    params, state = net_weights
    jp, js = jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, state)
    rng = np.random.default_rng(sum(shape))
    image = rng.random(shape).astype(np.float16).astype(np.float32)
    model = jax_factory("unet_3D", in_chns=1, class_num=2, scaler=4)
    want = np.asarray(jeval.WholeVolumeInference(model, PATCH, head=head).predict(jp, js, image))
    net = UNet3D(UNet3DConfig(scale_factor=4, layout=layout)).eval()
    net.load_state_dict(weights.jax_tree_to_state_dict(params, state))
    wv = teval.WholeVolumeInference(net, PATCH, head=head)
    got = wv(image)
    assert got.shape == want.shape == shape and got.dtype == np.uint8
    # the head's outputs on the padded volume, port against JAX (module
    # doc), and every label that differs lies where that difference can
    # flip the argmax
    padded, sl = wv._pad(image)
    idx = 0 if head == "sdf" else 1
    with torch.no_grad():
        out = net(torch.from_numpy(padded)[None, ..., None], with_projection=False)[idx][0].numpy()
    ref = np.asarray(model.apply(jp, js, jnp.asarray(padded)[None, ..., None],
                                 with_projection=False)[0][idx][0])
    diff = np.abs(out - ref).max()
    assert diff <= 5e-3 * np.abs(ref).max()
    gap = np.abs(ref[..., 1] - ref[..., 0])[sl]
    assert (gap[got != want] <= 2 * diff).all()
    assert (got == want).mean() >= 0.999


def test_whole_volume_pad_rule():
    net = UNet3D(UNet3DConfig(scale_factor=4)).eval()
    wv = teval.WholeVolumeInference(net, (32, 32, 16))
    padded, sl = wv._pad(np.ones((20, 40, 13), np.float32))
    # 20 < 32: 7 + 7 -> 34 -> 48; 40: none -> 48; 13 < 16: 2 + 2 -> 17 -> 32
    assert padded.shape == (48, 48, 32)
    assert sl == (slice(7, 27), slice(0, 40), slice(2, 15))
    assert padded[sl].all() and padded.sum() == 20 * 40 * 13


class _Fixed:
    """A whole-volume engine that yields given predictions, with the `map`
    of both packages' engines."""

    def __init__(self, preds):
        self.preds = preds

    def map(self, *args, group=1):
        volumes = args[-1]
        for pred, (_, label) in zip(self.preds, volumes):
            yield pred, label


def _metric_cases():
    rng = np.random.default_rng(3)
    shape = (12, 10, 8)
    blob = np.zeros(shape, np.uint8)
    blob[3:8, 2:7, 2:6] = 1
    other = np.zeros(shape, np.uint8)
    other[4:9, 3:8, 1:5] = 1
    empty = np.zeros(shape, np.uint8)
    noisy = (rng.random(shape) < 0.1).astype(np.uint8)
    # (prediction, label): both empty; empty prediction; empty label; overlap; noise
    return [(empty, empty), (empty, blob), (blob, empty), (blob, other), (noisy, blob)]


def test_whole_volume_metrics_match_jax(tmp_path):
    cases = _metric_cases()
    preds = [p for p, _ in cases]
    volumes = [(np.zeros_like(lab, np.float32), lab) for _, lab in cases]
    want = jeval.test_all_case_wholevolume(_Fixed(preds), None, None, volumes,
                                           results_path=str(tmp_path / "j.txt"))
    got = teval.test_all_case_wholevolume(_Fixed(preds), volumes,
                                          results_path=str(tmp_path / "t.txt"))
    assert got.keys() == want.keys()
    for k in want:
        if k == "cases":
            for g, w in zip(got[k], want[k]):
                assert g.keys() == w.keys()
                np.testing.assert_allclose([g[m] for m in w], [w[m] for m in w], rtol=1e-12)
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-12)
    assert (tmp_path / "t.txt").read_text() == (tmp_path / "j.txt").read_text()
    # the rules themselves
    rows = got["cases"]
    assert rows[0] == dict(dice=1.0, hd95=0.0, asd=0.0, sensitivity=1.0, specificity=1.0)
    diag = float(np.linalg.norm((12, 10, 8)))
    assert rows[1] == dict(dice=0.0, hd95=diag, asd=diag, sensitivity=0.0, specificity=1.0)
    assert rows[2] == dict(dice=0.0, hd95=diag, asd=diag, sensitivity=0.0, specificity=0.0)
    np.testing.assert_allclose(
        teval.var_all_case_wholevolume(_Fixed(preds), volumes),
        jeval.var_all_case_wholevolume(_Fixed(preds), None, None, volumes), rtol=1e-12)
    # volume groups reach the engine's map (held against JAX's in
    # tests/test_torch_groups.py); the drivers' results do not change
    grouped = teval.test_all_case_wholevolume(_Fixed(preds), volumes, group=2)
    assert grouped["cases"] == got["cases"]


@pytest.fixture(scope="module")
def jax_state():
    net_cfg = JaxNetConfig(dropout_rate=0.0, layout="folded", scale_factor=4)
    model = Model(net_cfg, init_unet3d, unet3d_apply)
    return model, create_train_state(model, jax.random.key(11), make_optimizer(lambda s: 0.01))


def _jax_kink_sides(model, js, batch, key, teacher_train):
    """The JAX step's kink sides (train/device_check.py: KinkSides): its
    teacher and student forwards run again eagerly, in the port's order,
    recording each ReLU's input > 0, each max pool's argmax over its 2^3
    blocks, and the L2-normalised embeddings for the FeCL threshold."""
    from dycon_paper_replication_tpu.models import unet3d as junet
    from dycon_paper_replication_tpu.models import unet3d_folded as jfolded
    from dycon_paper_replication_tpu.ops import folding as jfolding

    relu, pool = [], []

    def rec_relu(x):
        relu.append(torch.from_numpy(np.array(x > 0)))
        return jnp.maximum(x, 0)

    def rec_max(blocks):
        pool.append(torch.from_numpy(np.array(jnp.argmax(blocks, -1))))
        return blocks.max(-1)

    def max_pool_2x(x, data_format="NDHWC"):
        b, d1, d2, d3, c = x.shape
        x = x.reshape(b, d1 // 2, 2, d2 // 2, 2, d3 // 2, 2, c).transpose(0, 1, 3, 5, 7, 2, 4, 6)
        return rec_max(x.reshape(b, d1 // 2, d2 // 2, d3 // 2, c, 8))

    def pool_consume_fold(x):
        b, g1, g2, g3, lanes = x.shape
        return rec_max(x.reshape(b, g1, g2, g3, lanes // 8, 8))

    def embeddings(f):
        f = np.asarray(f).reshape(f.shape[0], -1, f.shape[-1])
        return torch.from_numpy(f / np.maximum(np.linalg.norm(f, axis=-1, keepdims=True), 1e-12))

    image = jnp.asarray(batch["image"])
    noise = jnp.asarray(_noise(key, batch["image"].shape))
    with jax.disable_jit(), mock.patch.object(jax.nn, "relu", rec_relu), \
            mock.patch.object(junet, "max_pool_2x", max_pool_2x), \
            mock.patch.object(jfolded, "max_pool_2x", max_pool_2x), \
            mock.patch.object(jfolded, "pool_consume_fold", pool_consume_fold), \
            mock.patch.object(jfolding, "pool_consume_fold", pool_consume_fold):
        t_out, _ = model.apply(js.teacher_params, js.teacher_state, image + noise,
                               train=teacher_train, rng=None)
        s_out, _ = model.apply(js.params, js.model_state, image, train=True,
                               rng=jax.random.split(key, 3)[1])
    return KinkSides.given(relu, pool, [(embeddings(s_out[2]), embeddings(t_out[2]))])


@pytest.mark.parametrize("impl", ["fused", "chunked"])
def test_isles_train_step_matches_jax(jax_state, impl):
    model, js0 = jax_state
    over = dict(patch_size=PATCH, batch_size=B, labeled_bs=LBS, fecl_chunk=96, fecl_impl=impl)
    jcfg = jconfig.make_config("isles22", **over)
    optimizer = make_optimizer(lambda step: jcfg.base_lr, jcfg.momentum, jcfg.weight_decay,
                               jcfg.grad_clip_norm)
    jstep = jax.jit(jax_build_train_step(model, optimizer, jcfg, diagnostics=False))
    tcfg = tconfig.make_config("isles22", device="cpu", **over)
    port = weights.jax_train_state_to_torch(
        _np(js0), UNet3DConfig(dropout_rate=0.0, layout="folded", scale_factor=4))
    batch, key = _batch(1), jax.random.key(21)
    scalars = (5.0, 0.1 * np.exp(-5.0), 1.3, 0.05)
    js1, metrics = jstep(js0, {k: jnp.asarray(v) for k, v in batch.items()}, key,
                         JaxScalars.make(*scalars))
    sides = _jax_kink_sides(model, js0, batch, key, jcfg.teacher_train_mode)
    with sides.share():
        got, _ = build_train_step(tcfg, lambda step: tcfg.base_lr)(
            port, {k: torch.from_numpy(v) for k, v in batch.items()}, _words(key),
            StepScalars(*scalars))
    assert sides.counts["cross_near"] > 0
    want = np.asarray(metrics["scalars"])
    assert got[SCALAR_METRICS.index("skipped")] == 0 == want[SCALAR_METRICS.index("skipped")]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    _compare_states(port, [js1], _np(js0), jcfg.base_lr)


def test_isles_config_flags():
    cfg = tconfig.config_from_args("isles22", ["--fecl_chunk", "64", "--fecl_impl", "chunked"])
    assert (cfg.fecl_chunk, cfg.fecl_impl, cfg.feature_scaler, cfg.patch_size) == (
        64, "chunked", 4, (96, 96, 64))
    assert tconfig.config_from_args("isles22", []).fecl_chunk == 512
    for bad in (["--fecl_chunk", "-1"], ["--fecl_impl", "dense"], ["--data_parallel", "-1"]):
        with pytest.raises(SystemExit):
            tconfig.config_from_args("isles22", bad)
    assert tconfig.config_from_args("isles22", ["--data_parallel", "2"]).data_parallel == 2
    args = test_isles22.build_parser().parse_args(["--data_parallel", "2", "--group", "4"])
    assert (args.data_parallel, args.group) == (2, 4)
    assert test_isles22.build_parser().parse_args(
        ["--compute_dtype", "bfloat16"]).compute_dtype == "bfloat16"
    assert tconfig.config_from_args(
        "isles22", ["--compute_dtype", "bfloat16"]).torch_compute_dtype() == torch.bfloat16
    assert ISLES_PATIENTS_TO_SLICES[10] == 45


def test_isles_train_and_test_clis_on_cpu(tmp_path, capsys):
    root, runs = tmp_path / "ISLES22", tmp_path / "runs"
    tsynthetic.make_isles22(str(root), n_train=24, n_val=2, shape=(20, 24, 18), seed=1,
                            suffix=".npz")
    flags = ["--root_dir", str(root), "--snapshot_root", str(runs), "--device", "cpu",
             "--patch_size", "16", "16", "16", "--labelnum", "18", "--max_iterations", "3"]
    argv = flags + ["--batch_size", "2", "--labeled_bs", "1", "--val_every", "2",
                    "--save_every", "3", "--fecl_chunk", "24"]
    trainer = Trainer(tconfig.config_from_args("isles22", argv))
    assert trainer.whole_volume is not None and trainer.whole_volume.head == "sdf"
    best = trainer.run()
    assert trainer.state.step == 3 and best > 0
    snap = trainer.snapshot_path
    records = [json.loads(line) for line in open(f"{snap}/metrics.jsonl")]
    assert [r["step"] for r in records if r["tag"] == "info/loss"] == [1, 2, 3]
    assert [r["step"] for r in records if r["tag"] == "info/Dice"] == [2]
    assert all(np.isfinite(r["value"]) for r in records)
    # the CLI entry point resumes the finished run: no step runs, the best stays
    assert train_isles22.main(argv + ["--resume", "auto"]) == best

    summary = test_isles22.main(flags)
    out = capsys.readouterr().out
    assert "Loading best model from" in out and "TESTING RESULTS FOR ISLES22" in out
    assert len(summary["cases"]) == 2
    assert all(np.isfinite(summary[k]) for k in ("dice", "hd95", "asd", "sensitivity",
                                                 "specificity"))
    assert (runs / "ISLES22" / snap.split("/")[-1] / "test_results_labelnum18.txt").exists()


@pytest.mark.parametrize("layout", ["NDHWC", "folded"])
@pytest.mark.parametrize("shape", [(20, 37, 13), (33, 32, 17)])
def test_whole_volume_padded_against_float64(net_weights, monkeypatch, layout, shape):
    """The port's head outputs on the zero-padded volume against the plain
    UNet3D in float64 (float64 InstanceNorm statistics), both heads, within
    1e-4 (about 3x the largest reading, 3.1e-5 of a seg logit up to 7.3;
    the SDF head 2.2e-5). The gap to JAX that test_whole_volume_matches_jax
    allows is JAX's own: its outputs here lie 1.0e-3 to 3.1e-3 from
    float64, and 2.1e-5 with its InstanceNorm sums taken one axis at a
    time (tests/test_torch_brats.py module doc)."""
    params, state = net_weights
    sd = weights.jax_tree_to_state_dict(params, state)
    net = UNet3D(UNet3DConfig(scale_factor=4, layout=layout)).eval()
    net.load_state_dict(sd)
    net64 = UNet3D(UNet3DConfig(scale_factor=4)).double().eval()
    net64.load_state_dict(sd)
    rng = np.random.default_rng(sum(shape))
    image = rng.random(shape).astype(np.float16).astype(np.float32)
    padded, _ = teval.WholeVolumeInference(net, PATCH)._pad(image)
    x = torch.from_numpy(padded)[None, ..., None]
    with torch.no_grad():
        got = net(x, with_projection=False)
        monkeypatch.setattr(tlayers, "instance_norm", _instance_norm_f64)
        want = net64(x.double(), with_projection=False)
    for head in (0, 1):
        err = (got[head].double() - want[head]).abs().max().item()
        assert err <= 1e-4, f"head {head}: {err}"
