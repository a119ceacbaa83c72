"""The port's data path against the JAX package's: the same index lists and
bit-identical batches for one seed.

A small synthetic Pancreas tree is written twice by the port, as .h5 and as
.npz (the same volumes). The JAX package reads the .h5 tree (it reads no
.npz); the port reads both. Its TwoStreamBatchSampler, Pancreas dataset
with RandomRotFlip + ToArray, and BatchLoader must give exactly the JAX
package's index lists and batches, including volumes small enough for the
pad-with-margin crop.
"""

import numpy as np
import pytest

from dycon_paper_replication_tpu import data as jdata
from dycon_paper_replication_tpu.data import synthetic as jsynthetic
from dycon_paper_replication_tpu_torch import data as tdata
from dycon_paper_replication_tpu_torch.data import synthetic as tsynthetic

PATCH = (16, 16, 12)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    out = {}
    for suffix in (".h5", ".npz"):
        path = str(root / suffix[1:] / "Pancreas")
        tsynthetic.make_pancreas(path, n_train=6, n_test=1, shape=(24, 20, 16), seed=4,
                                 suffix=suffix)
        out[suffix] = path
    return out


def _datasets(root, pkg, crop=PATCH):
    transform = pkg.Compose([pkg.RandomRotFlip(), pkg.ToArray()])
    return pkg.Pancreas(root, split="train", transform=transform, crop_size=crop)


def test_synthetic_tree_matches_jax(tmp_path):
    """The port's writer gives the JAX writer's lists and volumes."""
    jsynthetic.make_pancreas(str(tmp_path / "j"), n_train=2, n_test=1, shape=(12, 10, 8), seed=3)
    tsynthetic.make_pancreas(str(tmp_path / "t"), n_train=2, n_test=1, shape=(12, 10, 8), seed=3,
                             suffix=".npz")
    for name in ("train.list", "test.list", "test1.list"):
        j = (tmp_path / "j" / name).read_text().split()
        t = (tmp_path / "t" / name).read_text().split()
        assert [n.replace(".h5", ".npz") for n in j] == t
    j_ds = jdata.Pancreas(str(tmp_path / "j"), split="train")
    t_ds = tdata.Pancreas(str(tmp_path / "t"), split="train")
    for i in range(2):
        a, b = j_ds.get(i, np.random.default_rng(0)), t_ds.get(i, np.random.default_rng(0))
        for k in ("image", "label"):
            np.testing.assert_array_equal(b[k], a[k])
            assert b[k].dtype == a[k].dtype


@pytest.mark.parametrize("seed", [0, 5])
def test_sampler_matches_jax(seed):
    args = (range(4), range(4, 11), 4, 2)
    j = jdata.TwoStreamBatchSampler(*args, seed=seed)
    t = tdata.TwoStreamBatchSampler(*args, seed=seed)
    assert len(j) == len(t) == 2
    for _ in range(3):  # epochs: the unlabeled stream carries across them
        assert list(iter(t)) == list(iter(j))


def test_sampler_rejects_empty_streams():
    with pytest.raises(ValueError):
        tdata.TwoStreamBatchSampler(range(1), range(1, 5), 4, 2)


@pytest.mark.parametrize("suffix", [".h5", ".npz"])
@pytest.mark.parametrize("crop", [PATCH, (16, 24, 12)])
def test_dataset_samples_match_jax(trees, suffix, crop):
    """Windowed crops, and (crop 24 > 20 on one axis) the padded crop."""
    j_ds, t_ds = _datasets(trees[".h5"], jdata, crop), _datasets(trees[suffix], tdata, crop)
    for i in range(len(j_ds)):
        a = j_ds.get(i, np.random.default_rng((9, i)))
        b = t_ds.get(i, np.random.default_rng((9, i)))
        for k in ("image", "label"):
            np.testing.assert_array_equal(b[k], a[k])
            assert b[k].dtype == a[k].dtype and b[k].flags.c_contiguous


@pytest.mark.parametrize("suffix", [".h5", ".npz"])
def test_loader_batches_match_jax(trees, suffix):
    sampler_args = (range(2), range(2, 6), 4, 2)
    j = jdata.BatchLoader(_datasets(trees[".h5"], jdata),
                          jdata.TwoStreamBatchSampler(*sampler_args, seed=3), seed=3, prefetch=2)
    t = tdata.BatchLoader(_datasets(trees[suffix], tdata),
                          tdata.TwoStreamBatchSampler(*sampler_args, seed=3), seed=3, prefetch=2)
    assert len(j) == len(t) == 1
    got = list(t.epochs(3))
    want = list(j.epochs(3))
    assert [e for e, _ in got] == [e for e, _ in want] == [0, 1, 2]
    for (_, b), (_, a) in zip(got, want):
        for k in ("image", "label"):
            np.testing.assert_array_equal(b[k], a[k])
            assert b[k].dtype == a[k].dtype
        assert b["image"].shape == (4, *PATCH, 1)
    # one more epoch through __iter__: epoch index 3 on both sides
    for b, a in zip(iter(t), iter(j)):
        np.testing.assert_array_equal(b["image"], a["image"])


def test_loader_surfaces_a_read_error(tmp_path):
    ds = tdata.Pancreas.__new__(tdata.Pancreas)
    tdata.VolumeDataset.__init__(ds, [str(tmp_path / "missing.npz")] * 3, crop_size=PATCH)
    loader = tdata.BatchLoader(ds, tdata.TwoStreamBatchSampler(range(1), range(1, 3), 2, 1))
    with pytest.raises(RuntimeError, match="producer thread failed"):
        list(loader.epochs(1))
