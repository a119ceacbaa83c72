"""The port's NIfTI reader / writer and preprocessing against the JAX
package's, on fabricated BraTS and ISLES trees (hermetic, numpy and h5py on
the CPU).

  * data/nifti.py: a file written by either package's `save` reads back
    equal through the other's `load` (array, shape, zooms), for every dtype
    of tests/test_preprocess.py's round trip, gzipped or not, and the two
    writers' (decompressed) bytes are equal;
  * normalize_image and resample equal to JAX's, bit for bit;
  * the BraTS and ISLES pipelines (and their CLIs): the port's .h5 cases
    equal to JAX's array for array, the split lists identical;
  * `--format npz` writes the same arrays, which the port's datasets read
    (BraTS2019 in axial view, ISLESDataset, iter_volumes);
  * asking for h5 without h5py raises, before any case is written.
"""

import gzip
import os
import sys

import h5py
import numpy as np
import pytest

from dycon_paper_replication_tpu.data import nifti as jnifti
from dycon_paper_replication_tpu.data import preprocess as jpre
from dycon_paper_replication_tpu_torch.cli import preprocess_brats19, preprocess_isles22
from dycon_paper_replication_tpu_torch.data import BraTS2019, ISLESDataset
from dycon_paper_replication_tpu_torch.data import nifti as tnifti
from dycon_paper_replication_tpu_torch.data import preprocess as tpre
from dycon_paper_replication_tpu_torch.eval import iter_volumes


def _bytes(path):
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("dtype", [np.uint8, np.int16, np.float32, np.float64])
def test_nifti_matches_jax(tmp_path, rng, compress, dtype):
    data = rng.uniform(0, 100, size=(9, 7, 5)).astype(dtype)
    ext = ".nii.gz" if compress else ".nii"
    paths = {}
    for name, mod in (("port", tnifti), ("jax", jnifti)):
        paths[name] = str(tmp_path / (name + ext))
        mod.save(paths[name], data, zooms=(1.0, 2.0, 3.0))
    assert _bytes(paths["port"]) == _bytes(paths["jax"])
    for writer, reader in (("port", jnifti), ("jax", tnifti)):
        img = reader.load(paths[writer])
        assert img.shape == (9, 7, 5) and img.zooms == (1.0, 2.0, 3.0)
        np.testing.assert_array_equal(img.get_fdata(), data.astype(np.float64))
        np.testing.assert_array_equal(tnifti.load(paths[writer]).get_fdata(),
                                      jnifti.load(paths[writer]).get_fdata())


def test_normalize_and_resample_match_jax(rng):
    img = np.where(rng.uniform(size=(21, 19, 13)) > 0.3,
                   rng.uniform(10, 50, size=(21, 19, 13)), 0.0)
    got, want = tpre.normalize_image(img), jpre.normalize_image(img)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    zeros = np.zeros((4, 4, 4))
    np.testing.assert_array_equal(tpre.normalize_image(zeros), jpre.normalize_image(zeros))
    lab = (rng.uniform(size=img.shape) > 0.8).astype(np.uint8)
    for target in ((19, 19, 13), (37, 40, 7)):
        gi, gl = tpre.resample(got, lab, target)
        wi, wl = jpre.resample(want, lab, target)
        assert gi.dtype == wi.dtype and gl.dtype == wl.dtype
        assert np.array_equal(gi, wi) and np.array_equal(gl, wl)


def _brats_tree(root, cases=("BraTS19_TCIA_001_1", "BraTS19_TCIA_002_1")):
    for i, case in enumerate(cases):
        d = os.path.join(root, "HGG" if i % 2 == 0 else "LGG", case)
        os.makedirs(d)
        rng = np.random.default_rng(i)
        vol = rng.uniform(0, 800, size=(24, 22, 16)).astype(np.float32)
        seg = np.zeros((24, 22, 16), np.uint8)
        seg[8:14, 6:14, 4:10] = 2  # edema, binarised to 1
        for mod in ("t1", "flair", "t2"):  # t2 is preferred
            jnifti.save(os.path.join(d, f"{case}_{mod}.nii.gz"), vol * (1 + (mod == "t2")))
        jnifti.save(os.path.join(d, f"{case}_seg.nii.gz"), seg)
    return list(cases)


def _isles_tree(root, n_cases=5):
    cases = [f"sub-strokecase{i:04d}" for i in range(1, n_cases + 1)]
    for i, case in enumerate(cases):
        rng = np.random.default_rng(10 + i)
        dwi = os.path.join(root, case, "ses-0001", "dwi")
        msk = os.path.join(root, "derivatives", case, "ses-0001")
        os.makedirs(dwi)
        os.makedirs(msk)
        vol = rng.uniform(0, 500, size=(20, 20, 12)).astype(np.float32)
        mask = np.zeros((20, 20, 12), np.uint8)
        mask[5:9, 4:9, 3:7] = 1
        modality = "adc" if i == 2 else "dwi"  # one case takes the fallback
        jnifti.save(os.path.join(dwi, f"{case}_ses-0001_{modality}.nii.gz"), vol)
        jnifti.save(os.path.join(msk, f"{case}_ses-0001_msk.nii.gz"), mask)
    return cases


def _h5(path):
    with h5py.File(path, "r") as f:
        return {k: f[k][:] for k in f}, dict(f.attrs)


def _npz(path):
    with np.load(path) as f:
        return {k: f[k] for k in f.files if k != "case_name"}, str(f["case_name"])


def test_brats_pipeline_matches_jax(tmp_path):
    src = str(tmp_path / "src")
    cases = _brats_tree(src)
    assert jpre.preprocess_brats2019(src, str(tmp_path / "jax")) == 2
    assert preprocess_brats19.main(["--input_dir", src, "--output_dir",
                                    str(tmp_path / "h5")]) == 2
    assert preprocess_brats19.main(["--input_dir", src, "--output_dir",
                                    str(tmp_path / "root" / "data"), "--format", "npz"]) == 2
    for case in cases:
        want, want_attrs = _h5(tmp_path / "jax" / f"{case}.h5")
        got, attrs = _h5(tmp_path / "h5" / f"{case}.h5")
        assert got.keys() == want.keys() == {"image", "label"} and attrs == want_attrs
        for k in want:
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
        arrays, name = _npz(tmp_path / "root" / "data" / f"{case}.npz")
        assert name == case and arrays.keys() == want.keys()
        for k in want:
            assert arrays[k].dtype == want[k].dtype and np.array_equal(arrays[k], want[k]), k
        assert want["image"].shape == tpre.BRATS_TARGET_SHAPE and want["label"].sum() > 0
    # the port's BraTS dataset reads the npz cases (axial view)
    with open(tmp_path / "root" / "train.txt", "w") as f:
        f.write("\n".join(cases) + "\n")
    ds = BraTS2019(str(tmp_path / "root"), split="train")
    sample = ds.get(1, np.random.default_rng(0))
    want, _ = _h5(tmp_path / "jax" / f"{cases[1]}.h5")
    np.testing.assert_array_equal(sample["image"], np.transpose(want["image"], (2, 1, 0)))
    np.testing.assert_array_equal(sample["label"], np.transpose(want["label"], (2, 1, 0)))


def test_isles_pipeline_matches_jax(tmp_path):
    src = str(tmp_path / "src")
    cases = _isles_tree(src)
    assert jpre.preprocess_isles22(src, str(tmp_path / "jax")) == 5
    assert preprocess_isles22.main(["--input_dir", src, "--output_dir",
                                    str(tmp_path / "h5")]) == 5
    assert preprocess_isles22.main(["--input_dir", src, "--output_dir", str(tmp_path / "npz"),
                                    "--format", "npz"]) == 5
    for split in ("train.list", "val.list"):
        want = (tmp_path / "jax" / split).read_text()
        assert (tmp_path / "h5" / split).read_text() == want
        assert (tmp_path / "npz" / split).read_text() == want
    train = (tmp_path / "jax" / "train.list").read_text().split()
    val = (tmp_path / "jax" / "val.list").read_text().split()
    assert sorted(train + val) == cases and len(train) == 4
    for case in cases:
        want, want_attrs = _h5(tmp_path / "jax" / f"{case}.h5")
        got, attrs = _h5(tmp_path / "h5" / f"{case}.h5")
        assert got.keys() == want.keys() == {"image", "mask"} and attrs == want_attrs
        arrays, name = _npz(tmp_path / "npz" / f"{case}.npz")
        assert name == case
        for k in want:
            assert np.array_equal(got[k], want[k]) and np.array_equal(arrays[k], want[k]), k
            assert got[k].dtype == arrays[k].dtype == want[k].dtype
    # the port's ISLES dataset and evaluator read the npz cases
    ds = ISLESDataset(str(tmp_path / "npz"), split="val")
    assert [os.path.basename(p) for p in ds.paths] == [f"{c}.npz" for c in val]
    (image, mask), = list(iter_volumes(ds.paths, label_key="mask"))
    want, _ = _h5(tmp_path / "jax" / f"{val[0]}.h5")
    assert image.shape == tpre.ISLES_TARGET_SHAPE
    np.testing.assert_array_equal(image, want["image"])
    np.testing.assert_array_equal(mask, want["mask"])
    t1, v1 = tpre.create_isles_splits([f"c{i}" for i in range(10)], str(tmp_path / "a"))
    t2, v2 = jpre.create_isles_splits([f"c{i}" for i in range(10)], str(tmp_path / "b"))
    assert (t1, v1) == (t2, v2)


def test_h5_without_h5py_raises(tmp_path, monkeypatch):
    src = str(tmp_path / "src")
    _isles_tree(src, n_cases=2)
    monkeypatch.setitem(sys.modules, "h5py", None)  # import h5py now fails
    for run in (lambda: preprocess_isles22.main(["--input_dir", src, "--output_dir",
                                                 str(tmp_path / "out")]),
                lambda: tpre.write_case(str(tmp_path / "out"), "c", {"image": np.zeros(2)})):
        with pytest.raises(RuntimeError, match="--format npz"):
            run()
    assert not (tmp_path / "out").exists()
    # npz needs no h5py
    assert preprocess_isles22.main(["--input_dir", src, "--output_dir", str(tmp_path / "npz"),
                                    "--format", "npz"]) == 2
    with pytest.raises(SystemExit):
        preprocess_isles22.main(["--input_dir", src, "--output_dir", "x", "--format", "nii"])
