"""The port's host loop against the JAX trainer's, on the CPU.

  * (a) the two packages' train parsers (both `build_parser`) take the same
    options, but --device (the port's) and --gpu_id, --gpu_ids and
    --use_ddp (the JAX package's no-ops, which the port refuses), with
    equal defaults, for the three datasets;
  * (b) `fetch_ahead` 0 and 1 x `step_diagnostics` "always" and "cadence"
    change when the host reads a step, never what the step computes: for
    the UNet3D on Pancreas and ISLES with the fused FeCL here, and the VNet
    and the UNet3D over 2 gloo ranks (the global batch of 4) in
    tests/test_torch_host_loop_paths.py, 8 iterations at val_every 8
    (hd95_every 2: iterations 3, 5 and 7 are queued behind the next step,
    and light under "cadence") end in bit-identical states (torch.equal
    over the student, the teacher, the momentum and the running stats of
    the saved iter_8, and its step), equal best-val bars and equal logged
    info/ and train/ scalars. The JAX package's counterpart is
    tests/test_train.py's test_fetch_ahead_and_light_step_equivalence;
  * (e) the loader's wire dtypes: at float16 / uint8 the port's batches
    are bit-equal to the JAX loader's at the same wire dtypes, and to its
    own float32 batches rounded to float16; the pinned ring hands a slot
    out again only once the event of its last copy has completed (a fake
    event holds it), and in turn.

The NaN/Inf skip against the JAX trainer is in
tests/test_torch_host_loop_nan.py.
"""

import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from dycon_paper_replication_tpu import config as jconfig
from dycon_paper_replication_tpu import data as jdata
from dycon_paper_replication_tpu_torch import config as tconfig
from dycon_paper_replication_tpu_torch import data as tdata
from dycon_paper_replication_tpu_torch import parallel
from dycon_paper_replication_tpu_torch.data import pipeline, synthetic
from dycon_paper_replication_tpu_torch.train import trainer as ttrainer
from dycon_paper_replication_tpu_torch.utils import checkpoint

torch.set_num_threads(1)
STEPS = 8  # val_every 8: hd95_every 2
SETTINGS = [(0, "always"), (0, "cadence"), (1, "always"), (1, "cadence")]


# ---------------------------------------------------------------- (a) the parsers


@pytest.mark.parametrize("dataset", ["pancreas", "brats19", "isles22"])
def test_parsers_take_the_same_flags(dataset):
    port, jax_parser = tconfig.build_parser(dataset), jconfig.build_parser(dataset)
    flags = {p: {s: a for a in parser._actions for s in a.option_strings}
             for p, parser in (("port", port), ("jax", jax_parser))}
    assert flags["port"].keys() - flags["jax"].keys() == {"--device"}
    assert flags["jax"].keys() - flags["port"].keys() == {"--gpu_id", "--gpu_ids", "--use_ddp"}
    for flag in flags["port"].keys() & flags["jax"].keys():
        assert flags["port"][flag].default == flags["jax"][flag].default, flag


# ---------------------------------------------------------------- (b) the schedules


def _tree(kind, root):
    if kind == "isles":
        synthetic.make_isles22(root, n_train=24, n_val=1, shape=(20, 24, 18), seed=2,
                               suffix=".npz")
    else:
        synthetic.make_pancreas(root, n_train=6, n_test=1, shape=(40, 36, 24), seed=1,
                                suffix=".npz")


def _argv(kind, root, runs, fetch_ahead, diagnostics):
    argv = ["--device", "cpu", "--root_dir", root, "--snapshot_root", runs,
            "--max_iterations", str(STEPS), "--val_every", str(STEPS), "--save_every", str(STEPS),
            "--fetch_ahead", str(fetch_ahead), "--step_diagnostics", diagnostics,
            "--batch_size", "2", "--labeled_bs", "1"]
    if kind == "isles":
        return argv + ["--patch_size", "16", "16", "16", "--labelnum", "18",
                       "--fecl_chunk", "64", "--fecl_impl", "fused"]
    argv += ["--patch_size", *(("16", "16", "16") if kind == "dp2" else ("32", "32", "16")),
             "--labelnum", "2"]
    if kind == "vnet":
        argv += ["--model", "vnet"]
    if kind == "dp2":
        argv[argv.index("--batch_size") + 1], argv[argv.index("--labeled_bs") + 1] = "4", "2"
        argv += ["--data_parallel", "2"]
    return argv


def _outcome(cfg, best):
    """(best, {name: tensor} of the saved final state, logged info/ and
    train/ scalars) of a finished run."""
    ckpt = torch.load(checkpoint.iter_checkpoint_path(cfg.snapshot_path(), STEPS),
                      map_location="cpu", weights_only=False)
    state = {f"{part}.{k}": v for part in ("model", "teacher", "momentum")
             for k, v in ckpt[part].items()}
    state["step"] = torch.tensor(ckpt["step"])
    with open(os.path.join(cfg.snapshot_path(), "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    logged = {(r["step"], r["tag"]): r["value"] for r in rows
              if r["tag"].startswith(("info/", "train/"))}
    return best, state, logged


def _dp_runs(rank, world, device, cfgs):
    """Each config's Trainer in this rank, in turn; rank 0's outcomes."""
    out = []
    for cfg in cfgs:
        best = ttrainer.Trainer(cfg, rank, world).run()
        out.append(_outcome(cfg, best) if rank == 0 else None)
    return out


def hold_schedules(tmp_path, kind):
    """(b) for one path (module doc)."""
    root = str(tmp_path / "data")
    _tree(kind, root)
    dataset = "isles22" if kind == "isles" else "pancreas"
    cfgs = [tconfig.config_from_args(dataset, _argv(kind, root, str(tmp_path / f"r{fa}{sd}"),
                                                    fa, sd)) for fa, sd in SETTINGS]
    if kind == "dp2":
        outcomes = parallel.launch(_dp_runs, 2, args=(cfgs,), threads=1, timeout=600)
    else:
        outcomes = [_outcome(cfg, ttrainer.Trainer(cfg).run()) for cfg in cfgs]
    (best0, state0, logged0) = outcomes[0]
    assert int(state0["step"]) == STEPS and best0 > 0
    assert sorted({s for s, t in logged0 if t == "train/HD95"}) == [1, 2, 4, 6, 8]
    for (fa, sd), (best, state, logged) in zip(SETTINGS[1:], outcomes[1:]):
        assert best == best0, (fa, sd)
        assert state.keys() == state0.keys()
        differ = [k for k in state0 if not torch.equal(state[k], state0[k])]
        assert not differ, (fa, sd, differ[:3])
        assert logged == logged0, (fa, sd)


@pytest.mark.parametrize("kind", ["unet_3D", "isles"])
def test_schedules_end_in_the_same_state(tmp_path, kind):
    hold_schedules(tmp_path, kind)


# ---------------------------------------------------------------- (e) the wire


def _loader(pkg, root, image_dtype, label_dtype):
    """The package's BatchLoader over a Pancreas tree at the wire dtypes; the
    JAX one through its pooled buffers (a device_put that copies them out,
    since the ring reuses them)."""
    ds = pkg.Pancreas(root, split="train", crop_size=(32, 32, 16),
                      transform=pkg.Compose([pkg.RandomRotFlip(), pkg.ToArray()]))
    sampler = pkg.TwoStreamBatchSampler(range(4), range(4, 6), 4, 2, seed=3)
    kw = dict(seed=5, prefetch=1, image_dtype=image_dtype, label_dtype=label_dtype)
    if pkg is jdata:
        kw["device_put"] = lambda b: {k: v.copy() for k, v in b.items()}
    return pkg.BatchLoader(ds, sampler, **kw)


def test_wire_float16_batches_match_jax(tmp_path):
    root = str(tmp_path / "Pancreas")
    synthetic.make_pancreas(root, n_train=6, n_test=1, shape=(40, 36, 24), seed=1)
    got = [b for _, b in _loader(tdata, root, np.float16, np.uint8).epochs(2)]
    want = [b for _, b in _loader(jdata, root, np.float16, np.uint8).epochs(2)]
    wide = [b for _, b in _loader(tdata, root, np.float32, np.int32).epochs(2)]
    assert len(got) == len(want) == len(wide) == 4
    for g, w, f in zip(got, want, wide):
        assert g["image"].dtype == np.float16 and g["label"].dtype == np.uint8
        assert w["image"].dtype == np.float16 and w["label"].dtype == np.uint8
        assert f["image"].dtype == np.float32 and f["label"].dtype == np.int32
        np.testing.assert_array_equal(g["image"].view(np.uint16), w["image"].view(np.uint16))
        np.testing.assert_array_equal(g["label"], w["label"])
        np.testing.assert_array_equal(g["image"].view(np.uint16),
                                      f["image"].astype(np.float16).view(np.uint16))
        np.testing.assert_array_equal(g["label"], f["label"])


class _FakeEvent:
    def __init__(self):
        self.done = threading.Event()

    def query(self):
        return self.done.is_set()


def test_pinned_ring_waits_for_the_copy():
    """A slot whose copy has not completed is not handed out: acquire blocks
    until its event completes. A ring that reused it at once would return
    within the first wait and fail."""
    ring = pipeline.PinnedRing(2, lambda: {"image": np.zeros(3)}, poll_s=1e-3)
    slots = []
    for _ in range(2):
        i, buf = ring.acquire()
        slots.append(i)
        ring.release(i, _FakeEvent())
    assert slots == [0, 1]
    got = []
    waiter = threading.Thread(target=lambda: got.append(ring.acquire()[0]))
    waiter.start()
    waiter.join(timeout=0.3)
    assert waiter.is_alive() and got == []  # slot 0's copy is still in flight
    ring.events[1].done.set()  # another slot's completion does not free slot 0
    time.sleep(0.05)
    assert got == []
    ring.events[0].done.set()
    waiter.join(timeout=5)
    assert got == [0]
    i, _ = ring.acquire()  # slot 1's event has completed: no wait
    assert i == 1
