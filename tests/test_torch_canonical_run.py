"""The canonical relay driver (scripts/canonical_run_torch.py) and its
summariser (scripts/canonical_table_torch.py) against the JAX package's
relay and scripts/summarize_canon20k.py, on the CPU.

Tolerances, stated before the first run:
  * (i) the relay in both packages' Trainers, built from the driver's flags
    (`train_argv`) at a tiny size (a tree of 6 + 1 volumes of (40, 40,
    24), patch (32, 32, 16), batch 4 of which 2 labeled, labelnum 2,
    max_iterations 6, save_every 2, val_every 2, float32: the parity is
    tests/test_torch_train_step.py's), each killed in process at its 4th
    dispatch, after the save at 2, and resumed with `auto`. Validation is
    scripted (0.3 at 2, 0.45 at 4, 0.4 at 6) on both sides. Equal: the
    step each resumes at (2) and its best-so-far (0.3), the batches of the
    resumed steps, the final step and best (0.45). The first step's 8
    scalars within rtol 1e-5 + atol 1e-6 (one step from equal states),
    every later step's, the resumed ones', within rtol 1e-4 + atol 1e-5
    (that file's bound for what is computed from parameters that already
    differ: the first run held the resumed leg's third step, FeCL, to 1e-5
    and missed by 1.8e-5 relative), and the final state within
    tests/test_torch_train_step.py's path-scaled tolerances. Each Trainer
    starts from its own initial weights and draws its own teacher noise and
    dropout masks (JAX's streams, ops/threefry.py: each step's key equal to
    the JAX step's, checked); only the kink sides of each JAX step are
    shared (as tests/test_torch_ablation.py shares them);
  * the driver's own relay on the CPU: a fresh leg SIGKILLed after a save
    and a best, pack, unpack into an empty run directory (each tensor of
    the state and of the best model bit-equal), the test leg on the
    carried best, `--resume auto` to the end and the test leg again; the
    relay log's lines and the summariser's gate (a); the kill at the first
    logged iteration >= kill_at, a log line written in two parts too;
  * (ii) on bench_results/r05_canonical20k_metrics.jsonl (and the BraTS
    relay's file), the port's summariser gives the iterations reached,
    the validation count, best val Dice, the milestone Dice and host RSS
    min / median / max that scripts/summarize_canon20k.py prints, to its
    printed digits; its loss windows give the TPU's 1.0728, 1.0966,
    1.0913 and 1.1627; its step windows on r04 against r05 are 0 at
    steps 1-1000 (the TPU's reruns bit-identical up to r04's resume at
    1200) and not 0 at 1001-2000, and `--compare` shows a second run's
    summary as summarize gives it;
  * (iii) the port's make_pancreas / make_brats19 at the canonical shapes
    and seeds bit-equal to JAX's on their first two volumes;
  * (iv) the driver fails on a leg that exits non-zero without being
    killed, on a resume anywhere but one past the last save, and on a
    best-so-far other than the one logged by that save, and passes the
    same legs done right.
"""

import contextlib
import dataclasses
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys
import types

import jax
import numpy as np
import pytest
import torch

from dycon_paper_replication_tpu import config as jconfig
from dycon_paper_replication_tpu.train import trainer as jtrainer
from dycon_paper_replication_tpu.utils import checkpoint as jcheckpoint
from dycon_paper_replication_tpu_torch import config as tconfig
from dycon_paper_replication_tpu_torch import weights
from dycon_paper_replication_tpu_torch.data import synthetic
from dycon_paper_replication_tpu_torch.train import trainer as ttrainer
from dycon_paper_replication_tpu_torch.train.device_check import KinkSides
from dycon_paper_replication_tpu_torch.utils import checkpoint
from test_torch_train_step import PATCH, _compare_states
from test_torch_vnet_train import _JaxKinkSides

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCALAR_RTOL, SCALAR_ATOL = 1e-5, 1e-6
DRIFT_TOL = (1e-4, 1e-5)  # (rtol, atol) once the two states differ
TREE = dict(n_train=6, n_test=1, shape=(40, 40, 24))
RELAY_ITERS, CRASH_AT = 6, 4  # killed at the 4th dispatch: saved at 2, resumed at 3
DICE = {2: 0.3, 4: 0.45, 6: 0.4}


def _script(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


driver = _script("canonical_run_torch")
table = _script("canonical_table_torch")


def _copy(tree):
    return jax.tree.map(np.array, tree)


# ---------------------------------------------------------------- (i) the relay against JAX's


class _Crash(Exception):
    """The in-process kill."""


def _relay_args(root, work, *extra):
    return driver.parse_args(
        ["--dataset", "pancreas", "--leg", "fresh", "--device", "cpu", "--root", root,
         "--work", work, "--", "--max_iterations", str(RELAY_ITERS), "--save_every", "2",
         "--val_every", "2", "--labelnum", "2", "--patch_size", *map(str, PATCH),
         "--batch_size", "4", "--labeled_bs", "2", *extra])


def _jax_leg(cfg, recorded, steps, crash):
    """One leg of the JAX Trainer, each step recorded into `steps`; killed
    at dispatch CRASH_AT when `crash`. Returns the trainer."""
    jt = jtrainer.Trainer(cfg)
    jt.validate = lambda: DICE[int(jt.state.step)]
    real = jt.train_step
    first = len(steps)

    def step(state, batch, key, scalars):
        if crash and len(steps) - first == CRASH_AT - 1:
            raise _Crash
        n_relu, n_pool = len(recorded.relu), len(recorded.pool)
        new_state, m = real(state, batch, key, scalars)
        jax.effects_barrier()
        steps.append(dict(
            batch={k: np.array(v) for k, v in batch.items()}, key=key,
            vec=np.array(m["scalars"]), relu=(n_relu, len(recorded.relu)),
            pool=(n_pool, len(recorded.pool)),
            fg=np.unpackbits(np.array(m["pred_fg_bits"]), axis=-1,
                             bitorder="little")[..., :PATCH[2]].astype(bool),
            state=types.SimpleNamespace(opt_state=_copy(new_state.opt_state)),
            full=_copy(new_state)))
        return new_state, m

    jt.train_step = jt.train_step_light = step
    jt.init_state = _copy(jt.state)
    if crash:
        with pytest.raises(_Crash):
            jt.run()
        jcheckpoint.wait_until_finished()
    else:
        jt.run()
    return jt


def _port_leg(cfg, recorded, jax_steps, crash):
    """One leg of the port's Trainer, step k taking JAX step k's kink sides;
    fresh from its own initial weights, or resumed."""
    port = ttrainer.Trainer(cfg)
    port.validate = lambda: DICE[int(port.state.step)]
    port.resumed = (int(port.state.step), port.best_performance)
    real = port.train_step
    port.steps = []

    def step(state, batch, key, scalars):
        if crash and len(port.steps) == CRASH_AT - 1:
            raise _Crash
        rec = jax_steps[len(port.steps)]
        sides = KinkSides.given(recorded.relu[slice(*rec["relu"])],
                                recorded.pool[slice(*rec["pool"])], [],
                                [torch.from_numpy(rec["fg"])])
        with sides.share():
            vec, diag = real(state, batch, key, scalars)
        port.steps.append(dict(batch={k: v.numpy().copy() for k, v in batch.items()},
                               vec=vec.numpy().copy(), key=np.asarray(key)))
        return vec, diag

    port.train_step = port.train_step_light = step
    if crash:
        with pytest.raises(_Crash):
            port.run()
    else:
        port.run()
    return port


@pytest.fixture(scope="module")
def relay(tmp_path_factory):
    """Both relays; their run directories (full train states of 74 MB a
    file) are removed after the module's tests."""
    tmp = tmp_path_factory.mktemp("relay")
    root, work = str(tmp / "data"), str(tmp / "port")
    synthetic.make_pancreas(root, seed=1, suffix=".h5", **TREE)
    args = _relay_args(root, work, "--compute_dtype", "float32")
    argv = driver.train_argv(args)
    pcfg = tconfig.config_from_args("pancreas", argv)
    jargv = argv[:argv.index("--device")] + argv[argv.index("--device") + 2:]
    jargv[jargv.index("--snapshot_root") + 1] = str(tmp / "jax")
    jcfg = jconfig.config_from_args("pancreas", jargv + ["--data_parallel", "1"])
    recorded = _JaxKinkSides()
    out = dict(pcfg=pcfg, jcfg=jcfg, jax1=[], jax2=[])
    with contextlib.ExitStack() as stack:
        for patch in recorded.patches():
            stack.enter_context(patch)
        jt1 = _jax_leg(jcfg, recorded, out["jax1"], crash=True)
        jt2 = _jax_leg(dataclasses.replace(jcfg, resume="auto"), recorded, out["jax2"],
                       crash=False)
        stack.close()
        port1 = _port_leg(pcfg, recorded, out["jax1"], crash=True)
        port2 = _port_leg(dataclasses.replace(pcfg, resume="auto"), recorded, out["jax2"],
                          crash=False)
    out.update(jt1=jt1, jt2=jt2, port1=port1, port2=port2,
               saved={side: sorted(os.listdir(cfg.snapshot_path()))
                      for side, cfg in (("port", pcfg), ("jax", jcfg))})
    yield out
    shutil.rmtree(tmp, ignore_errors=True)


def test_relay_resumes_at_the_same_step_and_best(relay):
    assert len(relay["jax1"]) == len(relay["port1"].steps) == CRASH_AT - 1
    for names in relay["saved"].values():
        saved = [int(m.group(1)) for m in
                 map(re.compile(r"iter_(\d+)(?:_dice_[0-9.]+)?(?:\.pt)?").fullmatch, names) if m]
        assert max(saved) == RELAY_ITERS  # iter_6 at the end of leg 2
    jt2 = relay["jt2"]
    assert int(jt2.init_state.step) == 2 and jt2._resumed_best == DICE[2]
    assert relay["port2"].resumed == (2, DICE[2])
    assert len(relay["jax2"]) == len(relay["port2"].steps) == RELAY_ITERS - 2
    assert jt2.best_performance == relay["port2"].best_performance == DICE[4]
    assert int(jt2.state.step) == int(relay["port2"].state.step) == RELAY_ITERS


def test_relay_resumed_steps_match_jax(relay):
    for leg in ("1", "2"):
        port, jax_steps = relay[f"port{leg}"], relay[f"jax{leg}"]
        for i, (p, j) in enumerate(zip(port.steps, jax_steps)):
            np.testing.assert_array_equal(p["key"], np.asarray(jax.random.key_data(j["key"])),
                                          err_msg=f"leg {leg} step {i} key")
            for k in j["batch"]:
                np.testing.assert_array_equal(p["batch"][k], j["batch"][k],
                                              err_msg=f"leg {leg} step {i} {k}")
            assert np.isfinite(p["vec"]).all()
            rtol, atol = (SCALAR_RTOL, SCALAR_ATOL) if (leg, i) == ("1", 0) else DRIFT_TOL
            np.testing.assert_allclose(p["vec"], j["vec"], rtol=rtol, atol=atol,
                                       err_msg=f"leg {leg} step {i}")
    # the state the port resumed into and ran on, against JAX's along the
    # path that reached it (leg 1's steps to the save, then leg 2's)
    path = relay["jax1"][:2] + relay["jax2"]
    _compare_states(relay["port2"].state, [s["state"] for s in path[:-1]] + [path[-1]["full"]],
                    relay["jt1"].init_state, relay["pcfg"].base_lr)


# ---------------------------------------------------------------- the driver's relay


TINY_TRAIN = ["--patch_size", "32", "32", "16", "--batch_size", "2", "--labeled_bs", "1",
              "--labelnum", "2", "--max_iterations", "12", "--save_every", "4", "--val_every", "4",
              "--compute_dtype", "float32"]
TINY_TEST = ["--labelnum", "2", "--max_iterations", "12", "--patch_size", "32", "32", "16",
             "--stride_xy", "16", "--stride_z", "8", "--compute_dtype", "float32"]


def _tiny(tmp_path, *extra, cli=TINY_TRAIN):
    return ["--dataset", "pancreas", "--device", "cpu", "--work", str(tmp_path / "work"),
            "--n_train", "4", "--n_test", "1", "--shape", "40", "40", "24", *extra, "--", *cli]


def _load(path):
    return torch.load(path, weights_only=True)


def _assert_same_tensors(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_driver_relay_with_sigkill(tmp_path):
    try:
        _driver_relay(tmp_path)
    finally:  # full train states, 74 MB a file
        shutil.rmtree(tmp_path / "work", ignore_errors=True)


def _driver_relay(tmp_path):
    """Fresh, SIGKILLed after the save at 4 and the best of the validation
    at 4; pack; unpack on an empty run directory; the test leg at once, on
    the carried best (the best falls before the pack); resume to the end;
    the test leg again."""
    work = tmp_path / "work"
    first = driver.main(_tiny(tmp_path, "--leg", "fresh", "--kill_at", "5"))
    assert first["killed"] and first["rc"] == -9 and first["first_iter"] == 1
    assert 5 <= first["last_iter"] < 12
    carry = str(tmp_path / "carry.zip")
    packed = driver.main(_tiny(tmp_path, "--leg", "pack", "--carry", carry))
    snapshot = driver.snapshot_path(driver.parse_args(_tiny(tmp_path, "--leg", "pack")))
    best_path = checkpoint.best_checkpoint_path(snapshot, "unet_3D")
    original, best = _load(os.path.join(snapshot, packed["file"])), _load(best_path)
    assert packed["best_step"] == best["meta"]["step"] == 4 and best["meta"]["best_dice"] > 0
    shutil.rmtree(work / "runs")
    unpacked = driver.main(_tiny(tmp_path, "--leg", "unpack", "--carry", carry))
    for path in (carry, driver.best_carry(carry)):
        os.remove(path)
    restored = _load(os.path.join(snapshot, packed["file"]))
    assert restored["step"] == original["step"] and restored["meta"] == original["meta"]
    for part in ("model", "teacher", "momentum"):
        _assert_same_tensors(restored[part], original[part])
    restored_best = _load(best_path)
    assert unpacked["best_step"] == 4 and restored_best["meta"] == best["meta"]
    _assert_same_tensors(restored_best["model"], best["model"])
    carried = driver.main(_tiny(tmp_path, "--leg", "test", cli=TINY_TEST))
    assert carried["best_step"] == 4 and carried["tested"] == os.path.basename(best_path)
    assert carried["best_dice"] == carried["logged_best"] == best["meta"]["best_dice"]
    second = driver.main(_tiny(tmp_path, "--leg", "resume", "--time_budget_s", "600"))
    assert second["resumed_step"] == packed["step"] == first["saved_after"][0]
    assert second["first_iter"] == packed["step"] + 1 and second["last_iter"] == 12
    assert second["rc"] == 0 and not second["killed"]
    test = driver.main(_tiny(tmp_path, "--leg", "test", cli=TINY_TEST))
    assert len(test["cases"]) == 1 and all(np.isfinite(test["mean"]))
    assert test["best_dice"] == test["logged_best"] >= carried["best_dice"]
    with open(work / "relay.jsonl") as f:
        assert [json.loads(line)["kind"] for line in f] == ["fresh", "test", "resume", "test"]
    out = table.main(["--dataset", "pancreas", "--work", str(work), "--reach", "12"])
    assert out["gates"]["a"]["met"], out["gates"]["a"]
    assert [(l["first"], l["last"]) for l in out["legs"]] == \
        [(1, first["last_iter"]), (packed["step"] + 1, 12)]
    assert out["skips"] == 0
    assert out["test"]["best_dice"] == out["port"]["final_best"]


def test_driver_kills_at_the_first_iteration_past_kill_at(tmp_path, monkeypatch):
    """run_leg reads its leg's log line by line, a line written in two parts
    too, and kills at the first iteration >= kill_at."""
    script = ("import sys, time\n"
              "for i in range(1, 400):\n"
              "    sys.stdout.write(f'Iteration {i} '); sys.stdout.flush(); time.sleep(0.01)\n"
              "    sys.stdout.write(': Loss : 1.0\\n'); sys.stdout.flush(); time.sleep(0.01)\n")
    args = driver.parse_args(_tiny(tmp_path, "--leg", "fresh"))
    out = driver.run_leg(args, ["-c", script], str(tmp_path / "leg.log"), kill_at=5)
    assert out["killed"] and out["rc"] == -9
    assert 5 <= out["last_iter"] < 5 + 40  # 0.1 s a poll, 50 iterations a second


# ---------------------------------------------------------------- (ii) the summariser


def _jax_summary(metrics):
    text = subprocess.run([sys.executable, os.path.join(REPO, "scripts", "summarize_canon20k.py"),
                           "--metrics", metrics, "--chain", os.devnull, "--eval", os.devnull],
                          capture_output=True, text=True, check=True, cwd=REPO).stdout
    field = {k.strip(): v.strip() for k, v in
             (line.split(":", 1) for line in text.splitlines() if " : " in line)}
    return dict(max_step=int(field["max training iteration reached"]),
                validations=int(field["validations (every 200 iters)"]),
                best=field["best val Dice"],
                milestones={int(m): v for m, v in
                            (item.strip().split(":")
                             for item in field["val Dice at milestones"].split(","))},
                rss=field["host RSS GB (min/median/max)"])


@pytest.mark.parametrize("record", ["r05_canonical20k_metrics.jsonl",
                                    "r05_brats_endurance_metrics.jsonl"])
def test_summary_matches_summarize_canon20k(record):
    path = os.path.join(REPO, "bench_results", record)
    want = _jax_summary(path)
    got = table.summarize(table.load_rows(path))
    assert got["max_step"] == want["max_step"]
    assert got["validations"] == want["validations"]
    assert f"{got['best']:.5f}" == want["best"]
    assert {m: f"{v:.4f}" for m, v in got["milestones"].items()} == want["milestones"]
    assert "/".join(f"{v:.1f}" for v in got["rss"]) == want["rss"]


def test_loss_windows_give_the_tpu_record():
    rows = table.load_rows(os.path.join(REPO, "bench_results", "r05_canonical20k_metrics.jsonl"))
    got = table.loss_windows(rows, (1000, 5000, 10000, 20000))
    assert {c: round(v, 4) for c, v in got.items()} == \
        {1000: 1.0728, 5000: 1.0966, 10000: 1.0913, 20000: 1.1627}


def test_step_windows_and_second_run_on_the_tpu_records(capsys):
    """The step comparison on the TPU's two records of one seed: r04 ran
    bit-identically to r05 until its kill at 1221 and resume at 1200, after
    which JAX's fold_in of the step count gave it other keys; and r04's
    milestones as a second run beside the first."""
    r04 = os.path.join(REPO, "bench_results", "r04_canonical20k_metrics.jsonl")
    r05 = os.path.join(REPO, "bench_results", "r05_canonical20k_metrics.jsonl")
    steps = table.step_differences(table.load_rows(r04), table.load_rows(r05))
    assert set(steps) == set(table.STEP_SCALARS)
    for name, by_window in steps.items():
        assert list(by_window) == ["1-1", "2-10", "11-100", "101-1000", "1001-2000"], name
        assert [d["n"] for d in by_window.values()] == [1, 9, 90, 900, 1000], name
        for window in ("1-1", "2-10", "11-100", "101-1000"):
            assert by_window[window]["max"] == 0.0, (name, window)
        assert by_window["1001-2000"]["median"] > 0.0, name
    out = table.main(["--dataset", "pancreas", "--work", r05, "--compare", r04])
    assert out["second"]["port"] == table.summarize(table.load_rows(r04))
    assert out["steps"]["loss"]["1001-2000"]["max"] == 0.0  # r05 against itself
    shown = capsys.readouterr().out
    assert "second run" in shown and "|second run / TPU - 1| loss" in shown


# ---------------------------------------------------------------- (iii) the trees


@pytest.mark.parametrize("dataset", ["pancreas", "brats19"])
def test_canonical_trees_are_bit_equal(tmp_path, dataset):
    h5py = pytest.importorskip("h5py")
    from dycon_paper_replication_tpu.data import synthetic as jsynthetic

    tree = dict(driver.DATASETS[dataset]["tree"], n_train=2, n_test=0)
    jroot, troot = str(tmp_path / "jax"), str(tmp_path / "port")
    if dataset == "pancreas":
        jsynthetic.make_pancreas(jroot, **tree)
        synthetic.make_pancreas(troot, suffix=".npz", **tree)
        cases = [(os.path.join(jroot, "Pancreas_data", f"PANCREAS_{i:04d}.h5"),
                  os.path.join(troot, "Pancreas_data", f"PANCREAS_{i:04d}.npz")) for i in range(2)]
    else:
        jsynthetic.make_brats19(jroot, **tree)
        synthetic.make_brats19(troot, suffix=".npz", **tree)
        cases = [(os.path.join(jroot, "data", f"case_{i:03d}.h5"),
                  os.path.join(troot, "data", f"case_{i:03d}.npz")) for i in range(2)]
    for want_path, got_path in cases:
        with h5py.File(want_path) as f:
            want = {k: f[k][:] for k in ("image", "label")}
        got = dict(np.load(got_path))
        for k in want:
            assert got[k].dtype == want[k].dtype and got[k].shape == tree["shape"]
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{got_path} {k}")


# ---------------------------------------------------------------- (iv) the driver's refusals


def _fake_leg(**kw):
    base = dict(rc=0, killed=False, first_iter=1, last_iter=4, resumed_from=None,
                resumed_step=None, best_carried=None, t_start=0.0, t_end=1.0, wall_s=1.0,
                device_mem_mib=None)
    return lambda args, argv, log, kill_at=0: {**base, **kw}


@pytest.fixture()
def fake_run(tmp_path, monkeypatch):
    """A tiny tree and a run directory saved at 2 (best 0.3) and 4 (best
    0.5 logged at 4), with the legs themselves faked."""
    args = driver.parse_args(_tiny(tmp_path, "--leg", "resume"))
    driver.ensure_tree(args)
    snapshot = driver.snapshot_path(args)
    os.makedirs(snapshot)
    for name in ("iter_2.pt", "iter_2_dice_0.3.pt", "iter_4.pt"):
        open(os.path.join(snapshot, name), "w").close()
    with open(os.path.join(snapshot, "metrics.jsonl"), "w") as f:
        for step, best in ((2, 0.3), (4, 0.5), (6, 0.6)):  # 6: logged by a killed leg after it
            f.write(json.dumps({"t": 0.0, "tag": "info/Best_dice", "value": best,
                                "step": step}) + "\n")
    return lambda **kw: monkeypatch.setattr(driver, "run_leg", _fake_leg(**kw))


@pytest.mark.parametrize("case", ["unkilled_nonzero", "resumed_early", "resumed_late",
                                  "best_lost", "not_killed"])
def test_driver_refuses_a_broken_leg(tmp_path, fake_run, case):
    fake_run(**{"unkilled_nonzero": dict(rc=1, resumed_step=4, first_iter=5, best_carried=0.5),
                "resumed_early": dict(resumed_step=2, first_iter=3, best_carried=0.5),
                "resumed_late": dict(resumed_step=4, first_iter=6, best_carried=0.5),
                "best_lost": dict(resumed_step=4, first_iter=5, best_carried=0.3),
                "not_killed": dict(resumed_step=4, first_iter=5, best_carried=0.5)}[case])
    extra = ["--kill_at", "7"] if case == "not_killed" else []
    with pytest.raises(driver.RelayError):
        driver.main(_tiny(tmp_path, "--leg", "resume", *extra))
    with open(tmp_path / "work" / "relay.jsonl") as f:
        assert len(f.readlines()) == 1  # the broken leg is recorded, then the driver stops


def test_driver_passes_the_same_legs_done_right(tmp_path, fake_run):
    fake_run(resumed_step=4, first_iter=5, last_iter=9, best_carried=0.5)
    line = driver.main(_tiny(tmp_path, "--leg", "resume"))
    assert line["last_save_before"] == 4 and line["best_before"] == 0.5
    fake_run(rc=-9, killed=True, resumed_step=4, first_iter=5, last_iter=8, best_carried=0.5)
    assert driver.main(_tiny(tmp_path, "--leg", "resume", "--kill_at", "7"))["killed"]


def test_driver_exits_nonzero_on_a_broken_leg(tmp_path):
    """The script itself (no fakes): a resume with nothing to resume from."""
    proc = subprocess.run([sys.executable, os.path.join(REPO, "scripts", "canonical_run_torch.py"),
                           *_tiny(tmp_path, "--leg", "resume")], capture_output=True, text=True,
                          cwd=REPO)
    assert proc.returncode == 1 and "no checkpoint" in proc.stderr


def test_driver_and_summariser_import_nothing_of_jax():
    """Both scripts import without JAX, the JAX package or its scripts, and
    name none of them in an import."""
    code = (
        "import importlib.util, sys\n"
        "for m in ('jax', 'jaxlib', 'h5py', 'orbax', 'optax', 'dycon_paper_replication_tpu',\n"
        "          'summarize_canon20k'):\n"
        "    sys.modules[m] = None\n"
        "for name in ('canonical_run_torch', 'canonical_table_torch'):\n"
        "    spec = importlib.util.spec_from_file_location(name, f'scripts/{name}.py')\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "assert not any(k.startswith('jax') and v is not None for k, v in sys.modules.items())\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
    for name in ("canonical_run_torch", "canonical_table_torch"):
        with open(os.path.join(REPO, "scripts", f"{name}.py")) as f:
            text = f.read()
        for needle in ("dycon_paper_replication_tpu.", "import jax", "from jax",
                       "import summarize_canon20k", "from summarize_canon20k"):
            assert needle not in text, f"{name}: {needle}"
    assert driver.build_parser().parse_args(["--leg", "fresh"]).device == "cuda"
