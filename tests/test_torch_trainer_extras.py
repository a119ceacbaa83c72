"""The rest of the port's trainer against the JAX package's, on the CPU.

  * ops/bits.py: packbits_le / unpackbits_le exact against JAX at last-axis
    lengths 1, 7, 8, 13 and 96;
  * ops/metrics.py:compute_hd95_batch within 1e-9 of JAX, empty masks on
    either side included;
  * utils/monitor.py:similarity_histograms against JAX at N 96 (tile N),
    512 (tile 512) and 2352 (tile N), B 2, D 16: equal totals (B N^2), edges
    within 1e-5 relative, and each bin within the number of pair
    similarities that lie within 1e-5 x (hi - lo) of a bin edge (counted in
    float64), the bound of chip_smoke.py's monitor phase: the two packages'
    float32 dot products may bin such a pair on either side;
  * utils/profiling.py: StepTimer.stats on one mocked clock; trace()
    writes a Chrome trace of the block;
  * the step's diagnostic outputs against the JAX step's on
    tests/test_torch_train_step.py's first-step case: mask_con exact, the
    embedding within rtol 1e-4, atol 1e-5 (that file's tolerance for values
    computed by a forward), pred_fg exact wherever the student's
    foreground probability is more than 1e-6 from 0.5;
  * the trainer: its flags (brats19, deterministic 0/1, host_rss_exit_gb,
    data_parallel, and step_diagnostics, fetch_ahead, remat and wire_dtype
    with the JAX parser's defaults and choices; gpu_id, gpu_ids, use_ddp and
    a negative data_parallel refused); train-HD95 scored on its worker thread
    while the loop goes on, each score logged at its own iteration and equal
    to the score of that step's mask; a NaN step advances neither the
    iteration nor the cadence; deterministic=1 turns torch.use_deterministic_algorithms on,
    deterministic=0 draws and logs a seed, turns cudnn.benchmark on and the
    mode off, deterministic=1 after it keeps the configured seed and turns
    benchmark off and the mode on; resolve_device sets
    CUBLAS_WORKSPACE_CONFIG unless the user did, and the deterministic
    trainer's cuBLAS check refuses a nondeterministic or late value; the
    code snapshot holds the package without the
    kernel build directory; the host-RSS watchdog saves a resumable
    checkpoint and stops (at fetch_ahead 1 after draining the step queued
    behind the watchdog's iteration, as the JAX trainer does).
"""

import json
import os
import shutil
import threading
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dycon_paper_replication_tpu import config as jconfig
from dycon_paper_replication_tpu.models.factory import Model
from dycon_paper_replication_tpu.models.unet3d import UNet3DConfig as JaxNetConfig
from dycon_paper_replication_tpu.models.unet3d import init_unet3d, unet3d_apply
from dycon_paper_replication_tpu.ops import bits as jbits
from dycon_paper_replication_tpu.ops import metrics as jmetrics
from dycon_paper_replication_tpu.train.state import create_train_state, make_optimizer
from dycon_paper_replication_tpu.train.step import StepScalars as JaxScalars
from dycon_paper_replication_tpu.train.step import build_train_step as jax_build_train_step
from dycon_paper_replication_tpu.utils import monitor as jmonitor
from dycon_paper_replication_tpu.utils import profiling as jprofiling
from dycon_paper_replication_tpu_torch import config as tconfig
from dycon_paper_replication_tpu_torch import weights
from dycon_paper_replication_tpu_torch.data.synthetic import make_pancreas
from dycon_paper_replication_tpu_torch.models import UNet3DConfig
from dycon_paper_replication_tpu_torch.ops import bits, metrics
from dycon_paper_replication_tpu_torch.train import trainer as ttrainer
from dycon_paper_replication_tpu_torch.train.step import StepScalars, build_train_step
from dycon_paper_replication_tpu_torch.utils import checkpoint, monitor, profiling
from test_torch_train_step import B, LBS, PATCH, _batch, _np, _words

torch.set_num_threads(1)


@pytest.mark.parametrize("n", [1, 7, 8, 13, 96])
def test_packbits_matches_jax(rng, n):
    x = rng.integers(0, 2, size=(2, 3, n)).astype(np.float32)
    want = np.asarray(jbits.packbits_le(jnp.asarray(x)))
    for t in (torch.from_numpy(x), torch.from_numpy(x).bool(), torch.from_numpy(x).to(torch.uint8)):
        got = bits.packbits_le(t).numpy()
        assert got.dtype == np.uint8 and got.shape == (2, 3, -(-n // 8))
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(bits.unpackbits_le(want, n), jbits.unpackbits_le(want, n))
    np.testing.assert_array_equal(bits.unpackbits_le(want, n), x.astype(np.uint8))


def test_hd95_batch_matches_jax(rng):
    shape = (12, 10, 8)
    pred = (rng.random((5, *shape)) > 0.8).astype(np.uint8)
    target = (rng.random((5, *shape)) > 0.7).astype(np.int32)
    pred[1] = 0  # empty prediction
    target[2] = 0  # empty label
    pred[3], target[3] = 0, 0  # both
    max_dist = float(np.linalg.norm(shape))
    got = metrics.compute_hd95_batch(pred, target, max_dist)
    want = jmetrics.compute_hd95_batch(pred, target, max_dist)
    assert len(got) == 5 and got[1] == got[2] == got[3] == max_dist
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)


def near_edge_pairs(feat: np.ndarray, lo: float, hi: float, tau: float = 0.6) -> int:
    """Pairs whose similarity / tau lies within 1e-5 x (hi - lo) of one of
    the 51 edges of [lo, hi], in float64."""
    f = feat.astype(np.float64)
    frac = (np.einsum("bcd,bnd->bcn", f, f) / tau - lo) / (hi - lo) * monitor.BINS
    return int((np.abs(frac - np.round(frac)) * (hi - lo) / monitor.BINS
                <= 1e-5 * (hi - lo)).sum())


@pytest.mark.parametrize("n", [96, 512, 2352])
def test_similarity_histograms_match_jax(rng, n):
    feat = rng.normal(size=(2, n, 16)).astype(np.float32)
    feat += 0.5 * (rng.random((2, n, 1)) > 0.6)  # two loose clusters
    feat /= np.linalg.norm(feat, axis=-1, keepdims=True)
    mask = (rng.random((2, n)) > 0.6).astype(np.float32)
    jpos, jneg, jedges = (np.asarray(a) for a in
                          jmonitor.similarity_histograms(jnp.asarray(feat), jnp.asarray(mask)))
    pos, neg, edges = (t.numpy() for t in monitor.similarity_histograms(
        torch.from_numpy(feat), torch.from_numpy(mask)))
    assert pos.shape == neg.shape == (50,) and edges.shape == (51,)
    assert pos.sum() + neg.sum() == jpos.sum() + jneg.sum() == 2 * n * n
    assert np.abs(edges - jedges).max() <= 1e-5 * np.abs(jedges).max()
    near = near_edge_pairs(feat, float(jedges[0]), float(jedges[-1]))
    assert np.abs(pos - jpos).max() <= near and np.abs(neg - jneg).max() <= near
    # positive pairs by class equality, as JAX counts them
    assert pos.sum() == jpos.sum()


def test_monitor_writes_png_where_matplotlib_is(tmp_path, rng):
    feat = torch.nn.functional.normalize(torch.from_numpy(rng.normal(size=(1, 64, 8))), dim=-1)
    mask = torch.from_numpy((rng.random((1, 64)) > 0.5).astype(np.float32))
    out = monitor.monitor_similarity_distributions(feat, mask, 200, str(tmp_path / "sim"))
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        assert out is None
    else:
        assert out == str(tmp_path / "sim" / "epoch_200_similarity_distributions.png")
        assert os.path.isfile(out)


def test_step_timer_matches_jax():
    clock = [0.0, 0.011, 0.02, 0.035, 0.05, 0.052, 0.06, 0.09, 0.1, 0.1004]
    timers = {}
    for name, mod in (("jax", jprofiling), ("port", profiling)):
        ticks = iter(clock)
        with mock.patch.object(mod.time, "perf_counter", lambda: next(ticks)):
            timer = mod.StepTimer(window=3)
            for _ in range(len(clock) // 2 - 1):
                timer.start()
                timer.stop()
            t = timer.start()
            assert timer.stop(start=t) == pytest.approx(clock[-1] - clock[-2])
        timers[name] = timer.stats()
    assert timers["port"].keys() == timers["jax"].keys() == {"steps_per_sec", "step_ms_p50",
                                                             "step_ms_p95"}
    for k, v in timers["jax"].items():
        assert timers["port"][k] == pytest.approx(v, rel=1e-12)
    assert profiling.StepTimer().stats() == {}


def test_trace_writes_a_chrome_trace(tmp_path):
    x = torch.ones(64, 64)
    with profiling.trace(str(tmp_path / "trace")) as prof:
        (x @ x).sum()
    events = json.load(open(tmp_path / "trace" / "trace.json"))["traceEvents"]
    assert any("aten::mm" in e.get("name", "") for e in events)
    assert any(e.key == "aten::mm" for e in prof.key_averages())


@pytest.fixture(scope="module")
def diag_case():
    """The JAX step with its diagnostics, and the port step's outputs, on
    test_torch_train_step.py's first-step case."""
    net_cfg = JaxNetConfig(dropout_rate=0.0, layout="folded")
    model = Model(net_cfg, init_unet3d, unet3d_apply)
    cfg = jconfig.make_config("pancreas", patch_size=PATCH, batch_size=B, labeled_bs=LBS)
    optimizer = make_optimizer(lambda step: cfg.base_lr, cfg.momentum, cfg.weight_decay,
                               cfg.grad_clip_norm)
    js0 = _np(create_train_state(model, jax.random.key(11), optimizer))
    batch, key = _batch(1), jax.random.key(21)
    scalars = (5.0, 0.1 * np.exp(-5.0), 1.3, 0.3)
    step = jax.jit(jax_build_train_step(model, optimizer, cfg, diagnostics=True))
    _, jm = step(js0, {k: jnp.asarray(v) for k, v in batch.items()}, key,
                 JaxScalars.make(*scalars))

    tcfg = tconfig.make_config("pancreas", patch_size=PATCH, batch_size=B, labeled_bs=LBS,
                               device="cpu")
    port_step = build_train_step(tcfg, lambda step: tcfg.base_lr)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    cfg_net = UNet3DConfig(dropout_rate=0.0, layout="folded")
    with torch.no_grad():  # the student's foreground probability in the step's forward
        student = weights.jax_train_state_to_torch(js0, cfg_net).student.train()
        out = {"p_fg": torch.softmax(student(tbatch["image"])[1], -1)[..., 1]}
    port = weights.jax_train_state_to_torch(js0, cfg_net)
    out["step"] = port_step(port, tbatch, _words(key), StepScalars(*scalars))
    return dict(jax=jm, port=out, label=batch["label"])


def test_step_diagnostics_match_jax(diag_case):
    jm = diag_case["jax"]
    _, diag = diag_case["port"]["step"]
    assert diag.keys() == {"pred_fg", "embedding", "mask_con"}
    np.testing.assert_array_equal(diag["mask_con"].numpy(), np.asarray(jm["mask_con"]))
    emb = diag["embedding"]
    assert not emb.requires_grad and emb.shape == (B, 4 * 4 * 2, 256) == jm["embedding"].shape
    np.testing.assert_allclose(emb.numpy(), np.asarray(jm["embedding"]), rtol=1e-4, atol=1e-5)
    want = jbits.unpackbits_le(np.asarray(jm["pred_fg_bits"]), PATCH[-1])
    got = diag["pred_fg"].numpy()
    assert got.dtype == np.uint8 and got.shape == want.shape == (B, *PATCH)
    clear = (diag_case["port"]["p_fg"] - 0.5).abs().numpy() > 1e-6
    assert clear.mean() > 0.99
    np.testing.assert_array_equal(got[clear], want[clear])


def _argv(tmp_path, *extra):
    root = tmp_path / "Pancreas"
    if not root.exists():
        make_pancreas(str(root), n_train=4, n_test=1, shape=(24, 24, 20), seed=2, suffix=".npz")
    return ["--root_dir", str(root), "--snapshot_root", str(tmp_path / "runs"), "--device", "cpu",
            "--patch_size", "16", "16", "16", "--batch_size", "2", "--labeled_bs", "1",
            "--labelnum", "2", *extra]


def test_trainer_flags():
    cfg = tconfig.config_from_args("brats19", ["--deterministic", "0", "--host_rss_exit_gb", "8"])
    assert (cfg.dataset, cfg.patch_size, cfg.labelnum, cfg.fecl_chunk, cfg.feature_scaler) == (
        "brats19", (96, 96, 96), 25, 0, 2)
    assert (cfg.deterministic, cfg.host_rss_exit_gb) == (0, 8.0)
    default = tconfig.config_from_args("brats19", [])
    assert (default.deterministic, default.host_rss_exit_gb) == (1, 100.0)
    jax_default = jconfig.config_from_args("brats19", [])
    host_loop = ("fetch_ahead", "step_diagnostics", "remat", "wire_dtype")
    assert [getattr(default, k) for k in host_loop] == [getattr(jax_default, k) for k in host_loop] \
        == [1, "cadence", "none", "auto"]
    argv = ["--fetch_ahead", "0", "--step_diagnostics", "always", "--remat", "full",
            "--wire_dtype", "float16"]
    assert [getattr(tconfig.config_from_args("brats19", argv), k) for k in host_loop] == \
        [getattr(jconfig.config_from_args("brats19", argv), k) for k in host_loop]
    for bad in (["--deterministic", "2"], ["--step_diagnostics", "never"],
                ["--fetch_ahead", "2"], ["--remat", "half"], ["--wire_dtype", "bfloat16"],
                ["--gpu_id", "0"], ["--gpu_ids", "0,1"], ["--use_ddp", "1"],
                ["--data_parallel", "-1"]):
        with pytest.raises(SystemExit):
            tconfig.config_from_args("brats19", bad)
    assert tconfig.config_from_args("brats19", ["--data_parallel", "1"]).data_parallel == 1


def test_train_hd95_runs_beside_the_loop(tmp_path, monkeypatch):
    """Train-HD95 is scored on the trainer's worker thread while the loop
    goes on: the first score waits until the third step has started, which
    a loop that waited for it would never reach (the wait would time out
    and fail the run). Each score is logged at its own iteration and equals
    the score of that step's mask against its labels."""
    argv = _argv(tmp_path, "--max_iterations", "4", "--val_every", "8", "--save_every", "100")
    trainer = ttrainer.Trainer(tconfig.config_from_args("pancreas", argv))
    score, seen, third_step = metrics.compute_hd95_batch, [], threading.Event()

    def held_score(pred, target, max_dist):
        seen.append((threading.current_thread().name, pred.copy(), target.copy(), max_dist))
        if len(seen) == 1:
            assert third_step.wait(timeout=120), "the loop waited for train-HD95"
        return score(pred, target, max_dist)

    monkeypatch.setattr(ttrainer.metrics, "compute_hd95_batch", held_score)
    calls = []

    def counting(step):
        def counting_step(*args):
            calls.append(1)
            if len(calls) == 3:
                third_step.set()
            return step(*args)
        return counting_step

    # the full step and the light one (step_diagnostics "cadence")
    trainer.train_step, trainer.train_step_light = map(
        counting, (trainer.train_step, trainer.train_step_light))
    trainer.run()
    assert trainer.hd95_every == 2 and len(calls) == 4
    assert [name.startswith("train-hd95") for name, *_ in seen] == [True] * 3
    records = [json.loads(line) for line in open(f"{trainer.snapshot_path}/metrics.jsonl")]
    hd95 = [(r["step"], r["value"]) for r in records if r["tag"] == "train/HD95"]
    assert [it for it, _ in hd95] == [1, 2, 4]
    for (_, value), (_, pred, target, max_dist) in zip(hd95, seen):
        assert max_dist == float(np.linalg.norm((16, 16, 16)))
        assert pred.dtype == np.uint8 and pred.shape == target.shape == (2, 16, 16, 16)
        assert value == float(np.mean(score(pred, target, max_dist)))
    # the loop went on past the first HD95 iteration: its score was logged
    # after a later step's loss
    order = [(r["tag"], r["step"]) for r in records]
    assert order.index(("train/HD95", 1)) > order.index(("info/loss", 2))


def test_nan_skip_advances_no_cadence(tmp_path):
    """A NaN step (the reference's `continue`) advances neither the
    iteration nor the HD95 cadence: the retry is iteration 2 again."""
    argv = _argv(tmp_path, "--max_iterations", "3", "--val_every", "8", "--save_every", "100")
    trainer = ttrainer.Trainer(tconfig.config_from_args("pancreas", argv))
    asked = []

    def second_call_nan(step):
        def nan_step(state, batch, gen, scalars):
            asked.append(int(state.step))
            if len(asked) == 2:
                scalars = scalars._replace(consistency_weight=float("nan"))
            return step(state, batch, gen, scalars)
        return nan_step

    # the full step and the light one (step_diagnostics "cadence")
    trainer.train_step, trainer.train_step_light = map(
        second_call_nan, (trainer.train_step, trainer.train_step_light))
    trainer.run()
    assert asked == [0, 1, 1, 2]
    assert trainer.state.step == 3
    records = [json.loads(line) for line in open(f"{trainer.snapshot_path}/metrics.jsonl")]
    assert [r["step"] for r in records if r["tag"] == "info/loss"] == [1, 2, 3]
    assert [r["step"] for r in records if r["tag"] == "train/HD95"] == [1, 2]
    assert "NaN or Inf found in loss at iteration 1" in open(
        f"{trainer.snapshot_path}/log.txt").read()


def test_deterministic_flag(tmp_path, monkeypatch):
    """deterministic=1 turns torch.use_deterministic_algorithms on;
    deterministic=0 draws a seed, turns cudnn.benchmark on and the mode off;
    a deterministic=1 trainer built after it in the same process keeps the
    configured seed, turns benchmark off, cudnn.deterministic on and the
    mode back on, in its error mode."""
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", False)
    mode = torch.are_deterministic_algorithms_enabled()
    warn = torch.is_deterministic_algorithms_warn_only_enabled()
    try:
        torch.use_deterministic_algorithms(False)
        first = ttrainer.Trainer(tconfig.config_from_args("pancreas", _argv(tmp_path)))
        first.log.close()
        assert first.cfg.seed == 1337 and torch.are_deterministic_algorithms_enabled()
        assert torch.backends.cudnn.deterministic and not torch.backends.cudnn.benchmark
        drawn = ttrainer.Trainer(tconfig.config_from_args(
            "pancreas", _argv(tmp_path, "--deterministic", "0")))
        drawn.log.close()
        assert drawn.cfg.deterministic == 0 and torch.backends.cudnn.benchmark
        assert not torch.backends.cudnn.deterministic
        assert not torch.are_deterministic_algorithms_enabled()
        log = open(os.path.join(drawn.snapshot_path, "log.txt")).read()
        assert f"deterministic=0: seed drawn from OS entropy -> {drawn.cfg.seed}" in log
        assert json.load(open(os.path.join(drawn.snapshot_path, "config.json")))["seed"] == str(
            drawn.cfg.seed)
        assert drawn.cfg.seed != 1337  # 2^-32 odds of a false failure
        kept = ttrainer.Trainer(tconfig.config_from_args("pancreas", _argv(tmp_path)))
        kept.log.close()
        assert kept.cfg.seed == 1337 and not torch.backends.cudnn.benchmark
        assert torch.backends.cudnn.deterministic
        assert torch.are_deterministic_algorithms_enabled()
        assert not torch.is_deterministic_algorithms_warn_only_enabled()
    finally:
        torch.use_deterministic_algorithms(mode, warn_only=warn)


@pytest.mark.parametrize("preset,cuda_started,want,late", [
    (None, False, ":4096:8", False),  # set before CUDA starts: deterministic
    (":16:8", False, ":16:8", False),  # a deterministic value of the user's, kept
    (":0:0", False, ":0:0", False),  # another of the user's: kept, refused at deterministic=1
    (None, True, ":4096:8", True),  # set after CUDA started: refused at deterministic=1
])
def test_cublas_workspace_config(monkeypatch, preset, cuda_started, want, late):
    """resolve_device sets CUBLAS_WORKSPACE_CONFIG to :4096:8 unless the
    user set it, whose value it keeps; require_deterministic_cublas (the
    deterministic=1 trainer's check on CUDA) refuses a value that is not
    deterministic, and one set after CUDA had started. The environment
    logic alone, with no CUDA: torch.cuda.is_initialized is stubbed."""
    if preset is None:
        monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG", raising=False)
    else:
        monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", preset)
    monkeypatch.setattr(tconfig, "_cublas_set_late", False)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: cuda_started)
    assert tconfig.resolve_device("cpu") == torch.device("cpu")
    assert os.environ["CUBLAS_WORKSPACE_CONFIG"] == want
    assert tconfig._cublas_set_late == late
    if want in tconfig.CUBLAS_DETERMINISTIC and not late:
        tconfig.require_deterministic_cublas()
    else:
        with pytest.raises(RuntimeError, match="CUBLAS_WORKSPACE_CONFIG"):
            tconfig.require_deterministic_cublas()
    env = {"CUBLAS_WORKSPACE_CONFIG": ":16:8"}
    assert not tconfig.set_cublas_workspace(env, cuda_started=True)
    assert env == {"CUBLAS_WORKSPACE_CONFIG": ":16:8"}


def test_code_snapshot_leaves_out_the_build(tmp_path):
    trainer = ttrainer.Trainer(tconfig.config_from_args("pancreas", _argv(tmp_path)))
    trainer.log.close()
    code = os.path.join(trainer.snapshot_path, "code")
    for rel in ("train/trainer.py", "ops/_build.py", "ops/csrc/folded_conv3.cu", "weights.py"):
        assert os.path.isfile(os.path.join(code, rel)), rel
    # a package with built kernels and caches: neither is copied
    pkg = tmp_path / "pkg"
    shutil.copytree(os.path.dirname(ttrainer.__file__) + "/..", pkg,
                    ignore=shutil.ignore_patterns("__pycache__", "_build"))
    (pkg / "ops" / "_build" / "abc").mkdir(parents=True)
    (pkg / "ops" / "_build" / "abc" / "libk1.so").write_bytes(b"\0")
    (pkg / "__pycache__").mkdir()
    (pkg / "__pycache__" / "config.cpython-312.pyc").write_bytes(b"\0")
    ttrainer.copy_package(str(tmp_path / "copy"), str(pkg))
    files = {os.path.relpath(os.path.join(d, f), tmp_path / "copy")
             for d, _, fs in os.walk(tmp_path / "copy") for f in fs}
    assert "ops/_build.py" in files and "train/trainer.py" in files
    assert not any(f.endswith((".so", ".pyc")) or f.startswith("ops/_build/") for f in files)


def test_rss_watchdog_saves_and_stops(tmp_path, monkeypatch):
    """The watchdog fires at iteration 20; at fetch_ahead 1 step 21 is
    already queued then, and is drained before the save (the JAX trainer's
    schedule)."""
    monkeypatch.setattr(ttrainer, "_host_rss_gb", lambda: 1e9)
    for fetch_ahead in (0, 1):
        want = ttrainer.RSS_EVERY + fetch_ahead
        argv = _argv(tmp_path / f"fetch_ahead{fetch_ahead}", "--max_iterations", "30",
                     "--val_every", "100", "--save_every", "1000", "--fetch_ahead",
                     str(fetch_ahead), "--host_rss_exit_gb", "100")
        trainer = ttrainer.Trainer(tconfig.config_from_args("pancreas", argv))
        trainer.run()
        assert trainer.state.step == want and ttrainer.RSS_EVERY == 20
        path, _ = checkpoint.latest_checkpoint_path(trainer.snapshot_path, "unet_3D")
        assert path == checkpoint.iter_checkpoint_path(trainer.snapshot_path, want)
        log = open(os.path.join(trainer.snapshot_path, "log.txt")).read()
        assert f"Host RSS 1000000000.0 GB >= host_rss_exit_gb 100 at iteration {want}" in log
        resumed = ttrainer.Trainer(tconfig.config_from_args(
            "pancreas", argv[:-2] + ["--host_rss_exit_gb", "0", "--resume", "auto"]))
        resumed.log.close()
        assert resumed.state.step == want
