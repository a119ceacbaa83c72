"""The DyCON trainer: Pancreas, BraTS-2019 and ISLES-2022.

Counterpart of dycon_paper_replication_tpu/train/trainer.py on one device:
  * the data: the train split (Pancreas, BraTS in axial view, or ISLES with
    labelnum counted in patients, ISLES_PATIENTS_TO_SLICES), random crop +
    rot/flip, the two-stream sampler (the labeled cases first) and the
    prefetching loader;
  * the host schedules: per epoch beta and the FeCL focal thresholds, per
    iteration the consistency weight;
  * the model by `model` (unet_3D, with ASPP under `use_aspp`, or vnet),
    student and teacher of the same build, computing in `compute_dtype`
    (float32 or bfloat16, with float32 parameters, heads and losses and no
    loss scaling, as in the JAX trainer; the validation runs the student
    itself, so in the same dtype); the step (train/step.py) on the
    device, with no host read inside it, timed by a StepTimer from its
    dispatch to the read of its scalars;
  * the JAX trainer's pipelined host loop (`fetch_ahead` 1, the default):
    iteration N+1 is queued before iteration N's scalars are read, from a
    pinned host buffer after the event of their non-blocking copy, so the
    host's logging and the next batch's hand-over overlap the card's step.
    Iterations that must be seen in sync are read at once: the monitor's,
    train-HD95's, the first, validation, save and the last, and the budget
    and watchdog exits drain the pending one first. The sync decision is
    made after the pending read, from the true index. Its two deviations
    after a NaN skip are JAX's: the step already queued used a consistency
    weight computed one iteration ahead, and one train-HD95 or monitor
    sample may be dropped (that step was queued as the light step).
    `fetch_ahead` 0 reads every step's scalars before the next is queued.
    `step_diagnostics` "cadence" (the default) queues the light step
    (train/step.py, diagnostics=False) off the train-HD95 and monitor
    iterations, picked from the index the step lands on if no queued step
    is skipped (JAX's `presumed`); "always" queues the full one;
  * the batches from the loader's pinned ring on CUDA, in `wire_dtype`
    (data/pipeline.py), a data-parallel rank's rows only;
  * train-HD95 every `hd95_every = max(val_every // 4, 1)` iterations and at
    the first, over the whole batch against its labels (max_dist = the
    patch diagonal for an empty mask): the step's foreground mask is copied
    to the host and scored on one worker thread while the loop goes on, and
    each train/HD95 scalar is logged at its own iteration once it is done
    (all of them before the run returns); the similarity monitor every 200
    iterations into <snapshot>/<exp>_similarity;
  * validation every `val_every` iterations, with the student in eval mode
    and no gradient: Pancreas and BraTS through the sliding window at
    val_stride_xy / val_stride_z (Pancreas over test1.list, BraTS over
    val.txt in axial view), ISLES by one whole-volume forward per val.list
    case, argmaxing the SDF head as the reference does; a better Dice saves
    iter_<N>_dice_<D> and the best model, each a full train state; the
    StepTimer's perf/* scalars and perf/host_rss_gb are logged there;
  * a full-state save every `save_every` iterations, `resume` ("", "auto"
    or a path), and two clean, resumable stops: `time_budget_s`, and the
    host-RSS watchdog (every 20 iterations, `host_rss_exit_gb`);
  * a copy of the port's package in <snapshot>/code (without the kernel
    build directory);
  * `deterministic=1` (the default): the configured seed, cudnn.benchmark
    off, cudnn.deterministic on and torch.use_deterministic_algorithms(True)
    in its error mode, and on CUDA a deterministic CUBLAS_WORKSPACE_CONFIG
    (config.require_deterministic_cublas), so that reruns are bit-identical
    on the card as they are in the JAX package; an op with no deterministic
    implementation raises. `deterministic=0`: a seed drawn from the OS,
    logged, with cudnn.benchmark on, cudnn.deterministic off and the mode
    off, as the reference's flag did. All three are process-wide and set on
    both branches.
A NaN/Inf step is skipped as the reference's `continue`: it advances
neither the iteration count nor any cadence.

Data parallelism (`train`, the CLIs' entry: `--data_parallel N` spawns N
ranks, a process under torchrun joins as one; parallel/mesh.py): every rank
builds the same replicas from the seed (a `deterministic=0` seed is drawn
by rank 0 and broadcast), reads the same global batches and keeps its rows,
and runs the data-parallel step (train/step.py), which computes the global
step. An explicit N > 1 first applies the JAX trainer's multi-device rules
(`_apply_multi_device_rules`: batch_size and labeled_bs rounded down to
multiples of N, the learning rate times N); with 0 the rank count is every
visible device clamped to divide the batch, and the config is kept. Rank 0
alone logs, writes config.json and the code snapshot, validates (in one
process, with the auto volume group on CUDA), runs train-HD95 and the
monitor (on the global batch's rows and labels, gathered from the ranks on
their iterations) and saves; the ranks take the same fetch_ahead schedule,
since they see the same global scalars; every rank resumes from the same
checkpoint, and a stop (time budget, host RSS on any rank) is agreed on by
all ranks.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import os
import shutil
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .. import parallel, weights
from ..config import TrainConfig, require_deterministic_cublas, resolve_device
from ..data import (
    BatchLoader,
    BraTS2019,
    Compose,
    ISLESDataset,
    Pancreas,
    RandomRotFlip,
    ToArray,
    TwoStreamBatchSampler,
)
from ..data.datasets import brats_case_paths
from ..eval import (
    SlidingWindowInference,
    WholeVolumeInference,
    auto_group,
    iter_volumes,
    var_all_case,
    var_all_case_wholevolume,
)
from ..models import build_model, model_config
from ..ops import metrics, ramps
from ..utils import checkpoint
from ..utils.logging import ExperimentLogger
from ..utils.monitor import monitor_similarity_distributions
from ..utils.profiling import StepTimer
from .state import create_train_state
from .step import SCALAR_METRICS, StepScalars, build_train_step

# ISLES-2022 labelnum (patients) -> number of labeled training volumes
# (the reference's train_DyCON_ISLES22.py)
ISLES_PATIENTS_TO_SLICES = {
    1: 36, 2: 38, 3: 27, 4: 53, 5: 60, 6: 25, 7: 25, 8: 38, 9: 38, 10: 45,
    11: 27, 12: 29, 13: 32, 14: 29, 15: 44, 16: 38, 17: 29, 18: 23, 19: 48,
    20: 42, 21: 31, 22: 48, 23: 42, 24: 23, 25: 29,
}
DATASETS = ("pancreas", "brats19", "isles22")
MONITOR_EVERY = 200
RSS_EVERY = 20
_PAGE_GB = os.sysconf("SC_PAGE_SIZE") / 1024 ** 3 if hasattr(os, "sysconf") else 0.0


def copy_package(dst: str, src: str = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
                 ) -> None:
    """Copy the package at `src` (the port's) to `dst`, without caches and
    the kernel build directory (ops/_build)."""
    shutil.copytree(src, dst, ignore=shutil.ignore_patterns("__pycache__", "*.pyc", "_build"))


def _host_rss_gb() -> float:
    """This process's resident set in GB (0.0 where /proc is absent)."""
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * _PAGE_GB
    except (OSError, ValueError, IndexError):
        return 0.0


class _Quiet:
    """The logger of a rank other than 0: it writes nothing."""

    def info(self, *args) -> None:
        pass

    scalar = scalars = close = info


class Trainer:
    shard: parallel.Shard | None = None  # this rank's part of a data-parallel run
    lead = True  # rank 0, or a run in one process

    def __init__(self, cfg: TrainConfig, rank: int | None = None, world: int = 1):
        """`rank` and `world`: this process's place in a data-parallel run
        whose process group is up (parallel.launch or torchrun); None for a
        run in one process."""
        if cfg.dataset not in DATASETS:
            raise ValueError(f"dataset {cfg.dataset!r} is not one of {DATASETS}")
        self.device = resolve_device(cfg.device)
        notes = []
        if rank is not None and cfg.data_parallel > 1:
            cfg, notes = self._apply_multi_device_rules(cfg, world)
        self.shard = None if rank is None else parallel.Shard(rank, world, cfg.batch_size,
                                                               cfg.labeled_bs)
        self.lead = rank in (None, 0)
        if self.shard is not None and (cfg.batch_size % world or cfg.labeled_bs % world):
            raise ValueError(f"batch_size={cfg.batch_size} / labeled_bs={cfg.labeled_bs} do "
                             f"not divide over {world} ranks")
        if not cfg.deterministic:
            # the reference's deterministic=0 turns on cudnn.benchmark and
            # gives up reproducibility; the run's seed comes from the OS
            seed = int.from_bytes(os.urandom(4), "little")
            if self.shard is not None:  # rank 0's seed for every replica
                shared = torch.tensor([seed], device=self.device)
                torch.distributed.broadcast(shared, 0)
                seed = int(shared.item())
            notes.append(f"deterministic=0: seed drawn from OS entropy -> {seed}; "
                         "cudnn.benchmark on")
            cfg = dataclasses.replace(cfg, seed=seed)
        # process-wide: set on both branches, so that a deterministic run
        # after a deterministic=0 one in the same process is deterministic
        torch.backends.cudnn.benchmark = not cfg.deterministic
        torch.backends.cudnn.deterministic = bool(cfg.deterministic)
        torch.use_deterministic_algorithms(bool(cfg.deterministic))
        if cfg.deterministic and self.device.type == "cuda":
            require_deterministic_cublas()
        self.cfg = cfg
        self.snapshot_path = cfg.snapshot_path()
        self.log = _Quiet()
        if self.lead:
            os.makedirs(self.snapshot_path, exist_ok=True)
            self.log = ExperimentLogger(self.snapshot_path)
            for note in notes:
                self.log.info(note)
            self.log.info(str(dataclasses.asdict(cfg)))
            with open(os.path.join(self.snapshot_path, "config.json"), "w") as f:
                json.dump({k: str(v) for k, v in dataclasses.asdict(cfg).items()}, f, indent=2)
            code = os.path.join(self.snapshot_path, "code")  # the reference copies its code
            if not os.path.exists(code):
                copy_package(code)

        net_cfg = model_config(cfg.model, in_chns=cfg.in_ch, class_num=cfg.num_classes,
                               scaler=cfg.feature_scaler, use_aspp=cfg.use_aspp,
                               layout=cfg.resolved_layout(self.device),
                               compute_dtype=cfg.torch_compute_dtype())
        params, state = weights.init_jax_tree(net_cfg, seed=cfg.seed)
        student = build_model(net_cfg).to(self.device)
        student.load_state_dict(weights.jax_tree_to_state_dict(params, state))
        self.state = create_train_state(student)
        self.best_performance = 0.0
        if cfg.resume:
            if cfg.resume == "auto":
                path, self.best_performance = checkpoint.latest_checkpoint_path(
                    self.snapshot_path, cfg.model)
            else:
                path = cfg.resume
            checkpoint.restore_train_state(path, self.state)
            self.log.info("Resumed full train state from %s (step %d, best-so-far %.4f)",
                          path, self.state.step, self.best_performance)
        if self.shard is not None:  # rank 0's replicas on every rank
            parallel.replicate(self.state.student)
            parallel.replicate(self.state.teacher)

        if cfg.lr_schedule == "poly":
            # of the step's device step count: float32 on the device, as JAX traces it
            schedule = lambda step: ramps.poly_lr(cfg.base_lr, step, cfg.max_iterations)  # noqa: E731
        else:
            schedule = lambda step: cfg.base_lr  # noqa: E731
        self.train_step = build_train_step(cfg, schedule, self.shard)
        self.train_step_light = (build_train_step(cfg, schedule, self.shard, diagnostics=False)
                                 if cfg.step_diagnostics == "cadence" else self.train_step)
        self.timer = StepTimer()
        self.hd95_every = max(cfg.val_every // 4, 1)
        self._build_data()
        if cfg.dataset == "isles22":
            self.whole_volume = WholeVolumeInference(self.state.student, cfg.patch_size,
                                                     head="sdf")
            self.sw = None
        else:
            self.whole_volume = None
            self.sw = SlidingWindowInference(self.state.student, cfg.patch_size,
                                             cfg.val_stride_xy, cfg.val_stride_z)

    @staticmethod
    def _apply_multi_device_rules(cfg: TrainConfig, n_dev: int) -> tuple[TrainConfig, list[str]]:
        """The reference's DataParallel adjustments, as the JAX trainer makes
        them: batch_size and labeled_bs rounded DOWN to multiples of the
        rank count and the learning rate scaled by it, with a note for each;
        a batch rounded to zero is an error."""
        notes: list[str] = []
        if n_dev <= 1:
            return cfg, notes
        bs = (cfg.batch_size // n_dev) * n_dev
        lbs = (cfg.labeled_bs // n_dev) * n_dev
        if bs == 0 or lbs == 0:
            raise ValueError(
                f"batch_size={cfg.batch_size} / labeled_bs={cfg.labeled_bs} "
                f"round to zero over {n_dev} devices; shrink data_parallel "
                "or grow the batch"
            )
        if bs != cfg.batch_size:
            notes.append(f"Adjusted total batch size from {cfg.batch_size} to {bs} "
                         f"to be divisible by {n_dev} devices")
        if lbs != cfg.labeled_bs:
            notes.append(f"Adjusted labeled batch size from {cfg.labeled_bs} to {lbs} "
                         f"to be divisible by {n_dev} devices")
        lr = cfg.base_lr * n_dev
        notes.append(f"Scaled learning rate to {lr} for {n_dev} devices")
        return dataclasses.replace(cfg, batch_size=bs, labeled_bs=lbs, base_lr=lr), notes

    def _build_data(self) -> None:
        cfg = self.cfg
        transform = Compose([RandomRotFlip(), ToArray()])
        if cfg.dataset == "isles22":
            ds = ISLESDataset(cfg.root_dir, split="train", transform=transform,
                              crop_size=cfg.patch_size)
            labeled = ISLES_PATIENTS_TO_SLICES.get(cfg.labelnum, cfg.labelnum)
        elif cfg.dataset == "brats19":
            ds = BraTS2019(cfg.root_dir, split="train", transform=transform,
                           crop_size=cfg.patch_size)
            labeled = cfg.labelnum
        else:
            ds = Pancreas(cfg.root_dir, split="train", transform=transform,
                          crop_size=cfg.patch_size)
            labeled = cfg.labelnum
        if labeled >= len(ds):
            raise ValueError(f"labelnum {labeled} >= dataset size {len(ds)}")
        sampler = TwoStreamBatchSampler(range(labeled), range(labeled, len(ds)),
                                        cfg.batch_size, cfg.batch_size - cfg.labeled_bs,
                                        seed=cfg.seed)
        half = cfg.wire_dtype == "float16"  # "auto" is full width off a TPU, as in JAX
        self.loader = BatchLoader(ds, sampler, seed=cfg.seed, prefetch=cfg.num_prefetch,
                                  device=self.device,
                                  image_dtype=np.float16 if half else np.float32,
                                  label_dtype=np.uint8 if half else np.int32,
                                  rows=None if self.shard is None else self.shard.rows)
        self.iters_per_epoch = len(sampler)
        self.max_epoch = cfg.max_iterations // self.iters_per_epoch + 1
        self.log.info("%d Iterations per epoch", self.iters_per_epoch)

    def _epoch_scalars(self, epoch: int) -> tuple[float, float, float]:
        cfg = self.cfg
        beta = (cfg.s_beta if cfg.s_beta is not None
                else ramps.adaptive_beta(epoch, self.max_epoch, cfg.beta_max, cfg.beta_min))
        pos_th = ramps.threshold_rampup(epoch, cfg.fecl_rampup_epochs, 1.3, 1.5)
        neg_th = ramps.threshold_rampup(epoch, cfg.fecl_rampup_epochs, 0.3, 0.5)
        return beta, pos_th, neg_th

    def _consistency_weight(self, iter_num: int) -> float:
        cfg = self.cfg
        return cfg.consistency * ramps.sigmoid_rampup(iter_num // 150, cfg.consistency_rampup)

    def _val_volumes(self):
        cfg = self.cfg
        if cfg.dataset == "isles22":
            return iter_volumes(ISLESDataset(cfg.root_dir, split="val").paths, label_key="mask")
        if cfg.dataset == "brats19":
            with open(os.path.join(cfg.root_dir, "val.txt")) as f:
                names = [line.strip() for line in f if line.strip()]
            return iter_volumes(brats_case_paths(cfg.root_dir, names), axial_transpose=True)
        # Pancreas: test1.list, as the reference, which fails when it is missing
        with open(os.path.join(cfg.root_dir, "test1.list")) as f:
            names = [line.strip() for line in f if line.strip()]
        return iter_volumes([os.path.join(cfg.root_dir, "Pancreas_data", n) for n in names])

    def validate(self) -> float:
        """Mean Dice of the student over the validation volumes, in volume
        groups of the auto size (as the JAX trainer groups them on its
        accelerator)."""
        student = self.state.student.eval()
        try:
            with torch.no_grad():
                if self.whole_volume is not None:
                    return var_all_case_wholevolume(
                        self.whole_volume, self._val_volumes(),
                        group=auto_group(self.device, "whole_volume", "validation"))
                return var_all_case(self.sw, self._val_volumes(),
                                    group=auto_group(self.device, "sliding_window",
                                                     "validation"))
        finally:
            student.train()

    def _save(self, path: str, iter_num: int) -> None:
        checkpoint.save_train_state(path, self.state,
                                    meta={"step": iter_num, "best_dice": self.best_performance})

    def _hd95_due(self, iter_num: int) -> bool:
        return iter_num % self.hd95_every == 0 or iter_num == 1

    def _diagnostics(self, diag: dict, label, iter_num: int, pool) -> None:
        """The similarity monitor, and train-HD95 handed to `pool`, on
        their iterations, from the outputs of a full step (a light step's
        `diag` is empty: its sample is dropped, as in JAX); in a
        data-parallel run over the global batch, its rows and `label`
        (this rank's, a tensor or an array) gathered from every rank to
        rank 0."""
        cfg = self.cfg
        monitor = iter_num % MONITOR_EVERY == 0 and "embedding" in diag
        hd95 = self._hd95_due(iter_num) and "pred_fg" in diag
        if self.shard is not None:
            keys = (["embedding", "mask_con"] if monitor else []) + (["pred_fg"] if hd95 else [])
            diag = {k: self.shard.gather_rows(diag[k]) for k in keys}
            if hd95:
                label = self.shard.gather_rows(torch.as_tensor(label, device=self.device))
            if not self.lead:
                return
        if monitor:
            monitor_similarity_distributions(
                diag["embedding"], diag["mask_con"], iter_num,
                os.path.join(self.snapshot_path, f"{cfg.exp}_similarity"))
        if hd95:
            max_dist = float(np.linalg.norm(cfg.patch_size))
            if torch.is_tensor(label):
                label = label.cpu().numpy()
            self._hd95_pending.append((iter_num, pool.submit(
                metrics.compute_hd95_batch, diag["pred_fg"].cpu().numpy(), label, max_dist)))

    def _log_hd95(self, wait: bool) -> None:
        """Log the finished train-HD95 scores in iteration order; with
        `wait`, all of them."""
        pending = self._hd95_pending
        while pending and (wait or pending[0][1].done()):
            iter_num, future = pending.popleft()
            self.log.scalar("train/HD95", float(np.mean(future.result())), iter_num)

    def _after_step(self, v: dict, scalars: StepScalars, iter_num: int) -> None:
        """Logging, validation and the periodic save after applied step
        `iter_num` (rank 0's work)."""
        cfg = self.cfg
        if not self.lead:
            return
        self.log.scalars({
            "info/loss": v["loss"], "info/f_loss": v["f_loss"], "info/u_loss": v["u_loss"],
            "info/loss_ce": v["loss_ce"], "info/loss_dice": v["loss_dice"],
            "info/consistency_loss": v["consistency_loss"],
            "info/consistency_weight": scalars.consistency_weight,
            "train/Dice": v["train_dice"],
        }, iter_num)
        self.log.info("Iteration %d : Loss : %f, Loss_CE: %f, Loss_Dice: %f, UnCLoss: %f, "
                      "FeCLoss: %f, mean_dice: %f", iter_num, v["loss"], v["loss_ce"],
                      v["loss_dice"], v["u_loss"], v["f_loss"], v["train_dice"])
        if iter_num % cfg.val_every == 0:
            avg = self.validate()
            if avg > self.best_performance:
                self.best_performance = round(float(avg), 4)
                self._save(checkpoint.iter_checkpoint_path(self.snapshot_path, iter_num,
                                                           self.best_performance), iter_num)
                self._save(checkpoint.best_checkpoint_path(self.snapshot_path, cfg.model),
                           iter_num)
            self.log.scalars({"info/Dice": float(avg), "info/Best_dice": self.best_performance},
                             iter_num)
            self.log.info("Iteration %d : Dice: %f Best_dice: %f", iter_num, float(avg),
                          self.best_performance)
            self.log.scalars({**{f"perf/{k}": x for k, x in self.timer.stats().items()},
                              "perf/host_rss_gb": _host_rss_gb()}, iter_num)
        if iter_num % cfg.save_every == 0:
            self._save(checkpoint.iter_checkpoint_path(self.snapshot_path, iter_num), iter_num)

    def _stop_reason(self, iter_num: int, t_start: float) -> str | None:
        """Why the run stops cleanly after applied step `iter_num`, if it does:
        the time budget, or the host-RSS watchdog every RSS_EVERY iterations.
        Ranks agree: one that stops stops them all."""
        cfg = self.cfg
        reason = None
        if cfg.time_budget_s and time.monotonic() - t_start >= cfg.time_budget_s:
            reason = f"Time budget {cfg.time_budget_s:.0f}s exceeded"
        elif cfg.host_rss_exit_gb and iter_num % RSS_EVERY == 0:
            rss = _host_rss_gb()
            if rss >= cfg.host_rss_exit_gb:
                reason = f"Host RSS {rss:.1f} GB >= host_rss_exit_gb {cfg.host_rss_exit_gb:.0f}"
        if self.shard is not None and (cfg.time_budget_s or iter_num % RSS_EVERY == 0):
            flag = self.shard.all_sum_(torch.tensor([float(reason is not None)],
                                                    device=self.device))
            if flag.item() and reason is None:
                reason = "Another rank stopped"
        return reason

    def _on_diag_cadence(self, iter_num: int) -> bool:
        return iter_num % MONITOR_EVERY == 0 or self._hd95_due(iter_num)

    def _must_sync(self, iter_num: int) -> bool:
        """Whether applied step `iter_num` is read before the next step is
        queued (module doc)."""
        cfg = self.cfg
        return (not cfg.fetch_ahead or self._on_diag_cadence(iter_num)  # the first too
                or iter_num % cfg.val_every == 0 or iter_num % cfg.save_every == 0
                or iter_num >= cfg.max_iterations)

    def _fetch(self, vec: torch.Tensor):
        """Start the copy of a step's scalars to the host: on CUDA into a
        pinned buffer, non-blocking, with an event after it (the caching
        host allocator does not hand the buffer out again before that
        event); read by _read."""
        if vec.device.type != "cuda":
            return vec, None
        host = torch.empty(vec.shape, dtype=vec.dtype, pin_memory=True)
        host.copy_(vec, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host, done

    @staticmethod
    def _read(fetched) -> dict:
        host, done = fetched
        if done is not None:
            done.synchronize()
        return dict(zip(SCALAR_METRICS, host.tolist()))

    def _finish(self, fetched, diag: dict, label, scalars: StepScalars, t0: float,
                iter_num: int, pool) -> int:
        """The read half of one iteration: its scalars, the NaN skip, the
        diagnostics, logging, validation and the periodic save. Returns the
        new iteration count; sets self._stop at the last one."""
        v = self._read(fetched)
        self.timer.stop(start=t0)
        if v["skipped"]:
            # as the reference's `continue`: neither the step nor the
            # schedules and cadences advance
            self.log.info("NaN or Inf found in loss at iteration %d — skipped", iter_num)
            return iter_num
        iter_num += 1
        self._diagnostics(diag, label, iter_num, pool)
        self._log_hd95(wait=False)
        self._after_step(v, scalars, iter_num)
        if iter_num >= self.cfg.max_iterations:
            self._stop = True
        return iter_num

    def run(self) -> float:
        cfg = self.cfg
        t_start = time.monotonic()
        iter_num = int(self.state.step)  # nonzero after a resume
        generator = torch.Generator(device=self.device).manual_seed(
            (cfg.seed + 1) * 1_000_003 + iter_num)
        start_epoch = iter_num // self.iters_per_epoch
        last_epoch = None
        self._hd95_pending = collections.deque()
        self._stop = False
        light_ok = cfg.step_diagnostics == "cadence"
        pending = None  # (fetched, diag, label, scalars, t0) of a queued, unread step
        pool = ThreadPoolExecutor(1, thread_name_prefix="train-hd95")
        try:
            batches = self.loader.epochs(max(1, self.max_epoch - start_epoch))
            for epoch_idx, batch in batches if iter_num < cfg.max_iterations else ():
                epoch = start_epoch + epoch_idx
                if epoch != last_epoch:
                    beta, pos_th, neg_th = self._epoch_scalars(epoch)
                    last_epoch = epoch
                # the index this step lands on if the queued one is not skipped
                presumed = iter_num + 1 + (pending is not None)
                scalars = StepScalars(beta, self._consistency_weight(presumed - 1), pos_th,
                                      neg_th)
                step = (self.train_step_light if light_ok and not self._on_diag_cadence(presumed)
                        else self.train_step)
                t0 = self.timer.start()
                tensors = {k: torch.from_numpy(x) if isinstance(x, np.ndarray) else x
                           for k, x in batch.items()}
                vec, diag = step(self.state, tensors, generator, scalars)
                current = (self._fetch(vec), diag, tensors["label"], scalars, t0)
                if pending is not None:
                    iter_num = self._finish(*pending, iter_num, pool)
                    pending = None
                    if self._stop:
                        break
                if self._must_sync(iter_num + 1):  # from the true index
                    iter_num = self._finish(*current, iter_num, pool)
                    if self._stop:
                        break
                else:
                    pending = current
                reason = self._stop_reason(iter_num, t_start)
                if reason:
                    if pending is not None:
                        iter_num = self._finish(*pending, iter_num, pool)
                        pending = None
                    if self.lead:
                        self._save(checkpoint.iter_checkpoint_path(self.snapshot_path,
                                                                   iter_num), iter_num)
                    self.log.info("%s at iteration %d — saved and stopping", reason, iter_num)
                    break
            if pending is not None:  # the loader ran out first
                iter_num = self._finish(*pending, iter_num, pool)
            self._log_hd95(wait=True)
            self.log.info("Training Finished!")
        finally:
            pool.shutdown(wait=True, cancel_futures=True)
            self.log.close()
        return self.best_performance


def _rank_main(rank: int, world: int, device, cfg: TrainConfig) -> float:
    """One rank of a data-parallel run (parallel.launch's worker)."""
    return Trainer(dataclasses.replace(cfg, device=str(device)), rank, world).run()


def train(cfg: TrainConfig, **launch_kwargs) -> float:
    """The train CLIs' entry: one process with `data_parallel` 0 on one
    device; a process started by torchrun joins its run as one rank;
    otherwise `data_parallel` N > 0 (or 0 on several visible devices)
    spawns the ranks (parallel.launch; `launch_kwargs` reach it: `devices`,
    `backend`, `threads`, `timeout`). Returns the best validation Dice."""
    resolve_device(cfg.device)  # before any CUDA work; spawned ranks inherit its environment
    env = parallel.from_env()
    if env is not None:
        rank, world, local = env
        device = torch.device(cfg.device)
        if device.type == "cuda":
            device = torch.device("cuda", local)
            torch.cuda.set_device(device)
        parallel.distributed_init(rank, world, "env://", device=device)
        try:
            return _rank_main(rank, world, device, cfg)
        finally:
            torch.distributed.destroy_process_group()
    if launch_kwargs.get("devices"):
        world = len(launch_kwargs["devices"])
    elif cfg.data_parallel > 0:
        world = parallel.make_mesh(cfg.data_parallel, cfg.device)
    else:
        world = parallel.make_mesh(0, cfg.device, cfg.batch_size, cfg.labeled_bs)
        if world == 1:
            return Trainer(cfg).run()
    return parallel.launch(_rank_main, world, device=cfg.device, args=(cfg,), **launch_kwargs)
