"""The DyCON trainer, Pancreas and ISLES-2022 paths.

Counterpart of dycon_paper_replication_tpu/train/trainer.py for the part
that canonical Pancreas and ISLES training run:
  * the data: the train split (Pancreas, or ISLES with labelnum counted in
    patients, ISLES_PATIENTS_TO_SLICES), random crop + rot/flip, the
    two-stream sampler (the labeled cases first) and the prefetching loader;
  * the host schedules: per epoch beta and the FeCL focal thresholds, per
    iteration the consistency weight;
  * the step (train/step.py) on the device, one sync per step for its
    scalars;
  * validation every `val_every` iterations, with the student in eval mode
    and no gradient: Pancreas through the sliding window at val_stride_xy /
    val_stride_z over test1.list, ISLES by one whole-volume forward per
    val.list case, argmaxing the SDF head as the reference does; a better
    Dice saves iter_<N>_dice_<D> and the best model, each a full train
    state;
  * a full-state save every `save_every` iterations, `resume` ("", "auto"
    or a path) and `time_budget_s` (a clean, resumable stop).
Not ported (ROADMAP Queue A): the deferred scalar fetch (`fetch_ahead`),
the light/full step pair, train-HD95, the similarity monitor, the host-RSS
watchdog, StepTimer, the code snapshot, BraTS data and the multi-device
rules.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time

import torch

from .. import weights
from ..config import TrainConfig, resolve_device
from ..data import (
    BatchLoader,
    Compose,
    ISLESDataset,
    Pancreas,
    RandomRotFlip,
    ToArray,
    TwoStreamBatchSampler,
)
from ..eval import (
    SlidingWindowInference,
    WholeVolumeInference,
    iter_volumes,
    var_all_case,
    var_all_case_wholevolume,
)
from ..models import UNet3D, UNet3DConfig
from ..ops import ramps
from ..utils import checkpoint
from ..utils.logging import ExperimentLogger
from .state import create_train_state
from .step import SCALAR_METRICS, StepScalars, build_train_step

# ISLES-2022 labelnum (patients) -> number of labeled training volumes
# (the reference's train_DyCON_ISLES22.py)
ISLES_PATIENTS_TO_SLICES = {
    1: 36, 2: 38, 3: 27, 4: 53, 5: 60, 6: 25, 7: 25, 8: 38, 9: 38, 10: 45,
    11: 27, 12: 29, 13: 32, 14: 29, 15: 44, 16: 38, 17: 29, 18: 23, 19: 48,
    20: 42, 21: 31, 22: 48, 23: 42, 24: 23, 25: 29,
}


class Trainer:
    def __init__(self, cfg: TrainConfig):
        if cfg.dataset not in ("pancreas", "isles22"):
            raise ValueError(f"dataset {cfg.dataset!r} is not ported yet (pancreas, isles22)")
        self.cfg = cfg
        self.device = resolve_device(cfg.device)
        self.snapshot_path = cfg.snapshot_path()
        os.makedirs(self.snapshot_path, exist_ok=True)
        self.log = ExperimentLogger(self.snapshot_path)
        self.log.info(str(dataclasses.asdict(cfg)))
        with open(os.path.join(self.snapshot_path, "config.json"), "w") as f:
            json.dump({k: str(v) for k, v in dataclasses.asdict(cfg).items()}, f, indent=2)

        net_cfg = UNet3DConfig(in_channels=cfg.in_ch, n_classes=cfg.num_classes,
                               scale_factor=cfg.feature_scaler,
                               layout=cfg.resolved_layout(self.device))
        params, state = weights.init_jax_tree(net_cfg, seed=cfg.seed)
        student = UNet3D(net_cfg).to(self.device)
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

        if cfg.lr_schedule == "poly":
            schedule = lambda step: ramps.poly_lr(cfg.base_lr, step, cfg.max_iterations)  # noqa: E731
        else:
            schedule = lambda step: cfg.base_lr  # noqa: E731
        self.train_step = build_train_step(cfg, schedule)
        self._build_data()
        if cfg.dataset == "isles22":
            self.whole_volume = WholeVolumeInference(self.state.student, cfg.patch_size,
                                                     head="sdf")
            self.sw = None
        else:
            self.whole_volume = None
            self.sw = SlidingWindowInference(self.state.student, cfg.patch_size,
                                             cfg.val_stride_xy, cfg.val_stride_z)

    def _build_data(self) -> None:
        cfg = self.cfg
        transform = Compose([RandomRotFlip(), ToArray()])
        if cfg.dataset == "isles22":
            ds = ISLESDataset(cfg.root_dir, split="train", transform=transform,
                              crop_size=cfg.patch_size)
            labeled = ISLES_PATIENTS_TO_SLICES.get(cfg.labelnum, cfg.labelnum)
        else:
            ds = Pancreas(cfg.root_dir, split="train", transform=transform,
                          crop_size=cfg.patch_size)
            labeled = cfg.labelnum
        if labeled >= len(ds):
            raise ValueError(f"labelnum {labeled} >= dataset size {len(ds)}")
        sampler = TwoStreamBatchSampler(range(labeled), range(labeled, len(ds)),
                                        cfg.batch_size, cfg.batch_size - cfg.labeled_bs,
                                        seed=cfg.seed)
        self.loader = BatchLoader(ds, sampler, seed=cfg.seed, prefetch=cfg.num_prefetch)
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
        # Pancreas: test1.list, as the reference, which fails when it is missing
        with open(os.path.join(cfg.root_dir, "test1.list")) as f:
            names = [line.strip() for line in f if line.strip()]
        return iter_volumes([os.path.join(cfg.root_dir, "Pancreas_data", n) for n in names])

    def validate(self) -> float:
        """Mean Dice of the student over the validation volumes."""
        student = self.state.student.eval()
        try:
            with torch.no_grad():
                if self.whole_volume is not None:
                    return var_all_case_wholevolume(self.whole_volume, self._val_volumes())
                return var_all_case(self.sw, self._val_volumes())
        finally:
            student.train()

    def _save(self, path: str, iter_num: int) -> None:
        checkpoint.save_train_state(path, self.state,
                                    meta={"step": iter_num, "best_dice": self.best_performance})

    def _after_step(self, v: dict, scalars: StepScalars, iter_num: int) -> None:
        """Logging, validation and the periodic save after applied step `iter_num`."""
        cfg = self.cfg
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
        if iter_num % cfg.save_every == 0:
            self._save(checkpoint.iter_checkpoint_path(self.snapshot_path, iter_num), iter_num)

    def run(self) -> float:
        cfg = self.cfg
        t_start = time.monotonic()
        iter_num = self.state.step  # nonzero after a resume
        generator = torch.Generator(device=self.device).manual_seed(
            (cfg.seed + 1) * 1_000_003 + iter_num)
        start_epoch = iter_num // self.iters_per_epoch
        last_epoch = None
        try:
            batches = self.loader.epochs(max(1, self.max_epoch - start_epoch))
            for epoch_idx, batch in batches if iter_num < cfg.max_iterations else ():
                epoch = start_epoch + epoch_idx
                if epoch != last_epoch:
                    beta, pos_th, neg_th = self._epoch_scalars(epoch)
                    last_epoch = epoch
                scalars = StepScalars(beta, self._consistency_weight(iter_num), pos_th, neg_th)
                batch = {k: torch.from_numpy(v).to(self.device) for k, v in batch.items()}
                v = dict(zip(SCALAR_METRICS, self.train_step(self.state, batch, generator,
                                                             scalars).tolist()))
                if v["skipped"]:
                    # as the reference's `continue`: neither the step nor the
                    # schedules advance
                    self.log.info("NaN or Inf found in loss at iteration %d — skipped", iter_num)
                    continue
                iter_num += 1
                self._after_step(v, scalars, iter_num)
                if iter_num >= cfg.max_iterations:
                    break
                if cfg.time_budget_s and time.monotonic() - t_start >= cfg.time_budget_s:
                    self._save(checkpoint.iter_checkpoint_path(self.snapshot_path, iter_num),
                               iter_num)
                    self.log.info("Time budget %.0fs exceeded at iteration %d — saved and "
                                  "stopping", cfg.time_budget_s, iter_num)
                    break
            self.log.info("Training Finished!")
        finally:
            self.log.close()
        return self.best_performance
