"""Run configuration and device selection.

Counterpart of dycon_paper_replication_tpu/config.py: `TrainConfig`,
`DATASET_DEFAULTS`, `make_config` and `snapshot_path`, with the same field
names and defaults so checkpoints are addressed by the same run directory.

Fields dropped from the JAX config, by decision:
  * `remat` (gradient rematerialisation) and `wire_dtype` (the host->TPU
    transfer dtype) exist for the TPU's 16 GB HBM and its slow host link;
    the port has neither concern yet, and training is a later slice.
`layout="auto"` resolves against the torch device: "folded" for unet_3D on
CUDA, where the fold-2 conv is the hand-written kernel K1, and "NDHWC"
elsewhere. The compute dtype on the card is float32 in this slice.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch


@dataclasses.dataclass
class TrainConfig:
    # paths / experiment
    root_dir: str = "../data/Pancreas"
    exp: str = "PancreasCT"
    model: str = "unet_3D"
    dataset: str = "pancreas"  # pancreas | brats19 | isles22
    snapshot_root: str = "./runs"

    # reproducibility
    seed: int = 1337
    deterministic: int = 1

    # model
    in_ch: int = 1
    num_classes: int = 2
    feature_scaler: int = 2
    use_aspp: bool = False
    patch_size: tuple[int, int, int] = (112, 112, 96)

    # optimization
    max_iterations: int = 20000
    batch_size: int = 8
    labeled_bs: int = 4
    base_lr: float = 0.01
    lr_schedule: str = "const"  # const | poly (ISLES)
    momentum: float = 0.9
    weight_decay: float = 1e-4
    grad_clip_norm: float = 1.0

    # SSL
    labelnum: int = 12
    ema_decay: float = 0.99
    consistency: float = 0.1
    consistency_type: str = "mse"  # mse | kl
    consistency_rampup: float = 200.0

    # DyCON
    gamma: float = 2.0
    beta_min: float = 0.5
    beta_max: float = 5.0
    s_beta: float | None = None
    temp: float = 0.6
    l_weight: float = 1.0
    u_weight: float = 0.5
    use_focal: int = 1
    use_teacher_loss: int = 1
    fecl_rampup_epochs: float = 1500.0
    fecl_chunk: int = 0
    fecl_impl: str = "fused"

    # dataset-behaviour switches
    teacher_train_mode: bool = True
    dice_loss_kind: str = "binary"
    mask_kernel_mode: str = "fixed"

    # eval cadence
    val_every: int = 200
    save_every: int = 3000
    val_stride_xy: int = 64
    val_stride_z: int = 64

    # runtime
    compute_dtype: str = "float32"
    num_prefetch: int = 2
    data_parallel: int = 0
    resume: str = ""
    time_budget_s: float = 0.0
    host_rss_exit_gb: float = 100.0
    fetch_ahead: int = 1
    step_diagnostics: str = "cadence"
    layout: str = "auto"  # auto | NDHWC | folded

    def resolved_layout(self, device: torch.device | str) -> str:
        """The model layout for `device`: "auto" is "folded" for unet_3D on
        CUDA and "NDHWC" otherwise."""
        if self.layout != "auto":
            return self.layout
        on_cuda = torch.device(device).type == "cuda"
        return "folded" if on_cuda and self.model == "unet_3D" else "NDHWC"

    def snapshot_path(self) -> str:
        """Hyperparameter-encoded run directory (the JAX package's two
        conventions: BraTS/Pancreas style and the ISLES style)."""
        if self.dataset == "isles22":
            return (
                f"{self.snapshot_root}/{self.exp}/DyCON_{self.model}_"
                f"{self.consistency_type}_temp{self.temp}_labelnum{self.labelnum}"
                f"_max_iterations{self.max_iterations}"
            )
        beta_str = (f"_beta{self.s_beta}" if self.s_beta is not None
                    else f"_beta{self.beta_min}-{self.beta_max}")
        focal_str = "Focal" if self.use_focal else "NoFocal"
        gamma_str = f"_gamma{self.gamma}" if self.use_focal else ""
        teacher_str = "Teacher" if self.use_teacher_loss else "NoTeacher"
        return (
            f"{self.snapshot_root}/{self.exp}/{self.model.upper()}_{self.labelnum}labels_"
            f"{self.consistency_type}{gamma_str}_{focal_str}_{teacher_str}_temp{self.temp}"
            f"{beta_str}_max_iterations{self.max_iterations}"
        )


DATASET_DEFAULTS: dict[str, dict[str, Any]] = {
    "pancreas": dict(
        root_dir="../data/Pancreas", exp="PancreasCT", dataset="pancreas",
        patch_size=(112, 112, 96), feature_scaler=2, labelnum=12,
        batch_size=8, labeled_bs=4, lr_schedule="const",
        teacher_train_mode=True, dice_loss_kind="binary", mask_kernel_mode="fixed",
    ),
    "brats19": dict(
        root_dir="../data/BraTS2019", exp="BraTS2019", dataset="brats19",
        patch_size=(96, 96, 96), feature_scaler=2, labelnum=25,
        batch_size=8, labeled_bs=4, lr_schedule="const",
        teacher_train_mode=True, dice_loss_kind="binary", mask_kernel_mode="fixed",
    ),
    "isles22": dict(
        root_dir="../data/ISLES22", exp="ISLES22", dataset="isles22",
        patch_size=(96, 96, 64), feature_scaler=4, labelnum=10,
        batch_size=8, labeled_bs=4, lr_schedule="poly",
        teacher_train_mode=False, dice_loss_kind="nclass", mask_kernel_mode="derived",
        fecl_chunk=512,
    ),
}


def make_config(dataset: str, **overrides: Any) -> TrainConfig:
    kw = dict(DATASET_DEFAULTS[dataset])
    kw.update(overrides)
    return TrainConfig(**kw)


def resolve_device(device: torch.device | str = "cuda") -> torch.device:
    """The torch device for an entry point. Raises when CUDA is asked for
    and missing. On CUDA it turns TF32 off for matmuls and cuDNN convs: the
    port's float32 path is full float32, as its reference numerics are."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but CUDA is not available; "
                               "pass device='cpu' to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {device}")
    return device
