"""Run configuration and device selection.

Counterpart of dycon_paper_replication_tpu/config.py: `TrainConfig`,
`DATASET_DEFAULTS`, `make_config` and `snapshot_path`, with the same field
names and defaults so checkpoints are addressed by the same run directory.

Every field of the JAX config is here, with its default; one is added:
`device` ("cuda" or "cpu"), the torch device of a run. The host loop's
fields take the JAX trainer's meaning (train/trainer.py): `fetch_ahead` 1
queues iteration N+1 before it reads iteration N's scalars,
`step_diagnostics` "cadence" runs the light step off the train-HD95 and
monitor iterations, `remat` "full" recomputes the student forward in the
backward pass (train/step.py), and `wire_dtype` is the dtype of the batch
the loader copies to the device: "auto" is float32 image and int32 label
(the JAX package narrows it only on a TPU), "float16" a float16 image and
a uint8 label, widened on the device (data/pipeline.py).
`layout="auto"` resolves against the torch device: "folded" for unet_3D and
vnet on CUDA, where the fold-2 conv is the hand-written kernel K1, and
"NDHWC" elsewhere. `--layout NCDHW` is accepted as an alias of "NDHWC" in
every parser (resolve_layout): in the JAX package it keeps the W axis in the
TPU's lane dimension and is "numerically identical to NDHWC"
(dycon_paper_replication_tpu/config.py), and the port's NDHWC path already
hands its convs to cuDNN through an NCDHW view (models/layers.py), so the
two would be one path. `--compute_dtype` is float32 (the default) or bfloat16,
the JAX flag: the model's convs compute in it, with float32 parameters,
norm statistics, heads and losses (models/unet3d.py); checkpoints hold the
float32 parameters either way, so the run directory does not encode it. `--model`
takes unet_3D and vnet; `--use_aspp 1` puts ASPP on the UNet3D's
bottleneck (the VNet takes none, as in the JAX factory). Snapshot paths and
checkpoint names follow the model (VNET_..., vnet_best_model.pt).

`build_parser` / `config_from_args` take every flag of the JAX package's
train parser, with its default, plus `--device`, for the three datasets
("pancreas", "brats19", "isles22"), but three: the reference's --gpu_ids
and --use_ddp, which do nothing in the JAX package either, and --gpu_id,
since the device is --device. Those are refused by argparse rather than
accepted and ignored.
`--data_parallel N` runs N ranks, one process each (parallel/mesh.py,
train/trainer.py:train): N > 1 applies the JAX trainer's multi-device rules
(batch sizes rounded down to multiples of N, the learning rate times N);
0, the default, is every visible device (1 on the CPU: one process)
clamped to divide the batch and its labeled part.
`--deterministic 1`, the default, keeps the seed and makes reruns
bit-identical on the card as in the JAX package: cudnn.benchmark off,
cudnn.deterministic on and torch.use_deterministic_algorithms(True), so an
op with no deterministic CUDA implementation raises; cuBLAS needs
CUBLAS_WORKSPACE_CONFIG (resolve_device). `--deterministic 0` draws the
run's seed from the OS, turns cudnn.benchmark on and the mode off, as the
reference's flag did (train/trainer.py). `--host_rss_exit_gb` is the
host-RSS watchdog's bar (0 turns it off).
`--fecl_chunk N > 0` runs FeCL over row tiles of N, through `--fecl_impl`
"fused" (the closed-form backward, ops/fecl_fused.py, K2 on the card) or
"chunked" (ops/dycon.py:fecl_loss_chunked); 0 is the dense FeCL.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from typing import Any, MutableMapping, Sequence

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
    compute_dtype: str = "float32"  # float32 | bfloat16
    num_prefetch: int = 2
    data_parallel: int = 0
    resume: str = ""
    time_budget_s: float = 0.0
    host_rss_exit_gb: float = 100.0
    fetch_ahead: int = 1  # 0 | 1
    step_diagnostics: str = "cadence"  # always | cadence
    remat: str = "none"  # none | full
    wire_dtype: str = "auto"  # auto | float32 | float16
    layout: str = "auto"  # auto | NDHWC | folded
    device: str = "cuda"  # cuda | cpu

    def resolved_layout(self, device: torch.device | str) -> str:
        """The model layout for `device` (resolve_layout)."""
        return resolve_layout(self.layout, device, self.model)

    def torch_compute_dtype(self) -> torch.dtype:
        """`compute_dtype` as a torch dtype."""
        return COMPUTE_DTYPES[self.compute_dtype]

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


COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
LAYOUTS = ("auto", "NDHWC", "NCDHW", "folded")  # the JAX flag's choices


def resolve_layout(layout: str, device: torch.device | str, model: str = "unet_3D") -> str:
    """The model layout of a `--layout` value on `device`: "auto" is
    "folded" for unet_3D and vnet on CUDA (both have fold-2 engines) and
    "NDHWC" otherwise; "NCDHW" is "NDHWC" (module doc)."""
    if layout == "auto":
        on_cuda = torch.device(device).type == "cuda"
        return "folded" if on_cuda and model in ("unet_3D", "vnet") else "NDHWC"
    return "NDHWC" if layout == "NCDHW" else layout

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


def _non_negative(text: str) -> int:
    value = int(text)
    if value < 0:
        raise argparse.ArgumentTypeError(f"must be >= 0, got {value}")
    return value


def build_parser(dataset: str) -> argparse.ArgumentParser:
    """The JAX package's training flags (names and defaults) that the port
    implements, plus --device."""
    d = make_config(dataset)
    p = argparse.ArgumentParser(description=f"Training DyCON on {d.exp} (PyTorch/CUDA)")
    p.add_argument("--root_dir", type=str, default=d.root_dir)
    p.add_argument("--exp", type=str, default=d.exp)
    p.add_argument("--model", type=str, choices=["unet_3D", "vnet"], default=d.model)
    p.add_argument("--seed", type=int, default=d.seed)
    p.add_argument("--deterministic", type=int, default=d.deterministic, choices=[0, 1],
                   help="1: bit-identical reruns (deterministic algorithms only); 0: an OS "
                        "seed and cudnn.benchmark")
    p.add_argument("--in_ch", type=int, default=d.in_ch)
    p.add_argument("--num_classes", type=int, default=d.num_classes)
    p.add_argument("--feature_scaler", type=int, default=d.feature_scaler)
    p.add_argument("--use_aspp", type=int, default=int(d.use_aspp), choices=[0, 1],
                   help="ASPP on the UNet3D's bottleneck before the projection head")
    p.add_argument("--patch_size", type=int, nargs=3, default=list(d.patch_size))
    p.add_argument("--max_iterations", type=int, default=d.max_iterations)
    p.add_argument("--batch_size", type=int, default=d.batch_size)
    p.add_argument("--labeled_bs", type=int, default=d.labeled_bs)
    p.add_argument("--base_lr", type=float, default=d.base_lr)
    p.add_argument("--labelnum", type=int, default=d.labelnum)
    p.add_argument("--ema_decay", type=float, default=d.ema_decay)
    p.add_argument("--consistency", type=float, default=d.consistency)
    p.add_argument("--consistency_type", type=str, default=d.consistency_type,
                   choices=["mse", "kl"])
    p.add_argument("--consistency_rampup", type=float, default=d.consistency_rampup)
    p.add_argument("--gamma", type=float, default=d.gamma)
    p.add_argument("--beta_min", type=float, default=d.beta_min)
    p.add_argument("--beta_max", type=float, default=d.beta_max)
    p.add_argument("--s_beta", type=float, default=None)
    p.add_argument("--temp", type=float, default=d.temp)
    p.add_argument("--l_weight", type=float, default=d.l_weight)
    p.add_argument("--u_weight", type=float, default=d.u_weight)
    p.add_argument("--use_focal", type=int, default=d.use_focal)
    p.add_argument("--use_teacher_loss", type=int, default=d.use_teacher_loss)
    p.add_argument("--snapshot_root", type=str, default=d.snapshot_root)
    p.add_argument("--compute_dtype", type=str, default=d.compute_dtype,
                   choices=list(COMPUTE_DTYPES))
    p.add_argument("--val_every", type=int, default=d.val_every)
    p.add_argument("--save_every", type=int, default=d.save_every)
    p.add_argument("--time_budget_s", type=float, default=d.time_budget_s,
                   help="wall-clock budget; 0 = unlimited (clean exit + resumable ckpt)")
    p.add_argument("--resume", type=str, default=d.resume,
                   help='"" fresh, "auto" = latest ckpt of this run dir, or a path')
    p.add_argument("--host_rss_exit_gb", type=float, default=d.host_rss_exit_gb,
                   help="save resumably and stop when host RSS reaches this (GB); 0 = off")
    p.add_argument("--fetch_ahead", type=int, default=d.fetch_ahead, choices=[0, 1],
                   help="1 = read each iteration's scalars after the next step is queued")
    p.add_argument("--step_diagnostics", type=str, default=d.step_diagnostics,
                   choices=["always", "cadence"],
                   help="cadence = light step (scalars only) off the monitor/HD95 cadence")
    p.add_argument("--remat", type=str, default=d.remat, choices=["none", "full"],
                   help="full = recompute the student forward in the backward pass")
    p.add_argument("--wire_dtype", type=str, default=d.wire_dtype,
                   choices=["auto", "float32", "float16"],
                   help="the batch's dtype on its way to the device; float16 = float16 image "
                        "and uint8 label")
    p.add_argument("--layout", type=str, default=d.layout, choices=LAYOUTS)
    p.add_argument("--fecl_chunk", type=_non_negative, default=d.fecl_chunk,
                   help="FeCL row tile; 0 = dense")
    p.add_argument("--fecl_impl", type=str, default=d.fecl_impl, choices=["fused", "chunked"])
    p.add_argument("--data_parallel", type=_non_negative, default=d.data_parallel,
                   help="ranks, one process each; 0 = every visible device, clamped to "
                        "divide the batch")
    p.add_argument("--device", type=str, default=d.device, choices=["cuda", "cpu"])
    return p


def config_from_args(dataset: str, argv: Sequence[str] | None = None) -> TrainConfig:
    args = build_parser(dataset).parse_args(argv)
    field_names = {f.name for f in dataclasses.fields(TrainConfig)}
    kw = {k: v for k, v in vars(args).items() if k in field_names}
    kw["patch_size"] = tuple(kw["patch_size"])
    kw["use_aspp"] = bool(kw["use_aspp"])
    return make_config(dataset, **kw)


# the CUBLAS_WORKSPACE_CONFIG values under which cuBLAS gives bit-identical
# results run to run (the cuBLAS guide's "Results reproducibility"); the
# first is the one resolve_device sets
CUBLAS_DETERMINISTIC = (":4096:8", ":16:8")
_cublas_set_late = False  # resolve_device set it after CUDA had started


def set_cublas_workspace(env: MutableMapping[str, str], cuda_started: bool) -> bool:
    """Set CUBLAS_WORKSPACE_CONFIG in `env` to CUBLAS_DETERMINISTIC[0]
    unless it holds a value already, which is kept. Returns whether it was
    set here after CUDA had started (`cuda_started`): a cuBLAS handle made
    before then keeps the workspace it was made with."""
    if "CUBLAS_WORKSPACE_CONFIG" in env:
        return False
    env["CUBLAS_WORKSPACE_CONFIG"] = CUBLAS_DETERMINISTIC[0]
    return cuda_started


def require_deterministic_cublas(env: MutableMapping[str, str] = os.environ) -> None:
    """Raise unless cuBLAS is deterministic in this process:
    CUBLAS_WORKSPACE_CONFIG holds one of CUBLAS_DETERMINISTIC, and not
    because resolve_device set it after CUDA had started."""
    value = env.get("CUBLAS_WORKSPACE_CONFIG")
    if value not in CUBLAS_DETERMINISTIC:
        raise RuntimeError(f"deterministic=1 needs CUBLAS_WORKSPACE_CONFIG set to one of "
                           f"{CUBLAS_DETERMINISTIC} before the first cuBLAS call; it is {value!r}")
    if _cublas_set_late:
        raise RuntimeError("deterministic=1: CUBLAS_WORKSPACE_CONFIG was set after CUDA had "
                           "started in this process, so a cuBLAS handle made earlier may run "
                           "nondeterministically; export CUBLAS_WORKSPACE_CONFIG="
                           f"{CUBLAS_DETERMINISTIC[0]} before the process starts, or call "
                           "resolve_device before any CUDA work")


def resolve_device(device: torch.device | str = "cuda") -> torch.device:
    """The torch device for an entry point, which calls it first. Raises
    when CUDA is asked for and missing. It sets CUBLAS_WORKSPACE_CONFIG
    (set_cublas_workspace; inherited by the ranks a data-parallel run
    spawns), which cuBLAS reads when it makes a handle. On CUDA it turns
    TF32 off for matmuls and cuDNN convs: the port's float32 path is full
    float32, as its reference numerics are."""
    global _cublas_set_late
    if set_cublas_workspace(os.environ, torch.cuda.is_initialized()):
        _cublas_set_late = True
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
