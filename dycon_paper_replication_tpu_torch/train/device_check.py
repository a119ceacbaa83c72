"""One train step on a device against the same step on the CPU, from equal
states, compared leaf by leaf.

On CUDA the step runs the folded levels' convs through K1, K1 dx and K1-dW
(ops/folded_conv_cuda.py) and the rest through cuDNN and cuBLAS; on the CPU
every op is its plain version. `check_step(device)` runs both and returns
what differs beyond the tolerances below, one line per leaf (empty when all
agree). `chip_smoke.py` and tests/test_torch_cuda.py run it on the card.

The case is tests/test_torch_train_step.py's: a full-width UNet3D
(feature_scale 4, filters 16..256), folded, dropout 0; patch (32, 32, 16),
batch 4 of which 2 labeled; the Pancreas step config, its teacher noise
drawn with numpy and handed to both steps. The state has the student from
`seed`, a teacher from seed + 1 and step 1, so the EMA mixes two different
nets with alpha 0.5; the momentum starts at zero.

Tolerances, tests/test_torch_train_step.py's (its module doc gives the
reasons: float32 summation order in the norm backwards), for one step.
P = max|momentum of the leaf| after the CPU step; for the bias of a conv
followed by a norm, whose true gradient is 0, its conv weight's P.
  * the six losses and `skipped`: rtol 1e-5, atol 1e-6; `train_dice`, a
    count of probabilities thresholded at 0.5, the same plus one flipped
    voxel per sample (2 / the smallest label count);
  * momentum: 5e-3 x P; parameters and teacher parameters: 5e-3 x lr x P
    plus 2 ulp of the leaf's largest magnitude;
  * BatchNorm running stats: rtol 1e-4, atol 1e-5.
"""

from __future__ import annotations

import copy
import math

import numpy as np
import torch

from .. import weights
from ..config import TrainConfig, make_config
from ..models import UNet3D, UNet3DConfig
from .state import TrainState, create_train_state
from .step import SCALAR_METRICS, StepScalars, build_train_step

PATCH = (32, 32, 16)
BATCH, LABELED = 4, 2
SCALARS = StepScalars(5.0, 0.1 * math.exp(-5.0), 1.3, 0.3)
CPU = torch.device("cpu")


def step_config(device: torch.device) -> TrainConfig:
    return make_config("pancreas", patch_size=PATCH, batch_size=BATCH, labeled_bs=LABELED,
                       device=device.type)


def initial_state(seed: int) -> TrainState:
    """The CPU state of the module doc."""
    cfg = UNet3DConfig(layout="folded", dropout_rate=0.0)
    nets = []
    for s in (seed, seed + 1):
        net = UNet3D(cfg)
        net.load_state_dict(weights.jax_tree_to_state_dict(*weights.init_jax_tree(cfg, s)))
        nets.append(net)
    state = create_train_state(nets[0])
    state.teacher.load_state_dict(nets[1].state_dict())
    state.step = 1
    return state


def make_inputs(seed: int) -> tuple[dict[str, np.ndarray], np.ndarray]:
    """A batch of ellipsoid labels with a noisy image, and the teacher noise
    clip(0.1 N(0, 1), +-0.2), from `seed`."""
    rng = np.random.default_rng(seed)
    grid = np.stack(np.meshgrid(*[np.arange(s) for s in PATCH], indexing="ij"), -1)
    labels = []
    for _ in range(BATCH):
        center = rng.uniform(0.3, 0.7, 3) * PATCH
        radii = rng.uniform(0.3, 0.5, 3) * PATCH
        labels.append((((grid - center) / radii) ** 2).sum(-1) <= 1.0)
    label = np.stack(labels).astype(np.int32)
    image = (0.4 * label + 0.1 * rng.standard_normal(label.shape)).astype(np.float32)[..., None]
    noise = np.clip(0.1 * rng.standard_normal(image.shape), -0.2, 0.2).astype(np.float32)
    return {"image": image, "label": label}, noise


def state_on(state: TrainState, device: torch.device) -> TrainState:
    """A copy of `state` on `device`."""
    return TrainState(copy.deepcopy(state.student).to(device),
                      copy.deepcopy(state.teacher).to(device),
                      {k: v.clone().to(device) for k, v in state.momentum.items()}, state.step)


def run_step(state: TrainState, batch: dict[str, np.ndarray], noise: np.ndarray,
             device: torch.device) -> np.ndarray:
    """One step of `state` (on `device`, updated in place); its scalars."""
    cfg = step_config(device)
    step = build_train_step(cfg, lambda _: cfg.base_lr)
    out = step(state, {k: torch.from_numpy(v).to(device) for k, v in batch.items()},
               torch.Generator(device=device).manual_seed(0), SCALARS,
               noise=torch.from_numpy(noise).to(device))
    return out.cpu().numpy()


def _normalised_bias(key: str) -> bool:
    """The bias of a conv followed by an InstanceNorm or BatchNorm."""
    return key.endswith(".b") and not key.startswith(("final.", "out_conv2."))


def comparisons(got: TrainState, got_scalars: np.ndarray, want: TrainState,
                want_scalars: np.ndarray, label: np.ndarray,
                lr: float) -> list[tuple[str, str, float, float]]:
    """(group, leaf, max abs difference, tolerance) for each scalar and leaf
    of `got` against `want` (the CPU step's), with the module doc's
    tolerances; for a BatchNorm stat, elementwise, the largest
    |difference| / (atol + rtol |want|) and 1."""
    out = []
    label_min = label.reshape(label.shape[0], -1).sum(1).min()
    for i, name in enumerate(SCALAR_METRICS):
        g, w = float(got_scalars[i]), float(want_scalars[i])
        tol = 1e-6 + 1e-5 * abs(w) + (2.0 / label_min if name == "train_dice" else 0.0)
        out.append(("scalar", name, abs(g - w), tol))
    path = {k: float(v.detach().abs().max()) for k, v in want.momentum.items()}
    groups = [("momentum", got.momentum, want.momentum, 1.0),
              ("params", dict(got.student.named_parameters()),
               dict(want.student.named_parameters()), lr),
              ("teacher", dict(got.teacher.named_parameters()),
               dict(want.teacher.named_parameters()), lr)]
    for group, got_leaves, want_leaves, unit in groups:
        for k, wt in want_leaves.items():
            w = wt.detach().cpu().numpy()
            g = got_leaves[k].detach().cpu().numpy()
            tol = 5e-3 * unit * path[k[:-1] + "w" if _normalised_bias(k) else k]
            if group != "momentum":
                tol += 2 * float(np.spacing(np.abs(w).max()))
            out.append((group, k, float(np.abs(g - w).max()), tol))
    for group, net_got, net_want in (("stats", got.student, want.student),
                                     ("teacher stats", got.teacher, want.teacher)):
        got_buffers = dict(net_got.named_buffers())
        for k, wt in net_want.named_buffers():
            w = wt.cpu().numpy()
            ratio = np.abs(got_buffers[k].cpu().numpy() - w) / (1e-5 + 1e-4 * np.abs(w))
            out.append((group, k, float(ratio.max()), 1.0))
    return out


def differences(got: TrainState, got_scalars: np.ndarray, want: TrainState,
                want_scalars: np.ndarray, label: np.ndarray, lr: float) -> list[str]:
    """Each scalar or leaf of `got` outside its tolerance of `want`, as one
    line; the step counts too."""
    out = [f"{group} {k}: max abs diff {diff} > {tol}" for group, k, diff, tol in
           comparisons(got, got_scalars, want, want_scalars, label, lr) if not diff <= tol]
    if got.step != want.step:
        out.append(f"step {got.step} vs {want.step}")
    return out


def worst_by_group(rows: list[tuple[str, str, float, float]]) -> dict[str, tuple[str, float]]:
    """{group: (leaf, difference / tolerance)} of the leaf nearest its
    tolerance in each group."""
    worst: dict[str, tuple[str, float]] = {}
    for group, k, diff, tol in rows:
        if group not in worst or diff / tol > worst[group][1]:
            worst[group] = (k, diff / tol)
    return worst


def check_step(device: torch.device | str, seed: int = 0):
    """One step on the CPU and one on `device` from the same state and
    inputs: (the differences beyond tolerance, one line each; the device
    step's scalars; `worst_by_group` of all comparisons)."""
    device = torch.device(device)
    state = initial_state(seed)
    batch, noise = make_inputs(seed)
    want = state_on(state, CPU)
    want_scalars = run_step(want, batch, noise, CPU)
    got = state_on(state, device)
    got_scalars = run_step(got, batch, noise, device)
    lr = step_config(device).base_lr
    label = batch["label"]
    rows = comparisons(got, got_scalars, want, want_scalars, label, lr)
    return (differences(got, got_scalars, want, want_scalars, label, lr), got_scalars,
            worst_by_group(rows))
