"""One train step on a device against the same step on the CPU, from equal
states, compared leaf by leaf.

On CUDA the step runs the folded levels' convs through K1, K1 dx and K1-dW
(ops/folded_conv_cuda.py), the fused FeCL through K2 (ops/fecl_fused.py)
and the rest through cuDNN and cuBLAS; on the CPU every op is its plain
version. `check_step(device, config=...)` runs both and returns what differs
beyond the tolerances below, one line per leaf (empty when all agree).
`chip_smoke.py` and tests/test_torch_cuda.py run it on the card.

The cases. Both are a full-width UNet3D (feature_scale 4, filters 16..256),
folded, dropout 0; patch (32, 32, 16), batch 4 of which 2 labeled; the
teacher noise drawn with numpy and handed to both steps. The state has the
student from `seed`, a teacher from seed + 1 and step 1, so the EMA mixes
two different nets with alpha 0.5; the momentum starts at zero.
  * "pancreas": tests/test_torch_train_step.py's case, the Pancreas step
    config (dense FeCL over N = 4 x 4 x 2 = 32 at projection scale 2);
  * "isles22": the ISLES step config (teacher in eval mode, n-class Dice,
    the derived mask kernel, projection scale 4, so N = 8 x 8 x 4 = 256)
    with fecl_chunk 96: the fused FeCL runs K2 on the card (4 row tiles of
    64) and the twin on the CPU (3 tiles of 96, the last padded); its
    neg_thresh is 0.05 (SCALARS_ISLES), so that the cross term has pairs.

Kink sides. A step has kinks: its ReLUs, its max pools (which of a
block's 8 values is the largest) and FeCL's cross threshold
cs > neg_thresh. A float32-level difference between the card's kernels and
the CPU's plain ops moves a value that sits that close to a kink to the
other side, and one flipped ReLU or pool moves a gradient by O(1): that
says nothing of the kernels. So the device step runs first and records the
side of each such value (`KinkSides`); the CPU step then takes the device's
side wherever its own value lies within delta of the kink and keeps its own
side everywhere else, where a real fault still shows. delta is KINK_MARGIN
x the largest |value| of that tensor (a ReLU's input, a pool's input for
the gap between a block's two largest values, a tile of cs for
cs - neg_thresh). KINK_MARGIN is 1e-2, from the measured movement: under
uniform noise of 2e-6 x max|y| on every folded conv output (about K1's
largest difference from the plain conv), a ReLU input of this case moves by
up to 1.5e-3 of its largest value at the center, whose InstanceNorm spans
2 x 2 x 1 voxels, and by 1e-5..1e-4 at the folded levels
(tests/test_torch_device_check.py). The CPU step's ReLUs and max pools go
through mask-taking versions installed over models/layers.py:relu and
ops/resize.py:block_max for that step only, and the row-tiled FeCL's
threshold (fused or chunked) through ops/fecl_fused.py's `cross_side`
hook; the card's cs there is recomputed on the CPU in float32 from the card
step's embeddings, which agrees with K2's to ~1e-7. The check reports, per kind, how many values lay within delta
("near", without the exact zeros of masked lanes) and how many of them took
a side that was not their own ("taken").

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

import contextlib
import copy
import math
from unittest import mock

import numpy as np
import torch

from .. import weights
from ..config import TrainConfig, make_config
from ..models import UNet3D, UNet3DConfig, layers
from ..ops import dycon, fecl_fused, resize
from .state import TrainState, create_train_state
from .step import SCALAR_METRICS, StepScalars, build_train_step

PATCH = (32, 32, 16)
BATCH, LABELED = 4, 2
SCALARS = StepScalars(5.0, 0.1 * math.exp(-5.0), 1.3, 0.3)
# the ISLES case's neg_thresh: cs between these two random nets' embeddings
# lies within +-0.2, so the training range 0.3..0.5 would leave FeCL's cross
# term empty; at 0.05 about a quarter of all pairs are hard negatives
SCALARS_ISLES = SCALARS._replace(neg_thresh=0.05)
CPU = torch.device("cpu")
CONFIGS = ("pancreas", "isles22")
ISLES_FECL_CHUNK = 96
KINK_MARGIN = 1e-2


def step_config(device: torch.device, config: str = "pancreas") -> TrainConfig:
    extra = dict(fecl_chunk=ISLES_FECL_CHUNK) if config == "isles22" else {}
    return make_config(config, patch_size=PATCH, batch_size=BATCH, labeled_bs=LABELED,
                       device=torch.device(device).type, **extra)


def initial_state(seed: int, config: str = "pancreas") -> TrainState:
    """The CPU state of the module doc."""
    cfg = UNet3DConfig(layout="folded", dropout_rate=0.0,
                       scale_factor=step_config(CPU, config).feature_scaler)
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
             device: torch.device, config: str = "pancreas") -> np.ndarray:
    """One step of `state` (on `device`, updated in place); its scalars."""
    cfg = step_config(device, config)
    step = build_train_step(cfg, lambda _: cfg.base_lr)
    out, _ = step(state, {k: torch.from_numpy(v).to(device) for k, v in batch.items()},
                  torch.Generator(device=device).manual_seed(0),
                  SCALARS_ISLES if config == "isles22" else SCALARS,
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


def _blocks(x: torch.Tensor, dims: tuple[int, ...]) -> torch.Tensor:
    """`x` with the block axes `dims` moved to the end and flattened into
    one axis of 8 (in the order of `dims`)."""
    x = x.movedim(dims, tuple(range(x.dim() - len(dims), x.dim())))
    return x.reshape(*x.shape[:x.dim() - len(dims)], -1)


class KinkSides:
    """The device step's sides at its kinks, and the CPU step taking them
    within the margin (module doc). `record()` wraps the device step,
    `share()` the CPU step; `counts` then holds, for the ReLUs, the max
    pools and the cross threshold, the values within the margin ("near")
    and those of them whose side came from the device and differed from
    their own ("taken")."""

    def __init__(self):
        self._relu: list[torch.Tensor] = []
        self._pool: list[torch.Tensor] = []
        self._fecl: list[tuple] = []
        self._cross: dict = {}
        self.counts = dict(relu_near=0, relu_taken=0, pool_near=0, pool_taken=0, cross_near=0,
                           cross_taken=0)

    @classmethod
    def given(cls, relu: list, pool: list, fecl: list) -> "KinkSides":
        """Sides recorded elsewhere, in `record()`'s order and form: per
        ReLU call a bool tensor (input > 0), per max pool the argmax over
        its blocks, per row-tiled FeCL call the (embeddings, teacher
        embeddings) on the CPU. The port's JAX parity tests give the JAX
        step's."""
        sides = cls()
        sides._relu, sides._pool, sides._fecl = list(relu), list(pool), list(fecl)
        return sides

    @staticmethod
    def _near(value: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
        return value.abs() <= KINK_MARGIN * scale.abs().max()

    @contextlib.contextmanager
    def record(self):
        fused, chunked = fecl_fused.fecl_loss_fused, dycon.fecl_loss_chunked

        def relu(x):
            self._relu.append((x.detach() > 0).cpu())
            return torch.relu(x)

        def block_max(x, dims):
            self._pool.append(_blocks(x.detach(), dims).argmax(dim=-1).cpu())
            return x.amax(dim=dims)

        def recorded(fn):
            def fecl(feat, mask, teacher_feat=None, *args, **kwargs):
                self._fecl.append((feat.detach().cpu(), None if teacher_feat is None
                                   else teacher_feat.detach().cpu()))
                return fn(feat, mask, teacher_feat, *args, **kwargs)
            return fecl

        with mock.patch.object(layers, "relu", relu), \
                mock.patch.object(resize, "block_max", block_max), \
                mock.patch.object(fecl_fused, "fecl_loss_fused", recorded(fused)), \
                mock.patch.object(dycon, "fecl_loss_chunked", recorded(chunked)):
            yield self

    @contextlib.contextmanager
    def share(self):
        relu_sides, pool_sides = iter(self._relu), iter(self._pool)
        fecl_calls = iter(self._fecl)
        fused, chunked = fecl_fused.fecl_loss_fused, dycon.fecl_loss_chunked
        card = {}

        def relu(x):
            xd = x.detach()
            own = xd > 0
            near = self._near(xd, xd)
            side = torch.where(near, next(relu_sides), own)
            # counted without the exact zeros of masked lanes, zero on both devices
            self.counts["relu_near"] += int((near & (xd != 0)).sum())
            self.counts["relu_taken"] += int((side != own).sum())
            return torch.where(side, x, torch.zeros_like(x))

        def block_max(x, dims):
            # the max's kink: the two largest of a block within the margin
            x = _blocks(x, dims)
            xd = x.detach()
            top = xd.topk(2, dim=-1).values
            own = xd.argmax(dim=-1)
            near = self._near(top[..., 0] - top[..., 1], xd)
            side = torch.where(near, next(pool_sides), own)
            self.counts["pool_near"] += int((near & (top[..., 0] != 0)).sum())
            self.counts["pool_taken"] += int((side != own).sum())
            return torch.where(near, x.gather(-1, side[..., None])[..., 0], x.amax(dim=-1))

        def shared(fn):
            def fecl(feat, mask, teacher_feat=None, *args, **kwargs):
                card["embeddings"] = next(fecl_calls)
                card["call"] = card.get("call", -1) + 1
                return fn(feat, mask, teacher_feat, *args, **kwargs)
            return fecl

        def cross_side(rows, cs, neg_t, own):
            feat, tfeat = (torch.nn.functional.pad(t, (0, 0, 0, cs.shape[2] - t.shape[1]))
                           for t in card["embeddings"])
            card_side = torch.einsum("btd,bnd->btn", feat[:, rows], tfeat).to(cs.dtype) > neg_t
            near = self._near(cs.detach() - neg_t, cs.detach())
            side = torch.where(near, card_side, own)
            # the twin's forward and backward ask for the same tiles: count once
            self._cross[(card["call"], rows.start)] = (int(near.sum()), int((side != own).sum()))
            return side

        with mock.patch.object(layers, "relu", relu), \
                mock.patch.object(resize, "block_max", block_max), \
                mock.patch.object(fecl_fused, "fecl_loss_fused", shared(fused)), \
                mock.patch.object(dycon, "fecl_loss_chunked", shared(chunked)), \
                mock.patch.object(fecl_fused, "cross_side", cross_side):
            yield self
        if any(next(it, None) is not None for it in (relu_sides, pool_sides, fecl_calls)):
            raise RuntimeError("the CPU step passed fewer kinks than the device step")
        self.counts["cross_near"] = sum(n for n, _ in self._cross.values())
        self.counts["cross_taken"] = sum(t for _, t in self._cross.values())


def check_step(device: torch.device | str, seed: int = 0, config: str = "pancreas",
               device_context=contextlib.nullcontext):
    """One step on `device`, then one on the CPU from the same state and
    inputs, the CPU step taking the device step's kink sides within the
    margin (module doc). `device_context()` is entered around the device
    step alone (a test perturbs that side through it). Returns (the
    differences beyond tolerance, one line each; the device step's scalars;
    `worst_by_group` of all comparisons; `KinkSides.counts`)."""
    device = torch.device(device)
    state = initial_state(seed, config)
    batch, noise = make_inputs(seed)
    sides = KinkSides()
    got = state_on(state, device)
    with sides.record(), device_context():
        got_scalars = run_step(got, batch, noise, device, config)
    want = state_on(state, CPU)
    with sides.share():
        want_scalars = run_step(want, batch, noise, CPU, config)
    lr = step_config(device, config).base_lr
    label = batch["label"]
    rows = comparisons(got, got_scalars, want, want_scalars, label, lr)
    return (differences(got, got_scalars, want, want_scalars, label, lr), got_scalars,
            worst_by_group(rows), sides.counts)
