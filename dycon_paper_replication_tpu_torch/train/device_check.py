"""One train step on a device against the same step on the CPU, from equal
states, compared leaf by leaf.

On CUDA the step runs the folded levels' convs through K1, K1 dx and K1-dW
(ops/folded_conv_cuda.py), the fused FeCL through K2 (ops/fecl_fused.py)
and the rest through cuDNN and cuBLAS; on the CPU every op is its plain
version. `check_step(device, config=...)` runs both and returns what differs
beyond the tolerances below, one line per leaf (empty when all agree).
`chip_smoke.py` and tests/test_torch_cuda.py run it on the card.

The cases. Each is a full-width model, folded, dropout 0; patch
(32, 32, 16), batch 4 of which 2 labeled; the teacher noise drawn with
numpy and handed to both steps. The state has the student from `seed`, a
teacher from seed + 1 and step 1, so the EMA mixes two different nets with
alpha 0.5; the momentum starts at zero.
  * "pancreas": tests/test_torch_train_step.py's case, a UNet3D
    (feature_scale 4, filters 16..256) under the Pancreas step config
    (dense FeCL over N = 4 x 4 x 2 = 32 at projection scale 2);
  * "isles22": the UNet3D under the ISLES step config (teacher in eval mode,
    n-class Dice, the derived mask kernel, projection scale 4, so
    N = 8 x 8 x 4 = 256) with fecl_chunk 96: the fused FeCL runs K2 on the
    card (4 row tiles of 64) and the twin on the CPU (3 tiles of 96, the
    last padded); its neg_thresh is 0.05 (SCALARS_ISLES), so that the cross
    term has pairs;
  * "vnet": the VNet (n_filters 16, filters 16..256; six folded convs, K1,
    K1 dx and K1-dW on the card, every norm a BatchNorm in train mode)
    under the Pancreas step config;
  * "aspp": the UNet3D with ASPP on its bottleneck under the Pancreas step
    config, at patch (32, 32, 32). ASPP's five BatchNorms take statistics
    over the centre of the batch: at (32, 32, 16) that is 2 x 2 x 1 x 4 = 16
    values, and under the noise below the running means of projection.bn1
    and aspp.fuse_bn moved by 1.8-3.3x their tolerance at seeds 0-3 (the
    parameters and momentum by at most 0.64x); at (32, 32, 32), 32 values,
    by at most 0.87x (tests/test_torch_device_check.py). ASPP's own dropout
    (rate 0.5, fixed, as in the JAX layer) draws its masks with numpy in
    call order, the same on both steps (`shared_dropout`);
  * "pancreas_bf16" and "vnet_bf16" (BF16_CONFIGS): the "pancreas" and
    "vnet" cases with `compute_dtype` bfloat16 (K1-bf16, its dx and
    K1-dW-bf16 on the card, the same launch counts), the Pancreas one at
    patch (32, 32, 32), with the tolerances below.

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
a side that was not their own ("taken"). `KinkSides.given` also takes
the sides of a step's foreground threshold p1 > 0.5 (the train Dice),
shared through train/step.py:foreground; the JAX parity tests use it.

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
In the bfloat16 cases each of these becomes max(it, BF16_K x the same
leaf's max |CPU bfloat16 step - CPU float64 step|), BF16_K = 4, and a step
scalar also takes two bfloat16 ulps of its value (2^-8 |value|): the rule of
tests/test_torch_bf16_train.py. A third step, on the CPU in float64 (the
same state and inputs, every conv in float64; the norms' statistics and
the losses in float32, as the model takes them), is the yardstick of
bfloat16's own rounding, and it too takes the card's kink sides within the
margin. Two bfloat16 steps that differ by one ulp at 1e-3 of the folded
conv outputs (the card's K1-bf16 and the CPU's conv round differently at
~1e-4 of them) differ like two independent bfloat16 runs, since every norm
rounds its output again, so a leaf's difference is a draw of that
spread, and two guards keep the draw's tail from failing the check: a
leaf's yardstick is at least its group's median (`bf16_comparisons`), and
the Pancreas case runs at patch (32, 32, 32), where the centre's
InstanceNorm spans 2 x 2 x 2 voxels (at 32 x 32 x 16, 2 x 2 x 1, the
centre's weights reached 7.9x the yardstick at seed 5 under that noise;
at 32^3 the worst leaf over seeds 0-5 is 1.9x, the VNet's 1.6x). Real
faults still fail (tests/test_torch_device_check_bf16.py).
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
from ..models import UNet3DConfig, VNetConfig, build_model, layers
from ..ops import dycon, fecl_fused, resize
from . import step as train_step
from .state import TrainState, create_train_state
from .step import SCALAR_METRICS, StepScalars, build_train_step

PATCH = (32, 32, 16)
PATCHES = {"aspp": (32, 32, 32), "pancreas_bf16": (32, 32, 32)}  # the module doc says why
BATCH, LABELED = 4, 2
SCALARS = StepScalars(5.0, 0.1 * math.exp(-5.0), 1.3, 0.3)
# the ISLES case's neg_thresh: cs between these two random nets' embeddings
# lies within +-0.2, so the training range 0.3..0.5 would leave FeCL's cross
# term empty; at 0.05 about a quarter of all pairs are hard negatives
SCALARS_ISLES = SCALARS._replace(neg_thresh=0.05)
CPU = torch.device("cpu")
CONFIGS = ("pancreas", "isles22", "vnet", "aspp")
BF16_CONFIGS = ("pancreas_bf16", "vnet_bf16")
ISLES_FECL_CHUNK = 96
KINK_MARGIN = 1e-2
BF16_K = 4.0
BF16_ULP = 2.0 ** -8


def step_config(device: torch.device, config: str = "pancreas") -> TrainConfig:
    if config not in CONFIGS + BF16_CONFIGS:
        raise ValueError(f"config {config!r} is not one of {CONFIGS + BF16_CONFIGS}")
    extra = {"isles22": dict(fecl_chunk=ISLES_FECL_CHUNK), "vnet": dict(model="vnet"),
             "aspp": dict(use_aspp=True), "vnet_bf16": dict(model="vnet")}.get(config, {})
    if config in BF16_CONFIGS:
        extra["compute_dtype"] = "bfloat16"
    return make_config("isles22" if config == "isles22" else "pancreas",
                       patch_size=PATCHES.get(config, PATCH),
                       batch_size=BATCH, labeled_bs=LABELED, device=torch.device(device).type,
                       **extra)


def initial_state(seed: int, config: str = "pancreas",
                  compute_dtype: torch.dtype | None = None) -> TrainState:
    """The CPU state of the module doc, its model computing in
    `compute_dtype` (the config's when None)."""
    tcfg = step_config(CPU, config)
    scale = tcfg.feature_scaler
    cd = compute_dtype or tcfg.torch_compute_dtype()
    if tcfg.model == "vnet":
        cfg = VNetConfig(layout="folded", dropout_rate=0.0, scale_factor=scale, compute_dtype=cd)
    else:
        cfg = UNet3DConfig(layout="folded", dropout_rate=0.0, scale_factor=scale,
                           use_aspp=config == "aspp", compute_dtype=cd)
    nets = []
    for s in (seed, seed + 1):
        net = build_model(cfg)
        net.load_state_dict(weights.jax_tree_to_state_dict(*weights.init_jax_tree(cfg, s)))
        nets.append(net)
    state = create_train_state(nets[0])
    state.teacher.load_state_dict(nets[1].state_dict())
    state.step = 1
    return state


@contextlib.contextmanager
def shared_dropout(seed: int):
    """models/layers.dropout drawing its keep masks with numpy from `seed`,
    in call order, where the layer would draw from its generator: the same
    masks on any device."""
    rng = np.random.default_rng(seed)

    def dropout(x, rate, generator, train):
        if not train or rate == 0.0 or generator is None:
            return x
        keep = torch.from_numpy(rng.random(tuple(x.shape)) < 1.0 - rate).to(x.device)
        return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))

    with mock.patch.object(layers, "dropout", dropout):
        yield


def make_inputs(seed: int, config: str = "pancreas") -> tuple[dict[str, np.ndarray], np.ndarray]:
    """A batch of ellipsoid labels with a noisy image at the case's patch,
    and the teacher noise clip(0.1 N(0, 1), +-0.2), from `seed`."""
    rng = np.random.default_rng(seed)
    patch = PATCHES.get(config, PATCH)
    grid = np.stack(np.meshgrid(*[np.arange(s) for s in patch], indexing="ij"), -1)
    labels = []
    for _ in range(BATCH):
        center = rng.uniform(0.3, 0.7, 3) * patch
        radii = rng.uniform(0.3, 0.5, 3) * patch
        labels.append((((grid - center) / radii) ** 2).sum(-1) <= 1.0)
    label = np.stack(labels).astype(np.int32)
    image = (0.4 * label + 0.1 * rng.standard_normal(label.shape)).astype(np.float32)[..., None]
    noise = np.clip(0.1 * rng.standard_normal(image.shape), -0.2, 0.2).astype(np.float32)
    return {"image": image, "label": label}, noise


def state_on(state: TrainState, device: torch.device,
             dtype: torch.dtype | None = None) -> TrainState:
    """A copy of `state` on `device` (its parameters, buffers and momentum
    in `dtype` when given)."""
    kw = {} if dtype is None else dict(dtype=dtype)
    return TrainState(copy.deepcopy(state.student).to(device, **kw),
                      copy.deepcopy(state.teacher).to(device, **kw),
                      {k: v.clone().to(device, **kw) for k, v in state.momentum.items()},
                      int(state.step))


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
    """The bias of a conv followed by an InstanceNorm or BatchNorm: all but
    the heads' (UNet3D final, out_conv2; VNet out_conv, out_conv_sdf)."""
    return key.endswith(".b") and not key.startswith(("final.", "out_conv2.", "out_conv.",
                                                      "out_conv_sdf."))


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


def bf16_comparisons(rows: list[tuple[str, str, float, float]],
                     yardstick: list[tuple[str, str, float, float]],
                     scalars: np.ndarray) -> list[tuple[str, str, float, float]]:
    """`rows` (comparisons of the card's step against the CPU's) with each
    tolerance raised to BF16_K x the same leaf's difference in `yardstick`
    (comparisons of the CPU bfloat16 step against the float64 one), a
    scalar's also to BF16_ULP x `scalars` (the CPU step's value). A leaf's
    yardstick is at least its group's median yardstick in units of the
    float32 tolerance, times its own float32 tolerance: a leaf of a few
    elements (a head's bias) can meet the float64 step by chance."""
    for (group, k, _, _), (group2, k2, _, _) in zip(rows, yardstick, strict=True):
        if (group, k) != (group2, k2):
            raise ValueError(f"yardstick leaf {group2} {k2} against {group} {k}")
    typical = {}
    for group in {r[0] for r in rows} - {"scalar"}:
        typical[group] = float(np.median([y[2] / r[3] for r, y in zip(rows, yardstick)
                                          if r[0] == group and r[3] > 0]))
    out = []
    for (group, k, diff, tol), (_, _, yard, _) in zip(rows, yardstick):
        if group == "scalar":
            floor = BF16_ULP * abs(float(scalars[SCALAR_METRICS.index(k)]))
        else:
            floor, yard = 0.0, max(yard, typical[group] * tol)
        out.append((group, k, diff, max(tol, BF16_K * yard, floor)))
    return out


def _lines(rows, got: TrainState, want: TrainState) -> list[str]:
    out = [f"{group} {k}: max abs diff {diff} > {tol}" for group, k, diff, tol in rows
           if not diff <= tol]
    if int(got.step) != int(want.step):
        out.append(f"step {int(got.step)} vs {int(want.step)}")
    return out


def differences(got: TrainState, got_scalars: np.ndarray, want: TrainState,
                want_scalars: np.ndarray, label: np.ndarray, lr: float) -> list[str]:
    """Each scalar or leaf of `got` outside its tolerance of `want`, as one
    line; the step counts too."""
    return _lines(comparisons(got, got_scalars, want, want_scalars, label, lr), got, want)


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
        self._fg: list[torch.Tensor] = []
        self._cross: dict = {}
        self.counts = dict(relu_near=0, relu_taken=0, pool_near=0, pool_taken=0, cross_near=0,
                           cross_taken=0, fg_near=0, fg_taken=0)

    @classmethod
    def given(cls, relu: list, pool: list, fecl: list, fg: list = ()) -> "KinkSides":
        """Sides recorded elsewhere, in `record()`'s order and form: per
        ReLU call a bool tensor (input > 0), per max pool the argmax over
        its blocks (-1 for a block whose two largest values are equal:
        record() writes it, sides from elsewhere may leave it out), per
        row-tiled FeCL call the (embeddings, teacher embeddings) on the
        CPU, and optionally per step the foreground (probs[..., 1] > 0.5)
        as a bool tensor, which record() does not take (the card check
        allows train_dice one flipped voxel a sample instead); without it
        the CPU step keeps its own. The port's JAX parity tests give the
        JAX step's."""
        sides = cls()
        sides._relu, sides._pool, sides._fecl = list(relu), list(pool), list(fecl)
        sides._fg = list(fg)
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
            xd = _blocks(x.detach(), dims)
            top = xd.topk(2, dim=-1).values
            tie = top[..., 0] == top[..., 1]
            self._pool.append(torch.where(tie, -1, xd.argmax(dim=-1)).cpu())
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
        fecl_calls, fg_sides = iter(self._fecl), iter(self._fg)
        fused, chunked = fecl_fused.fecl_loss_fused, dycon.fecl_loss_chunked
        own_foreground = train_step.foreground
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
            # the max's kink: the two largest of a block within the margin.
            # A block tied on both sides (the device's side -1) keeps the
            # max's own gradient, split evenly over the tie as on the
            # device (in bfloat16 ties are common); a block tied on the
            # device alone keeps its own side
            x = _blocks(x, dims)
            xd = x.detach()
            top = xd.topk(2, dim=-1).values
            own = xd.argmax(dim=-1)
            card = next(pool_sides)
            near = self._near(top[..., 0] - top[..., 1], xd) & (card >= 0)
            side = torch.where(near, card, own)
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
            if "embeddings" not in card:  # the dense FeCL, whose sides are not recorded
                return own
            feat, tfeat = (torch.nn.functional.pad(t, (0, 0, 0, cs.shape[2] - t.shape[1]))
                           for t in card["embeddings"])
            card_side = torch.einsum("btd,bnd->btn", feat[:, rows], tfeat).to(cs.dtype) > neg_t
            near = self._near(cs.detach() - neg_t, cs.detach())
            side = torch.where(near, card_side, own)
            # the twin's forward and backward ask for the same tiles: count once
            self._cross[(card["call"], rows.start)] = (int(near.sum()), int((side != own).sum()))
            return side

        def foreground(probs):
            # the threshold's kink: p1 within the margin of 0.5
            own = own_foreground(probs)
            if not self._fg:
                return own
            gap = probs.detach()[..., 1] - 0.5
            near = self._near(gap, gap)
            side = torch.where(near, next(fg_sides).to(own.device), own)
            self.counts["fg_near"] += int(near.sum())
            self.counts["fg_taken"] += int((side != own).sum())
            return side

        with mock.patch.object(layers, "relu", relu), \
                mock.patch.object(resize, "block_max", block_max), \
                mock.patch.object(fecl_fused, "fecl_loss_fused", shared(fused)), \
                mock.patch.object(dycon, "fecl_loss_chunked", shared(chunked)), \
                mock.patch.object(fecl_fused, "cross_side", cross_side), \
                mock.patch.object(train_step, "foreground", foreground):
            yield self
        if any(next(it, None) is not None
               for it in (relu_sides, pool_sides, fecl_calls, fg_sides)):
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
    batch, noise = make_inputs(seed, config)
    sides = KinkSides()
    got = state_on(state, device)
    with sides.record(), shared_dropout(seed), device_context():
        got_scalars = run_step(got, batch, noise, device, config)
    want = state_on(state, CPU)
    with sides.share(), shared_dropout(seed):
        want_scalars = run_step(want, batch, noise, CPU, config)
    lr = step_config(device, config).base_lr
    label = batch["label"]
    rows = comparisons(got, got_scalars, want, want_scalars, label, lr)
    if config in BF16_CONFIGS:
        # the yardstick: the same step in float64 on the CPU (module doc)
        ref = state_on(initial_state(seed, config, torch.float64), CPU, torch.float64)
        with sides.share(), shared_dropout(seed):
            ref_scalars = run_step(ref, batch, noise, CPU, config)
        rows = bf16_comparisons(rows, comparisons(want, want_scalars, ref, ref_scalars, label,
                                                  lr), want_scalars)
    return _lines(rows, got, want), got_scalars, worst_by_group(rows), sides.counts
