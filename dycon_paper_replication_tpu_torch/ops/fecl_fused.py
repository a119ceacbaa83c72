"""FeCL with a closed-form backward: the plain twin and the kernel K2.

Counterpart of dycon_paper_replication_tpu/ops/fecl_fused.py
(`fecl_loss_fused`, built from `_build`: `_phi_psi`, the forward
`_per_item_fwd`, `_pos_count`, `_fwd_value` and the backward `core_bwd`).

The math (the quirks of ops/dycon.py's dense FeCL kept):

  per row i:  L_ij = (f_i . f_j) / tau with the diagonal zeroed,
  M_j = max_i L_ij (no gradient), E = exp(L - M), S_i = sum_j E_ij diff_ij,
  v_ij = E_ij / (E_ij + S_i + eps),
  student row term = sum_{j same class, j != i} phi(v_ij),
  phi(v) = -log(v + eps) c(v), c(v) = (1 - v)^gamma if v < pos_thresh else 1
  (focal; c == 1 unfocal or with gambling weights);
  cross term over pairs of different class with cs_ij = f_i . t_j > neg_thresh:
  mean of -log(max(1 - cs, 0) + eps).

With psi = phi'(v) and den = E + S + eps the gradient is

  dL_ij = a_i [same_ij off_ij psi_ij (S_i + eps) E_ij / den_ij^2 + rho_i diff_ij E_ij]
  rho_i = sum_k same_ik off_ik psi_ik (-E_ik / den_ik^2)
  dF    = dL F / tau + dcs T + dL^T F / tau,  dcs_ij = g_cross / (max(1 - cs, 0) + eps)
          on the pairs (diff, neg_thresh < cs < 1)

where a_i folds the upstream cotangent, the 1/(B N) mean, the positive-count
normaliser and the optional gambling weight. The forward keeps only O(B N)
residuals (M, S, rho, the unfocal row sums, w, the cross count), so the
backward is one more pass over the pairs. The teacher's cotangent is zero by
design: the train step passes detached teacher embeddings. `mask` must be
binary {0, 1} (the step's thresholded mask): the positive counts come from
the class histogram.

Two implementations of the passes, picked by the device of `feat`:
  * a CPU tensor runs the plain twin (`_twin_forward`, `_twin_backward`):
    the JAX tile loops in torch ops, over row tiles of `row_chunk` with the
    row axis padded to a multiple of it (sentinel class -1, zero rows,
    `n_valid`), exactly as the JAX function pads;
  * a CUDA tensor runs K2 (csrc/fecl_fused.cu, nvcc + ctypes, see
    `_build.py`), which works at the true N and ignores `row_chunk`: three
    launches forward (column max, S, the row terms), one backward (both
    halves of dF: dL_ij and dL_ji come from one dot product), every
    B x N x N x D product on the tensor cores in three TF32 passes. Its
    column max is L's row max (L is symmetric, its 3xTF32 products are
    not bit for bit): the twin's column max within float32 rounding, and
    saved for the backward as the twin's is. It raises where it cannot
    run; nothing on the card calls the twin.
`fecl_fwd.launches` and `fecl_bwd.launches` count K2's calls, one per
forward and one per backward, whatever number of kernels each launches.

A hook for the card-against-CPU step check (train/device_check.py):
`cross_side`, when set, decides the `cs > neg_thresh` test for the pairs
of a tile, in the twin and in ops/dycon.py's `fecl_loss_chunked` and
`fecl_loss` (whose one tile is all rows): it lets the CPU step take the
card's side, or a test JAX's, at pairs within a stated margin of the
threshold. It is None outside those checks.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from . import _build

SOURCE = _build.CSRC / "fecl_fused.cu"
EPS = 1e-18
# K2's feature width, the projection head's output (one template instance)
K2_WIDTH = 256

# set only by kink sharing (module doc): (row slice, cs tile (B, T, N),
# neg_t, own side (cs > neg_t)) -> the side to use
cross_side = None


class FeclOptions(NamedTuple):
    temperature: float
    gamma: float
    focal: bool  # focal weighting in effect: use_focal and no gambling weights
    pos_thresh: float
    neg_thresh: float
    lambda_cross: float
    row_chunk: int


def _phi_psi(v: torch.Tensor, pos_t, gamma: float, focal: bool):
    """phi(v), the row loss term, and psi(v) = phi'(v)."""
    logv = torch.log(v + EPS)
    if not focal:
        return -logv, -1.0 / (v + EPS)
    hard = v < pos_t
    c = torch.where(hard, (1.0 - v) ** gamma, torch.ones_like(v))
    dc = torch.where(hard, -gamma * (1.0 - v) ** (gamma - 1.0), torch.zeros_like(v))
    return -logv * c, -c / (v + EPS) - logv * dc


def _thresh(value: float, dtype: torch.dtype) -> torch.Tensor:
    """A threshold as the JAX function holds it: a float32 scalar (then
    widened to `dtype`)."""
    return torch.tensor(float(np.float32(value)), dtype=dtype)


def _above(rows: slice, cs: torch.Tensor, neg_t: torch.Tensor) -> torch.Tensor:
    side = cs > neg_t
    return side if cross_side is None else cross_side(rows, cs, neg_t, side)


def _pad(feat, mask, tfeat, row_chunk: int):
    """The JAX padding: the row axis up to a multiple of `row_chunk` with
    zero rows of sentinel class -1. Returns (feat, mask, tfeat, n_valid)."""
    b, n, _ = feat.shape
    pad = -n % row_chunk
    mask = mask.to(feat.dtype)
    if pad:
        feat = torch.nn.functional.pad(feat, (0, 0, 0, pad))
        mask = torch.cat([mask, torch.full((b, pad), -1.0, dtype=feat.dtype,
                                           device=feat.device)], dim=1)
        if tfeat is not None:
            tfeat = torch.nn.functional.pad(tfeat, (0, 0, 0, pad))
    return feat, mask, tfeat, n


def _twin_forward(feat, mask, tfeat, o: FeclOptions):
    """The forward passes in torch ops (JAX `_per_item_fwd`, batched):
    (col_max, S, row_sums, row_sums_unf, rho, c_sum, c_cnt), each (B, N)."""
    b, n, _ = feat.shape
    feat, mask, tfeat, n_valid = _pad(feat, mask, tfeat, o.row_chunk)
    npad = feat.shape[1]
    t = o.row_chunk
    dt = feat.dtype
    ids = torch.arange(npad, device=feat.device)
    col_valid = (ids < n_valid).to(dt)
    pos_t, neg_t = _thresh(o.pos_thresh, dt), _thresh(o.neg_thresh, dt)

    col_max = torch.full((b, npad), -torch.inf, dtype=dt, device=feat.device)
    for k in range(npad // t):
        rows = slice(k * t, (k + 1) * t)
        lt = torch.einsum("btd,bnd->btn", feat[:, rows], feat) / o.temperature
        lt = lt * (ids[rows, None] != ids[None, :]).to(dt)
        col_max = torch.maximum(col_max, lt.amax(dim=1))

    outs = {k: [] for k in ("s", "row", "unf", "rho", "csum", "ccnt")}
    for k in range(npad // t):
        rows = slice(k * t, (k + 1) * t)
        same = (mask[:, rows, None] == mask[:, None, :]).to(dt)
        off = (ids[rows, None] != ids[None, :]).to(dt)
        diff = (1.0 - same) * col_valid
        lt = torch.einsum("btd,bnd->btn", feat[:, rows], feat) / o.temperature
        lt = lt * off
        e = torch.exp(lt - col_max[:, None, :])
        s_row = (e * diff).sum(-1)
        den = e + s_row[..., None] + EPS
        v = e / den
        phi, psi = _phi_psi(v, pos_t, o.gamma, o.focal)
        so = same * off
        outs["s"].append(s_row)
        outs["row"].append((phi * so).sum(-1))
        outs["unf"].append((-torch.log(v + EPS) * so).sum(-1))
        outs["rho"].append((so * psi * (-e / (den * den))).sum(-1))
        if tfeat is None:
            zero = torch.zeros_like(s_row)
            outs["csum"].append(zero)
            outs["ccnt"].append(zero)
            continue
        cs = torch.einsum("btd,bnd->btn", feat[:, rows], tfeat)
        hard = (diff > 0) & _above(rows, cs, neg_t) & (ids[rows] < n_valid)[None, :, None]
        gap = torch.clamp_min(1.0 - cs, 0.0)
        outs["csum"].append(torch.where(hard, -torch.log(gap + EPS),
                                        torch.zeros_like(cs)).sum(-1))
        outs["ccnt"].append(hard.to(dt).sum(-1))
    cat = {k: torch.cat(v, dim=1)[:, :n] for k, v in outs.items()}
    return (col_max[:, :n], cat["s"], cat["row"], cat["unf"], cat["rho"], cat["csum"],
            cat["ccnt"])


def _twin_backward(feat, mask, tfeat, col_max, s_all, rho_all, a_all, g_cross,
                   o: FeclOptions) -> torch.Tensor:
    """dF by the closed form in torch ops (JAX `core_bwd`'s tile pass)."""
    n = feat.shape[1]
    feat, mask, tfeat, n_valid = _pad(feat, mask, tfeat, o.row_chunk)
    pad = feat.shape[1] - n
    col_max, s_all, rho_all, a_all = (torch.nn.functional.pad(v, (0, pad))
                                      for v in (col_max, s_all, rho_all, a_all))
    npad = feat.shape[1]
    t = o.row_chunk
    dt = feat.dtype
    ids = torch.arange(npad, device=feat.device)
    col_valid = (ids < n_valid).to(dt)
    pos_t, neg_t = _thresh(o.pos_thresh, dt), _thresh(o.neg_thresh, dt)

    dcols = torch.zeros_like(feat)
    drows = []
    for k in range(npad // t):
        rows = slice(k * t, (k + 1) * t)
        f_t = feat[:, rows]
        same = (mask[:, rows, None] == mask[:, None, :]).to(dt)
        off = (ids[rows, None] != ids[None, :]).to(dt)
        diff = (1.0 - same) * col_valid
        lt = torch.einsum("btd,bnd->btn", f_t, feat) / o.temperature
        lt = lt * off
        e = torch.exp(lt - col_max[:, None, :])
        s_t = s_all[:, rows, None]
        den = e + s_t + EPS
        v = e / den
        _, psi = _phi_psi(v, pos_t, o.gamma, o.focal)
        dl = a_all[:, rows, None] * (same * off * psi * (s_t + EPS) * e / (den * den)
                                     + rho_all[:, rows, None] * diff * e)
        dr = torch.einsum("btn,bnd->btd", dl, feat) / o.temperature
        if tfeat is not None:
            cs = torch.einsum("btd,bnd->btn", f_t, tfeat)
            hard = ((diff > 0) & _above(rows, cs, neg_t) & (cs < 1.0)
                    & (ids[rows] < n_valid)[None, :, None])
            gap = torch.clamp_min(1.0 - cs, 0.0)
            dcs = torch.where(hard, g_cross / (gap + EPS), torch.zeros_like(cs))
            dr = dr + torch.einsum("btn,bnd->btd", dcs, tfeat)
        dcols = dcols + torch.einsum("btn,btd->bnd", dl, f_t) / o.temperature
        drows.append(dr)
    return (dcols + torch.cat(drows, dim=1))[:, :n]


def _check_k2_operands(name: str, feat, mask, tfeat, *vectors):
    if not torch.cuda.is_available():
        raise RuntimeError(f"{name}: CUDA is not available")
    if feat.device.type != "cuda":
        raise ValueError(f"{name}: feat must be a CUDA tensor, got {feat.device}")
    if feat.dim() != 3:
        raise ValueError(f"{name}: feat must be (B, N, D), got {tuple(feat.shape)}")
    b, n, d = feat.shape
    if d != K2_WIDTH:
        raise ValueError(f"{name}: feature width D must be {K2_WIDTH}, got {d}")
    if b > 65535 or n * d >= 2 ** 31:
        raise ValueError(f"{name}: shape {tuple(feat.shape)} out of range")
    others = [t for t in (mask, tfeat, *vectors) if t is not None]
    if any(t.device != feat.device for t in others):
        raise ValueError(f"{name}: all operands must be on {feat.device}")
    if any(t.dtype != torch.float32 for t in (feat, *others)):
        raise TypeError(f"{name}: float32 only")
    if tfeat is not None and tfeat.shape != feat.shape:
        raise ValueError(f"{name}: teacher_feat {tuple(tfeat.shape)} != feat "
                         f"{tuple(feat.shape)}")
    if any(tuple(v.shape) != (b, n) for v in (mask, *vectors)):
        raise ValueError(f"{name}: mask and per-row vectors must be (B, N) = {(b, n)}")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in (feat, *others)):
        raise ValueError(f"{name}: operands must be contiguous and 16-byte aligned")


class FeclForward:
    """K2's forward wrapper: checks its operands, allocates the seven (B, N)
    outputs, launches its three kernels on the current stream and counts
    one call."""

    def __init__(self):
        self.launches = 0
        self._fn = None

    def _kernel(self):
        if self._fn is None:
            self._fn = _build.function(SOURCE, "dycon_fecl_fwd_f32",
                                       [ctypes.c_void_p] * 10 + [ctypes.c_int] * 3
                                       + [ctypes.c_float] * 4 + [ctypes.c_int, ctypes.c_void_p])
        return self._fn

    def __call__(self, feat, mask, tfeat, o: FeclOptions):
        if feat.device.type == "cpu":
            return _twin_forward(feat, mask, tfeat, o)
        return self.launch(feat, mask, tfeat, o)

    def launch(self, feat, mask, tfeat, o: FeclOptions):
        _check_k2_operands("fecl_fwd", feat, mask, tfeat)
        b, n, d = feat.shape
        out = [torch.empty((b, n), device=feat.device, dtype=torch.float32) for _ in range(7)]
        with torch.cuda.device(feat.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = self._kernel()(feat.data_ptr(), 0 if tfeat is None else tfeat.data_ptr(),
                                 mask.data_ptr(), *(t.data_ptr() for t in out),
                                 b, n, d, o.temperature, o.gamma, o.pos_thresh, o.neg_thresh,
                                 int(o.focal), stream)
        if err != 0:
            raise RuntimeError(f"fecl_fwd: kernel launch failed, cudaError {err}")
        self.launches += 1
        return tuple(out)


class FeclBackward:
    """K2's backward wrapper: dF from the forward's residuals; launches its
    kernel on the current stream and counts one call."""

    def __init__(self):
        self.launches = 0
        self._fn = None

    def _kernel(self):
        if self._fn is None:
            self._fn = _build.function(SOURCE, "dycon_fecl_bwd_f32",
                                       [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3
                                       + [ctypes.c_float] * 4 + [ctypes.c_int, ctypes.c_float,
                                                                 ctypes.c_void_p])
        return self._fn

    def __call__(self, feat, mask, tfeat, col_max, s_all, rho_all, a_all, g_cross: float,
                 o: FeclOptions):
        if feat.device.type == "cpu":
            return _twin_backward(feat, mask, tfeat, col_max, s_all, rho_all, a_all, g_cross, o)
        return self.launch(feat, mask, tfeat, col_max, s_all, rho_all, a_all, g_cross, o)

    def launch(self, feat, mask, tfeat, col_max, s_all, rho_all, a_all, g_cross: float,
               o: FeclOptions):
        _check_k2_operands("fecl_bwd", feat, mask, tfeat, col_max, s_all, rho_all, a_all)
        b, n, d = feat.shape
        dfeat = torch.empty_like(feat)
        with torch.cuda.device(feat.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = self._kernel()(feat.data_ptr(), 0 if tfeat is None else tfeat.data_ptr(),
                                 mask.data_ptr(), col_max.data_ptr(), s_all.data_ptr(),
                                 rho_all.data_ptr(), a_all.data_ptr(), dfeat.data_ptr(),
                                 b, n, d, o.temperature, o.gamma, o.pos_thresh, o.neg_thresh,
                                 int(o.focal), float(g_cross), stream)
        if err != 0:
            raise RuntimeError(f"fecl_bwd: kernel launch failed, cudaError {err}")
        self.launches += 1
        return dfeat


fecl_fwd = FeclForward()
fecl_bwd = FeclBackward()


def _row_weights(mask: torch.Tensor) -> torch.Tensor:
    """w_i = 1 / (rows sharing row i's class, minus i), 0 where there are
    none; from the class histogram of the binary mask (JAX `_pos_count`)."""
    n1 = (mask == 1).sum(dim=1, keepdim=True).to(mask.dtype)
    n0 = (mask == 0).sum(dim=1, keepdim=True).to(mask.dtype)
    pos = torch.where(mask > 0, n1, n0) - 1.0
    return torch.where(pos > 0, 1.0 / pos.clamp_min(1.0), torch.zeros_like(pos))


class FeclFusedFn(torch.autograd.Function):
    """The fused FeCL value with its closed-form backward (module doc).
    forward(feat, mask, teacher_feat or None, gambling weights or None,
    options) -> the scalar loss; the gradient reaches feat and the gambling
    weights, and is zero for the teacher embeddings. The cross term's
    cotangent goes to the backward pass as a host float, one device sync
    in the backward."""

    @staticmethod
    def forward(ctx, feat, mask, tfeat, gamb, o: FeclOptions, shard=None):
        b, n, _ = feat.shape
        b = b if shard is None else shard.global_batch  # the mean's batch
        feat = feat.contiguous()
        mask = mask.to(feat.dtype).contiguous()
        tfeat = None if tfeat is None else tfeat.contiguous()
        col_max, s_all, row_sums, row_unf, rho, c_sum, c_cnt = fecl_fwd(feat, mask, tfeat, o)
        w = _row_weights(mask)
        if gamb is not None:
            row_mean = row_unf * w * gamb
        elif o.focal:
            row_mean = row_sums * w
        else:
            row_mean = row_unf * w
        loss = row_mean.sum() / (b * n)
        cnt_total = c_cnt.sum()
        if shard is not None:
            cnt_total = shard.all_sum_(cnt_total)
        if tfeat is not None:
            loss = loss + o.lambda_cross * c_sum.sum() / (cnt_total + EPS)
        ctx.options = o
        ctx.batch = b
        ctx.has_teacher = tfeat is not None
        ctx.save_for_backward(feat, mask, tfeat, gamb, col_max, s_all, rho, row_unf, w,
                              cnt_total)
        return loss

    @staticmethod
    def backward(ctx, gbar):
        feat, mask, tfeat, gamb, col_max, s_all, rho, row_unf, w, cnt_total = ctx.saved_tensors
        o = ctx.options
        b, n = ctx.batch, feat.shape[1]
        a_all = (gbar / (b * n)) * w
        if gamb is not None:
            a_all = a_all * gamb
        g_cross = float(gbar * o.lambda_cross / (cnt_total + EPS)) if ctx.has_teacher else 0.0
        dfeat = fecl_bwd(feat, mask, tfeat, col_max, s_all, rho, a_all.contiguous(), g_cross, o)
        dgamb = (gbar / (b * n)) * row_unf * w if gamb is not None else None
        dtfeat = torch.zeros_like(tfeat) if ctx.needs_input_grad[2] else None
        return dfeat, None, dtfeat, dgamb, None, None


def fecl_loss_fused(feat: torch.Tensor, mask: torch.Tensor,
                    teacher_feat: torch.Tensor | None = None,
                    gambling_uncertainty: torch.Tensor | None = None, *,
                    temperature: float = 0.6, gamma: float = 2.0, use_focal: bool = True,
                    pos_thresh: float = 1.5, neg_thresh: float = 0.5,
                    lambda_cross: float = 1.0, row_chunk: int = 512,
                    shard=None) -> torch.Tensor:
    """FeCL's value with the analytic backward; the value and the
    feat-gradient of `ops.dycon.fecl_loss` / `fecl_loss_chunked`, the
    teacher's cotangent zero. feat, teacher_feat (B, N, D) L2-normalised;
    mask (B, N) binary; gambling_uncertainty (B, N) or None. `row_chunk` is
    the twin's row tile (any N: the rows are padded), which K2 ignores.
    With `shard` (a data-parallel step) this rank's term of the global
    value, as ops.dycon.fecl_loss gives it."""
    o = FeclOptions(float(temperature), float(gamma),
                    bool(use_focal) and gambling_uncertainty is None,
                    float(pos_thresh), float(neg_thresh), float(lambda_cross), int(row_chunk))
    return FeclFusedFn.apply(feat, mask, teacher_feat, gambling_uncertainty, o, shard)
