"""K1, the fold-2 3^3 conv kernel, its weight-gradient kernel K1-dW, the
autograd Function over both, and their plain PyTorch versions.

Counterpart of dycon_paper_replication_tpu/ops/folded_conv_pallas.py:
`folded_conv3_pallas` (K1) and the custom VJP `_conv_wf` / `_conv_wf_bwd` /
`_dwf` (FoldedConv3Fn, with K1-dW for the weight half). The kernels are CUDA
C++ for sm_90a in `csrc/folded_conv3.cu` and `csrc/folded_conv3_dw.cu`, each
with two instances: float32 on the tensor cores in three TF32 passes (the
helpers of `csrc/tf32_mma.cuh`) and bfloat16 in one bf16 pass
(`csrc/bf16_mma.cuh`); each header says what bounds it on an H100 and what
the design does about that. They are built with nvcc at first use and bound
with ctypes (see `_build.py`).

Operands are both float32 or both bfloat16, never mixed (a TypeError; the
JAX package casts x and wf to the compute dtype before its kernel). In
bfloat16, as the Pallas kernel and `_conv_wf_bwd` compute it: y and dx
are summed in float32 and stored as bfloat16; dwf is summed in float32 from
the bfloat16 values and rounded to bfloat16 to nearest even
(`_dwf(...).astype(wf.dtype)`).

`folded_conv3(x, wf, to_phase=...)` computes exactly
`folding.folded_conv3` without the bias:
  to_phase=1: x phase-0 at grid G  -> y phase-1 at grid G+1 (pad (1,1))
  to_phase=0: x phase-1 at grid G' -> y phase-0 at grid G'-1 (VALID)
with wf = fold_conv3_weights(w), shape (2, 2, 2, L_in, L_out).

A CPU tensor goes to `folded_conv3_plain`, an `F.conv3d` over the
NCDHW-permuted folded tensor. A CUDA tensor launches the kernel or raises;
there is no fallback. `folded_conv3.launches` counts kernel launches, and
`folded_conv3_dx.launches` those of the same kernel for a backward's dx;
`by_dtype` holds the same counts per instance (torch.float32,
torch.bfloat16), so a run can show which instance ran.

The bfloat16 instances whose L_in is a multiple of 64 run on Hopper's
warpgroup MMA (wgmma) fed by TMA; `k1_bf16_plan` and `dw_bf16_plan` give
their launch shape (tiles, tensor-map boxes and strides, ring depth,
split-K), which the C entries take as arguments and check. L_in = 8 (the
first conv) and any other L_in take the mma.sync instance.

`folded_conv3_dw(x, dy, to_phase=...)` is the weight gradient of that conv,
dwf[t] = sum_q x[q + off + t] (x) dy[q] with off = -1 (to_phase=1) or 0;
`folded_conv3_dw.launches` counts its launches. `FoldedConv3Fn` is the
differentiable conv: forward K1; backward dx = K1 in the opposite phase with
the taps flipped and transposed (skipped when x needs no gradient), and
dwf = K1-dW.
"""

from __future__ import annotations

import ctypes
import dataclasses
import itertools
import math

import torch
import torch.nn.functional as F

from . import _build

SOURCE = _build.CSRC / "folded_conv3.cu"
DW_SOURCE = _build.CSRC / "folded_conv3_dw.cu"


DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}


def check_operand_dtypes(name: str, a: torch.Tensor, b: torch.Tensor) -> torch.dtype:
    """The common dtype of a kernel's two operands: both float32 or both
    bfloat16, else TypeError (mixed operands are never upcast)."""
    if a.dtype != b.dtype or a.dtype not in DTYPES:
        raise TypeError(f"{name}: operands must be both float32 or both bfloat16, got "
                        f"{a.dtype} and {b.dtype}")
    return a.dtype


def cast_operands(x: torch.Tensor, w: torch.Tensor, compute_dtype: torch.dtype | None):
    """A conv's (x, w) in `compute_dtype`, or w in x's dtype when it is None
    (the JAX layers' casts)."""
    if compute_dtype is not None:
        x = x.to(compute_dtype)
    return x, w.to(x.dtype)


def library_conv(fn, x: torch.Tensor, w: torch.Tensor, **kwargs) -> torch.Tensor:
    """fn (F.conv3d or F.conv_transpose3d) of x and w, in their dtype. A
    bfloat16 conv on the CPU is computed in float32 from the bfloat16 values
    and rounded once, which is what a bfloat16 conv computes (exact
    products, float32 sums; its gradients rounded the same way through the
    casts): oneDNN's own bfloat16 conv3d weight gradient returned
    non-finite values in PyTorch 2.11 on an x86 host (256 channels over a
    2 x 2 x 1 input, the VNet's centre), which PyTorch 2.13 does not."""
    if x.dtype == torch.bfloat16 and x.device.type == "cpu":
        return fn(x.float(), w.float(), **kwargs).to(x.dtype)
    return fn(x, w, **kwargs)


def folded_conv3_plain(x: torch.Tensor, wf: torch.Tensor, *, to_phase: int) -> torch.Tensor:
    """The same function through F.conv3d: (B,G1,G2,G3,Li) x (2,2,2,Li,Lo)
    -> (B,Q1,Q2,Q3,Lo), padding 1 (to_phase=1) or 0 (to_phase=0), in the
    operands' dtype (a bfloat16 conv sums in float32 and rounds once; on
    the CPU through library_conv)."""
    y = library_conv(F.conv3d, x.permute(0, 4, 1, 2, 3), wf.permute(4, 3, 0, 1, 2),
                     padding=1 if to_phase == 1 else 0)
    return y.permute(0, 2, 3, 4, 1).contiguous()


def _check_dense(name: str, *ts: torch.Tensor) -> None:
    if not all(t.is_contiguous() for t in ts):
        raise ValueError(f"{name}: operands must be contiguous")
    if any(t.data_ptr() % 16 for t in ts):
        raise ValueError(f"{name}: operands must be 16-byte aligned")


def _dense(t: torch.Tensor) -> torch.Tensor:
    """`t` contiguous and 16-byte aligned (a copy only where it is not):
    autograd may hand over an expanded or offset gradient."""
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


class _Counted:
    """Launch counts of a wrapper, per dtype instance in `by_dtype`;
    `launches` is their sum, and setting it to 0 clears them all."""

    def __init__(self):
        self.by_dtype = dict.fromkeys(DTYPES, 0)
        self._fns = {}

    @property
    def launches(self) -> int:
        return sum(self.by_dtype.values())

    @launches.setter
    def launches(self, n: int) -> None:
        if n != 0:
            raise ValueError("launch counts are only reset, to 0")
        self.by_dtype = dict.fromkeys(DTYPES, 0)

    def _function(self, src, stem: str, dtype: torch.dtype, argtypes: list):
        if dtype not in self._fns:
            self._fns[dtype] = _build.function(src, f"{stem}_{DTYPES[dtype]}", argtypes)
        return self._fns[dtype]


# The wgmma instances of K1-bf16 and K1-dW-bf16 (csrc/folded_conv3.cu,
# csrc/folded_conv3_dw.cu): TMA boxes of 64 lanes (one 128-byte row, the
# 128B swizzle's), grids cut into segments of at most 64 output columns,
# K1 tiles of at most 256 output rows in padded row order, K1-dW voxel
# tiles of about 256 voxels, at most 227 KB of shared memory a block.
WG_LANES = 64
WG_SEG = 64
K1_WG_ROWS = 256
WF_SLOT_BYTES = 16_384
WF_SLOTS_MAX = 4
DW_WG_VOXELS = 256
DW_SLOTS_MAX = 4
# The most voxels one K1-dW-bf16 split sums into one float32 partial before
# the split sum's rounded adds (tests/test_torch_bf16_mma.py: the wgmma's
# truncated sums over such a chunk stay within a quarter of the gate's room)
DW_WG_MAX_CHUNK = 131_072
SMEM_LIMIT = 232_448
TMA_BOX_MAX = 256


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _segments(q3: int) -> tuple[int, int]:
    """(segment width sw, segments) of an output row of q3 columns: equal
    segments of at most WG_SEG columns."""
    sw = _cdiv(q3, _cdiv(q3, WG_SEG))
    return sw, _cdiv(q3, sw)


def _even_rows(q2: int, most: int) -> tuple[int, int]:
    """(rows per tile, tiles) of q2 rows, at most `most` a tile, as even as
    the tile count allows."""
    tiles = _cdiv(q2, max(1, min(most, q2)))
    return _cdiv(q2, tiles), tiles


def _bf16_map(dims: tuple, box: tuple) -> tuple[tuple, tuple]:
    """(byte strides of dims 1.., box) of a bf16 tensor map over `dims`
    (innermost first) with a 128B swizzle, checked as cuTensorMapEncodeTiled
    and the kernels require: strides 16-byte multiples below 2^40, box dims
    1 to 256, the innermost 64 lanes (128 bytes)."""
    strides = tuple(2 * math.prod(dims[:i + 1]) for i in range(len(dims) - 1))
    if any(s % 16 or s >= 2 ** 40 for s in strides):
        raise ValueError(f"tensor map over {dims}: strides {strides} out of range")
    if any(not 1 <= n <= TMA_BOX_MAX for n in box) or box[0] != WG_LANES:
        raise ValueError(f"tensor map over {dims}: box {box} out of range")
    return strides, tuple(box)


@dataclasses.dataclass(frozen=True)
class K1Bf16Plan:
    """K1-bf16's wgmma launch: segments of `sw` output columns, tiles of
    `rows` padded rows of sw + 1 columns, a halo slot of `halo_rows` 128-byte
    rows (two slots) and `wf_slots` wf slots of 16 KB; the tensor maps' dims
    (innermost first), byte strides and boxes (x's and wf's loads, y's
    stores); the tiles (segments x row tiles, 128-lane tiles, planes
    B * Q1), a block each; the shared memory."""
    sw: int
    rows: int
    halo_rows: int
    wf_slots: int
    x_dims: tuple
    x_strides: tuple
    x_box: tuple
    wf_dims: tuple
    wf_strides: tuple
    wf_box: tuple
    y_dims: tuple
    y_strides: tuple
    y_box: tuple
    tiles: tuple
    smem_bytes: int

    @property
    def args(self) -> tuple:
        return self.sw, self.rows, self.halo_rows, self.wf_slots


def k1_bf16_plan(x_shape: tuple, lout: int, to_phase: int) -> K1Bf16Plan | None:
    """The wgmma launch of K1-bf16 on x (B, G1, G2, G3, L_in) to L_out lanes,
    or None where L_in is no multiple of 64 (the mma.sync instance). Raises
    ValueError on a shape the launch cannot take."""
    b, g1, g2, g3, lin = x_shape
    if lin % WG_LANES:
        return None
    q1, q2, q3 = (g + (1 if to_phase == 1 else -1) for g in (g1, g2, g3))
    if min(q1, q2, q3) < 1 or lout % 128 or b * q1 > 65535:
        raise ValueError(f"k1_bf16_plan: x {tuple(x_shape)} to {lout} lanes out of range")
    sw, nseg = _segments(q3)
    wv = sw + 1
    rows, htiles = _even_rows(q2, K1_WG_ROWS // wv)
    hr = (rows + 1) * wv
    # the box (2 d-planes of hr rows) and the rows the taps read past the tile
    halo_rows = 8 * _cdiv(max(2 * hr, K1_WG_ROWS + hr + wv + 1), 8)
    fixed = 1024 + 2 * halo_rows * 128 + 8 * 4
    wf_slots = min(WF_SLOTS_MAX, (SMEM_LIMIT - fixed) // (WF_SLOT_BYTES + 16))
    if wf_slots < 2:
        raise ValueError(f"k1_bf16_plan: x {tuple(x_shape)}: no room for the wf ring")
    x_dims = (lin, g3, g2, g1, b)
    x_strides, x_box = _bf16_map(x_dims, (WG_LANES, wv, rows + 1, 2, 1))
    wf_dims = (lout, 8 * lin)
    wf_strides, wf_box = _bf16_map(wf_dims, (64, 64))
    y_dims = (lout, q3, q2, q1, b)
    y_strides, y_box = _bf16_map(y_dims, (64, sw, rows, 1, 1))
    return K1Bf16Plan(sw, rows, halo_rows, wf_slots, x_dims, x_strides, x_box, wf_dims,
                      wf_strides, wf_box, y_dims, y_strides, y_box,
                      (nseg * htiles, lout // 128, b * q1),
                      fixed + wf_slots * (WF_SLOT_BYTES + 16))


class FoldedConv3(_Counted):
    """The K1 wrapper: checks its operands, allocates the output, launches
    the instance of the operands' dtype on the current stream and counts
    launches."""

    def _kernel(self, dtype: torch.dtype):
        plan_ints = 4 if dtype == torch.bfloat16 else 0  # K1-bf16's plan (k1_bf16_plan.args)
        return self._function(SOURCE, "dycon_folded_conv3", dtype,
                              [ctypes.c_void_p] * 3 + [ctypes.c_int] * (7 + plan_ints)
                              + [ctypes.c_void_p])

    def __call__(self, x: torch.Tensor, wf: torch.Tensor, *, to_phase: int) -> torch.Tensor:
        if x.device.type == "cpu":
            return folded_conv3_plain(x, wf, to_phase=to_phase)
        return self.launch(x, wf, to_phase=to_phase)

    def launch(self, x: torch.Tensor, wf: torch.Tensor, *, to_phase: int) -> torch.Tensor:
        if not torch.cuda.is_available():
            raise RuntimeError("folded_conv3: CUDA is not available")
        if x.device.type != "cuda" or wf.device != x.device:
            raise ValueError(f"folded_conv3: x and wf must be on one CUDA device, got "
                             f"{x.device} and {wf.device}")
        dtype = check_operand_dtypes("folded_conv3", x, wf)
        if to_phase not in (0, 1):
            raise ValueError(f"folded_conv3: to_phase must be 0 or 1, got {to_phase}")
        if x.dim() != 5 or wf.dim() != 5 or tuple(wf.shape[:3]) != (2, 2, 2):
            raise ValueError(f"folded_conv3: bad shapes {tuple(x.shape)}, {tuple(wf.shape)}")
        b, g1, g2, g3, lin = x.shape
        lout = wf.shape[4]
        if wf.shape[3] != lin or lin % 8 or lout % 128:
            raise ValueError(f"folded_conv3: need L_in % 8 == 0 and L_out % 128 == 0, got "
                             f"x {tuple(x.shape)}, wf {tuple(wf.shape)}")
        q = [g + (1 if to_phase == 1 else -1) for g in (g1, g2, g3)]
        # grid z is B * Q1: 8 * 57 = 456 at the Pancreas training shapes
        if min(q) < 1 or b * q[0] > 65535:
            raise ValueError(f"folded_conv3: grid {tuple(x.shape[:4])} out of range")
        _check_dense("folded_conv3", x, wf)
        plan = ()
        if dtype == torch.bfloat16:
            wg = k1_bf16_plan(tuple(x.shape), lout, to_phase)
            plan = wg.args if wg is not None else (0, 0, 0, 0)
        y = torch.empty((b, *q, lout), device=x.device, dtype=dtype)
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = self._kernel(dtype)(x.data_ptr(), wf.data_ptr(), y.data_ptr(),
                                      b, g1, g2, g3, lin, lout, to_phase, *plan, stream)
        if err != 0:
            raise RuntimeError(f"folded_conv3: kernel launch failed, cudaError {err}")
        self.by_dtype[dtype] += 1
        return y


folded_conv3 = FoldedConv3()
# The same kernel for the backward's dx, with its own launch count.
folded_conv3_dx = FoldedConv3()


def folded_conv3_dw_plain(x: torch.Tensor, dy: torch.Tensor, *, to_phase: int) -> torch.Tensor:
    """The weight gradient as the JAX package's `_dwf` computes it: eight
    einsums of a tap-shifted slab of x against dy, in float32 (float64 for
    float64 operands), then in x's dtype. x (B, G1, G2, G3, Li), dy (B, Q1,
    Q2, Q3, Lo) -> dwf (2, 2, 2, Li, Lo)."""
    q1, q2, q3 = dy.shape[1:4]
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    xs = F.pad(x, (0, 0, 1, 1, 1, 1, 1, 1)) if to_phase == 1 else x
    xs, dyf = xs.to(acc), dy.to(acc)
    taps = [torch.einsum("bdhwa,bdhwn->an", xs[:, td:td + q1, th:th + q2, tw:tw + q3], dyf)
            for td, th, tw in itertools.product(range(2), repeat=3)]
    return torch.stack(taps).reshape(2, 2, 2, x.shape[-1], dy.shape[-1]).to(x.dtype)


# K1-dW's launch shape (csrc/folded_conv3_dw.cu): 128-lane column tiles,
# row tiles of 128 where L_in % 16 == 0 else 64, 32 voxels per stage, and
# __launch_bounds__(256, 1): one block resident per SM.
DW_STAGE_VOXELS = 32
DW_BLOCKS_PER_SM = 1


def dw_tiles(lin: int, lout: int) -> int:
    """K1-dW's output tiles of one split: (8 L_in / row tile) x (L_out / 128)."""
    return 8 * lin // (128 if lin % 16 == 0 else 64) * (lout // 128)


def _wave_splits(tiles: int, sms: int) -> int:
    """Of 1 to 4 full waves of the card's resident blocks (one per SM), the
    split count whose last wave is fullest, the fewest on a tie: the splits
    are equal, so an idle slot in the last wave is time lost."""
    slots = DW_BLOCKS_PER_SM * sms
    least = -(-slots // tiles)

    def fill(s: int) -> float:
        return tiles * s / (-(-tiles * s // slots) * slots)

    return max(range(least, 4 * least + 1), key=lambda s: (fill(s), -s))


def dw_splits(n_voxels: int, tiles: int, sms: int) -> tuple[int, int]:
    """(splits, chunk) of K1-dW's split-K over `n_voxels`, each split a
    whole number of 32-voxel stages and none empty, the split count by
    _wave_splits."""
    want = _wave_splits(tiles, sms)
    chunk = -(-n_voxels // want)
    chunk = -(-chunk // DW_STAGE_VOXELS) * DW_STAGE_VOXELS
    return -(-n_voxels // chunk), chunk


@dataclasses.dataclass(frozen=True)
class DwBf16Plan:
    """K1-dW-bf16's wgmma launch: voxel tiles of `rows` rows of `sw`
    columns of one (b, qd) plane of dy (`ntiles` of them, `kpad` = the
    tile's voxels rounded up to 16), `chunk` tiles per split over `splits`
    splits, a ring of `slots` stages of `stage_bytes`; the tensor maps' dims
    (innermost first), byte strides and boxes; the grid and shared memory."""
    sw: int
    rows: int
    ntiles: int
    kpad: int
    splits: int
    chunk: int
    slots: int
    stage_bytes: int
    x_dims: tuple
    x_strides: tuple
    x_box: tuple
    dy_dims: tuple
    dy_strides: tuple
    dy_box: tuple
    grid: tuple
    smem_bytes: int

    @property
    def args(self) -> tuple:
        return self.splits, self.chunk, self.sw, self.rows, self.slots

    @property
    def chunk_voxels(self) -> int:
        """The most voxels one split sums, padding included."""
        return self.chunk * self.kpad


def dw_bf16_plan(x_shape: tuple, lout: int, to_phase: int, sms: int) -> DwBf16Plan | None:
    """The wgmma launch of K1-dW-bf16 on x (B, G1, G2, G3, L_in) and dy at
    the grid to_phase gives, L_out lanes, on a card of `sms` SMs; None where
    L_in is no multiple of 64 (the mma.sync instance). Raises ValueError on
    a shape the launch cannot take."""
    b, g1, g2, g3, lin = x_shape
    if lin % WG_LANES:
        return None
    q1, q2, q3 = (g + (1 if to_phase == 1 else -1) for g in (g1, g2, g3))
    if min(q1, q2, q3) < 1 or lout % 128:
        raise ValueError(f"dw_bf16_plan: x {tuple(x_shape)} to {lout} lanes out of range")
    sw, nseg = _segments(q3)
    most = max(1, DW_WG_VOXELS // sw)
    while True:  # the most rows whose stage leaves room for a ring of 2
        rows, htiles = _even_rows(q2, most)
        kpad = 16 * _cdiv(rows * sw, 16)
        xrows = 8 * _cdiv((rows + 1) * (sw + 1) + 1, 8)  # the box and a zero row
        stage_bytes = (xrows + 2 * kpad) * 128
        slots = min(DW_SLOTS_MAX, (SMEM_LIMIT - 1024) // (stage_bytes + 16))
        if slots >= 2 or rows == 1:
            break
        most = rows - 1
    if slots < 2:
        raise ValueError(f"dw_bf16_plan: x {tuple(x_shape)}: no room for the ring")
    ntiles = b * q1 * htiles * nseg
    tiles = 2 * (lin // WG_LANES) * (lout // 128)
    chunk = min(_cdiv(ntiles, _wave_splits(tiles, sms)), max(1, DW_WG_MAX_CHUNK // kpad))
    splits = _cdiv(ntiles, chunk)
    if splits > 65535:
        raise ValueError(f"dw_bf16_plan: x {tuple(x_shape)}: {splits} splits out of range")
    x_dims = (lin, g3, g2, g1, b)
    x_strides, x_box = _bf16_map(x_dims, (WG_LANES, sw + 1, rows + 1, 1, 1))
    dy_dims = (lout, q3, q2, q1, b)
    dy_strides, dy_box = _bf16_map(dy_dims, (64, sw, rows, 1, 1))
    return DwBf16Plan(sw, rows, ntiles, kpad, splits, chunk, slots, stage_bytes, x_dims,
                      x_strides, x_box, dy_dims, dy_strides, dy_box,
                      (2 * (lin // WG_LANES), lout // 128, splits),
                      1024 + slots * (stage_bytes + 16))


class FoldedConv3Dw(_Counted):
    """The K1-dW wrapper: checks its operands, allocates the output and the
    split-K workspace, launches the instance of the operands' dtype on the
    current stream and counts launches."""

    def _kernel(self, dtype: torch.dtype):
        plan_ints = 3 if dtype == torch.bfloat16 else 0  # sw, rows, slots (dw_bf16_plan)
        return self._function(DW_SOURCE, "dycon_folded_conv3_dw", dtype,
                              [ctypes.c_void_p] * 4 + [ctypes.c_int] * (9 + plan_ints)
                              + [ctypes.c_void_p])

    def __call__(self, x: torch.Tensor, dy: torch.Tensor, *, to_phase: int) -> torch.Tensor:
        if x.device.type == "cpu":
            return folded_conv3_dw_plain(x, dy, to_phase=to_phase)
        return self.launch(x, dy, to_phase=to_phase)

    def launch(self, x: torch.Tensor, dy: torch.Tensor, *, to_phase: int) -> torch.Tensor:
        if not torch.cuda.is_available():
            raise RuntimeError("folded_conv3_dw: CUDA is not available")
        if x.device.type != "cuda" or dy.device != x.device:
            raise ValueError(f"folded_conv3_dw: x and dy must be on one CUDA device, got "
                             f"{x.device} and {dy.device}")
        dtype = check_operand_dtypes("folded_conv3_dw", x, dy)
        if to_phase not in (0, 1):
            raise ValueError(f"folded_conv3_dw: to_phase must be 0 or 1, got {to_phase}")
        if x.dim() != 5 or dy.dim() != 5:
            raise ValueError(f"folded_conv3_dw: bad shapes {tuple(x.shape)}, {tuple(dy.shape)}")
        b, g1, g2, g3, lin = x.shape
        lout = dy.shape[4]
        step = 1 if to_phase == 1 else -1
        q = (g1 + step, g2 + step, g3 + step)
        if (tuple(dy.shape[:4]) != (b, *q) or min(q) < 1 or lin % 8 or lout % 128):
            raise ValueError(f"folded_conv3_dw: need dy at grid G{step:+d}, L_in % 8 == 0 and "
                             f"L_out % 128 == 0, got x {tuple(x.shape)}, dy {tuple(dy.shape)}")
        n_voxels = b * q[0] * q[1] * q[2]
        if n_voxels * max(lin, lout) >= 2 ** 31:
            raise ValueError(f"folded_conv3_dw: {n_voxels} voxels out of range")
        _check_dense("folded_conv3_dw", x, dy)
        sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        wg = dw_bf16_plan(tuple(x.shape), lout, to_phase, sms) if dtype == torch.bfloat16 \
            else None
        if wg is not None:
            args = wg.args
        else:
            args = dw_splits(n_voxels, dw_tiles(lin, lout), sms)
            args += (0, 0, 0) if dtype == torch.bfloat16 else ()
        splits = args[0]
        ws = torch.empty((splits, 8 * lin, lout), device=x.device, dtype=torch.float32)
        dwf = torch.empty((2, 2, 2, lin, lout), device=x.device, dtype=dtype)
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = self._kernel(dtype)(x.data_ptr(), dy.data_ptr(), ws.data_ptr(),
                                      dwf.data_ptr(), b, g1, g2, g3, lin, lout, to_phase,
                                      *args, stream)
        if err != 0:
            raise RuntimeError(f"folded_conv3_dw: kernel launch failed, cudaError {err}")
        self.by_dtype[dtype] += 1
        return dwf


folded_conv3_dw = FoldedConv3Dw()


class FoldedConv3Fn(torch.autograd.Function):
    """y = folded_conv3(x, wf, to_phase), differentiable in x and wf.

    Backward, the identities of the JAX package's `_conv_wf_bwd`:
      dx  = folded_conv3_dx(dy, flip(wf, taps).swap(L_in, L_out), 1 - to_phase),
            only when x needs a gradient (the first conv's input is the image;
            its L_in of 8 is no K1 output width);
      dwf = folded_conv3_dw(x, dy, to_phase).
    On a CPU tensor both are the plain versions; on a CUDA tensor K1 and
    K1-dW, or an error. x and wf share their dtype (float32 or bfloat16),
    and so do dx and dwf."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, wf: torch.Tensor, to_phase: int) -> torch.Tensor:
        ctx.to_phase = to_phase
        ctx.save_for_backward(x, wf)
        return folded_conv3(x, wf, to_phase=to_phase)

    @staticmethod
    def backward(ctx, dy: torch.Tensor):
        x, wf = ctx.saved_tensors
        dy = _dense(dy)
        dx = dwf = None
        if ctx.needs_input_grad[0]:
            wf_t = wf.flip(0, 1, 2).transpose(3, 4).contiguous()
            dx = folded_conv3_dx(dy, wf_t, to_phase=1 - ctx.to_phase)
        if ctx.needs_input_grad[1]:
            dwf = folded_conv3_dw(x, dy, to_phase=ctx.to_phase)
        return dx, dwf, None


class K1ValuedPlainConvFn:
    """Stands in for FoldedConv3Fn where its gradients are checked: gradients
    by autograd of `folded_conv3_plain`, forward values K1's. Equal forward
    values keep both sides' ReLU masks equal: a float32 difference of 1e-5
    between two conv forwards flips a few of ~10^7 ReLUs, and a flipped one
    moves dx at its voxel by O(1), which says nothing of the backward under
    test. Its K1 launches go to its own wrapper, not to `folded_conv3`'s."""

    k1 = FoldedConv3()

    @staticmethod
    def apply(x: torch.Tensor, wf: torch.Tensor, to_phase: int) -> torch.Tensor:
        y = folded_conv3_plain(x, wf, to_phase=to_phase)
        k1 = K1ValuedPlainConvFn.k1(x.detach(), wf.detach(), to_phase=to_phase)
        return y + (k1 - y).detach()
