"""K1, the fold-2 3^3 conv kernel, its weight-gradient kernel K1-dW, the
autograd Function over both, and their plain PyTorch versions.

Counterpart of dycon_paper_replication_tpu/ops/folded_conv_pallas.py:
`folded_conv3_pallas` (K1) and the custom VJP `_conv_wf` / `_conv_wf_bwd` /
`_dwf` (FoldedConv3Fn, with K1-dW for the weight half). The kernels are CUDA
C++ for sm_90a in `csrc/folded_conv3.cu` and `csrc/folded_conv3_dw.cu`, both
on the tensor cores in three TF32 passes with the helpers of
`csrc/tf32_mma.cuh`; each header says what bounds it on an H100 and what the
design does about that.
They are built with nvcc at first use and bound with ctypes (see
`_build.py`).

`folded_conv3(x, wf, to_phase=...)` computes exactly
`folding.folded_conv3` without the bias:
  to_phase=1: x phase-0 at grid G  -> y phase-1 at grid G+1 (pad (1,1))
  to_phase=0: x phase-1 at grid G' -> y phase-0 at grid G'-1 (VALID)
with wf = fold_conv3_weights(w), shape (2, 2, 2, L_in, L_out).

A CPU tensor goes to `folded_conv3_plain`, an `F.conv3d` over the
NCDHW-permuted folded tensor. A CUDA tensor launches the kernel or raises;
there is no fallback. `folded_conv3.launches` counts kernel launches, and
`folded_conv3_dx.launches` those of the same kernel for a backward's dx.

`folded_conv3_dw(x, dy, to_phase=...)` is the weight gradient of that conv,
dwf[t] = sum_q x[q + off + t] (x) dy[q] with off = -1 (to_phase=1) or 0;
`folded_conv3_dw.launches` counts its launches. `FoldedConv3Fn` is the
differentiable conv: forward K1; backward dx = K1 in the opposite phase with
the taps flipped and transposed (skipped when x needs no gradient), and
dwf = K1-dW.
"""

from __future__ import annotations

import ctypes
import itertools

import torch
import torch.nn.functional as F

from . import _build

SOURCE = _build.CSRC / "folded_conv3.cu"
DW_SOURCE = _build.CSRC / "folded_conv3_dw.cu"


def folded_conv3_plain(x: torch.Tensor, wf: torch.Tensor, *, to_phase: int) -> torch.Tensor:
    """The same function through F.conv3d: (B,G1,G2,G3,Li) x (2,2,2,Li,Lo)
    -> (B,Q1,Q2,Q3,Lo), padding 1 (to_phase=1) or 0 (to_phase=0)."""
    y = F.conv3d(
        x.permute(0, 4, 1, 2, 3),
        wf.permute(4, 3, 0, 1, 2),
        padding=1 if to_phase == 1 else 0,
    )
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


class FoldedConv3:
    """The K1 wrapper: checks its operands, allocates the output, launches
    on the current stream and counts launches."""

    def __init__(self):
        self.launches = 0
        self._fn = None

    def _kernel(self):
        if self._fn is None:
            self._fn = _build.function(SOURCE, "dycon_folded_conv3_f32",
                                       [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7
                                       + [ctypes.c_void_p])
        return self._fn

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
        if x.dtype != torch.float32 or wf.dtype != torch.float32:
            raise TypeError(f"folded_conv3: float32 only, got {x.dtype} and {wf.dtype}")
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
        y = torch.empty((b, *q, lout), device=x.device, dtype=torch.float32)
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = self._kernel()(x.data_ptr(), wf.data_ptr(), y.data_ptr(),
                                 b, g1, g2, g3, lin, lout, to_phase, stream)
        if err != 0:
            raise RuntimeError(f"folded_conv3: kernel launch failed, cudaError {err}")
        self.launches += 1
        return y


folded_conv3 = FoldedConv3()
# The same kernel for the backward's dx, with its own launch count.
folded_conv3_dx = FoldedConv3()


def folded_conv3_dw_plain(x: torch.Tensor, dy: torch.Tensor, *, to_phase: int) -> torch.Tensor:
    """The weight gradient as the JAX package's `_dwf` computes it: eight
    einsums of a tap-shifted slab of x against dy. x (B, G1, G2, G3, Li),
    dy (B, Q1, Q2, Q3, Lo) -> dwf (2, 2, 2, Li, Lo), in x's dtype."""
    q1, q2, q3 = dy.shape[1:4]
    xs = F.pad(x, (0, 0, 1, 1, 1, 1, 1, 1)) if to_phase == 1 else x
    taps = [torch.einsum("bdhwa,bdhwn->an", xs[:, td:td + q1, th:th + q2, tw:tw + q3], dy)
            for td, th, tw in itertools.product(range(2), repeat=3)]
    return torch.stack(taps).reshape(2, 2, 2, x.shape[-1], dy.shape[-1])


# K1-dW's launch shape (csrc/folded_conv3_dw.cu): 128-lane column tiles,
# row tiles of 128 where L_in % 16 == 0 else 64, 32 voxels per stage, and
# __launch_bounds__(256, 1): one block resident per SM.
DW_STAGE_VOXELS = 32
DW_BLOCKS_PER_SM = 1


def dw_tiles(lin: int, lout: int) -> int:
    """K1-dW's output tiles of one split: (8 L_in / row tile) x (L_out / 128)."""
    return 8 * lin // (128 if lin % 16 == 0 else 64) * (lout // 128)


def dw_splits(n_voxels: int, tiles: int, sms: int) -> tuple[int, int]:
    """(splits, chunk) of K1-dW's split-K over `n_voxels`, each split a
    whole number of 32-voxel stages and none empty. Of 1 to 4 full waves of
    the card's resident blocks (DW_BLOCKS_PER_SM x `sms`), the split count
    whose last wave is fullest, the fewest on a tie: the splits are equal,
    so an idle slot in the last wave is time lost."""
    slots = DW_BLOCKS_PER_SM * sms
    least = -(-slots // tiles)

    def fill(s: int) -> float:
        return tiles * s / (-(-tiles * s // slots) * slots)

    want = max(range(least, 4 * least + 1), key=lambda s: (fill(s), -s))
    chunk = -(-n_voxels // want)
    chunk = -(-chunk // DW_STAGE_VOXELS) * DW_STAGE_VOXELS
    return -(-n_voxels // chunk), chunk


class FoldedConv3Dw:
    """The K1-dW wrapper: checks its operands, allocates the output and the
    split-K workspace, launches on the current stream and counts launches."""

    def __init__(self):
        self.launches = 0
        self._fn = None

    def _kernel(self):
        if self._fn is None:
            self._fn = _build.function(DW_SOURCE, "dycon_folded_conv3_dw_f32",
                                       [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
                                       + [ctypes.c_void_p])
        return self._fn

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
        if x.dtype != torch.float32 or dy.dtype != torch.float32:
            raise TypeError(f"folded_conv3_dw: float32 only, got {x.dtype} and {dy.dtype}")
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
        tiles = dw_tiles(lin, lout)
        sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        splits, chunk = dw_splits(n_voxels, tiles, sms)
        ws = torch.empty((splits, 8 * lin, lout), device=x.device, dtype=torch.float32)
        dwf = torch.empty((2, 2, 2, lin, lout), device=x.device, dtype=torch.float32)
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = self._kernel()(x.data_ptr(), dy.data_ptr(), ws.data_ptr(), dwf.data_ptr(),
                                 b, g1, g2, g3, lin, lout, to_phase, splits, chunk, stream)
        if err != 0:
            raise RuntimeError(f"folded_conv3_dw: kernel launch failed, cudaError {err}")
        self.launches += 1
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
    K1-dW, or an error."""

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
