"""K1, the fold-2 3^3 conv kernel, and its plain PyTorch version.

Counterpart of dycon_paper_replication_tpu/ops/folded_conv_pallas.py
(`folded_conv3_pallas`). The kernel is CUDA C++ for sm_90a in
`csrc/folded_conv3.cu`; its header says what bounds it on an H100 and what
the design does about that. It is built with nvcc at first use and bound
with ctypes (see `_build.py`).

`folded_conv3(x, wf, to_phase=...)` computes exactly
`folding.folded_conv3` without the bias:
  to_phase=1: x phase-0 at grid G  -> y phase-1 at grid G+1 (pad (1,1))
  to_phase=0: x phase-1 at grid G' -> y phase-0 at grid G'-1 (VALID)
with wf = fold_conv3_weights(w), shape (2, 2, 2, L_in, L_out).

A CPU tensor goes to `folded_conv3_plain`, an `F.conv3d` over the
NCDHW-permuted folded tensor. A CUDA tensor launches the kernel or raises;
there is no fallback. `folded_conv3.launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build

SOURCE = _build.CSRC / "folded_conv3.cu"


def folded_conv3_plain(x: torch.Tensor, wf: torch.Tensor, *, to_phase: int) -> torch.Tensor:
    """The same function through F.conv3d: (B,G1,G2,G3,Li) x (2,2,2,Li,Lo)
    -> (B,Q1,Q2,Q3,Lo), padding 1 (to_phase=1) or 0 (to_phase=0)."""
    y = F.conv3d(
        x.permute(0, 4, 1, 2, 3),
        wf.permute(4, 3, 0, 1, 2),
        padding=1 if to_phase == 1 else 0,
    )
    return y.permute(0, 2, 3, 4, 1).contiguous()


class FoldedConv3:
    """The K1 wrapper: checks its operands, allocates the output, launches
    on the current stream and counts launches."""

    def __init__(self):
        self.launches = 0
        self._fn = None

    def _kernel(self):
        if self._fn is None:
            fn = _build.load(SOURCE).dycon_folded_conv3_f32
            fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            self._fn = fn
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
        if min(q) < 1 or b * q[0] > 65535:
            raise ValueError(f"folded_conv3: grid {tuple(x.shape[:4])} out of range")
        if not (x.is_contiguous() and wf.is_contiguous()):
            raise ValueError("folded_conv3: x and wf must be contiguous")
        if x.data_ptr() % 16 or wf.data_ptr() % 16:
            raise ValueError("folded_conv3: x and wf must be 16-byte aligned")
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
