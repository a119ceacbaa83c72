"""The numeric argument of K1-dW's three TF32 passes, on the CPU.

K1-dW (dycon_paper_replication_tpu_torch/ops/csrc/folded_conv3_dw.cu) runs
its float32 GEMM on the TF32 tensor cores: each operand v is split into
hi = rna_tf32(v) (to nearest, ties away) and lo = v - hi truncated to TF32,
each product accumulates lo_a*hi_b + hi_a*lo_b + hi_a*hi_b, a stage's
products go into a fresh float32 sum that is added into the split's
running one, and the split-K partials are summed in split order. Here that
arithmetic is emulated in plain torch (TF32 rounding and truncation by
integer ops on the float32 bits, float32 products and sums) over a long
contraction, and held to the gate that `chip_smoke.py` and
`tests/test_torch_cuda.py` hold the kernel to against a float64 dW:
max(1e-4 x max|ref|, 4 x the float32 plain version's error). Three passes
meet it, at the float32 plain version's own error; one TF32 pass does not.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)
VOXELS = 262_144  # the contraction: ~1/5 of a Pancreas training dW's
CHUNK = 2_416  # voxels per split-K partial
STAGE = 32  # voxels per stage of the kernel's ring


def _rna_tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest value with 10 mantissa bits, ties away from
    zero (cvt.rna.tf32.f32): add half of the 13 dropped bits' range to the
    bit pattern, then clear them."""
    return ((t.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _trunc_tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 -> TF32 by dropping the 13 low mantissa bits."""
    return (t.view(torch.int32) & -0x2000).view(torch.float32)


def _dw_tf32(x: torch.Tensor, dy: torch.Tensor, passes: int) -> torch.Tensor:
    """x^T dy as K1-dW computes it: per split of CHUNK voxels a float32
    partial; per stage a fresh float32 sum of its products in the kernel's
    order (lo*hi, hi*lo, hi*hi), or hi*hi alone for one pass, added into
    the partial; the partials summed in split order."""
    xh, dh = _rna_tf32(x), _rna_tf32(dy)
    xl, dl = _trunc_tf32(x - xh), _trunc_tf32(dy - dh)
    terms = [(xh, dh)] if passes == 1 else [(xl, dh), (xh, dl), (xh, dh)]
    out = torch.zeros(x.shape[1], dy.shape[1])
    for s0 in range(0, x.shape[0], CHUNK):
        part = torch.zeros_like(out)
        for s in range(s0, min(s0 + CHUNK, x.shape[0]), STAGE):
            e = min(s + STAGE, s0 + CHUNK)
            stage = torch.zeros_like(out)
            for a, b in terms:
                stage = stage + a[s:e].T @ b[s:e]
            part = part + stage
        out = out + part
    return out


def test_rna_tf32_rounds_to_ten_mantissa_bits():
    one_ulp = 2.0 ** -10  # TF32's ulp at 1
    v = torch.tensor([1.0, 1 + one_ulp / 2, 1 + one_ulp / 2 - 2 ** -23, -(1 + one_ulp / 2),
                      3.0, -1.5])
    want = torch.tensor([1.0, 1 + one_ulp, 1.0, -(1 + one_ulp), 3.0, -1.5])
    assert torch.equal(_rna_tf32(v), want)
    r = torch.from_numpy(np.random.default_rng(0).standard_normal(4096).astype(np.float32))
    hi = _rna_tf32(r)
    lo = _trunc_tf32(r - hi)
    assert not (hi.view(torch.int32) & 0x1FFF).any() and not (lo.view(torch.int32) & 0x1FFF).any()
    assert ((hi - r).abs() <= 2.0 ** -11 * r.abs()).all()
    # hi + lo carries 21 or more bits of r: within 2^-21 relative
    assert ((hi.double() + lo.double() - r.double()).abs() <= 2.0 ** -21 * r.abs().double()).all()


def test_split_keeps_nan_and_inf_non_finite():
    """A NaN whose top mantissa bits are set (CUDA's canonical NaN among
    them) rounds to a zero hi; its lo, truncated, stays NaN."""
    bits = torch.tensor([0x7FFFFFFF, -1, 0x7FC00000, 0x7F800001, 0x7F800000, -0x800000],
                        dtype=torch.int32)
    v = bits.view(torch.float32)
    hi = _rna_tf32(v)
    lo = _trunc_tf32(v - hi)
    assert not (torch.isfinite(hi) & torch.isfinite(lo)).any()


@pytest.mark.parametrize("passes,meets", [(3, True), (1, False)])
def test_tf32_passes_against_the_k1_dw_gate(passes, meets):
    """x (VOXELS, 4) and dy (VOXELS, 16) standard normal, as the smoke's
    inputs: three passes meet the gate, and sit within 4x of the float32
    plain version's own error; one pass misses the gate."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((VOXELS, 4), np.float32))
    dy = torch.from_numpy(rng.standard_normal((VOXELS, 16), np.float32))
    ref = x.double().T @ dy.double()
    err_plain = ((x.T @ dy).double() - ref).abs().max().item()
    gate = max(1e-4 * ref.abs().max().item(), 4 * err_plain)
    err = (_dw_tf32(x, dy, passes).double() - ref).abs().max().item()
    if meets:
        assert err <= 4 * err_plain <= gate, (err, err_plain, gate)
    else:
        assert err > gate, (err, gate)
