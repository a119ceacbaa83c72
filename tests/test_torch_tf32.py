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

K1 (ops/csrc/folded_conv3.cu) runs the split with lo rounded to nearest
too, over a shorter contraction, K = 8 L_in (tap, lane), which raises the
question that decides its accumulators: how often does a fresh sum start?
The tensor core does not round its float32 sums to nearest, so here each
m16n8k8 product is emulated as the hardware is modelled: the 8 products
exact, the sum and the 8 products aligned to the largest of them with 3
bits below float32's last (truncated), added exactly, and the result
truncated toward zero to float32. Held to K1's gate, 1e-4 x max|y| against
float64: three passes into the running sum meet it but use half of it at
L_in 768; one pass misses it; a fresh sum per stage of 8 taps (K1's) or per
tap meets it at the float32 plain version's max error. In rms a stage's sum
of 24 truncated products drifts to 1.5-3.6x the float32 plain version's
error, a tap's stays at it.
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


def _rn_lo(r: torch.Tensor) -> torch.Tensor:
    """K1's lo (split_tf32_rn): rounded to nearest where r is finite,
    truncated where it is not."""
    finite = (r.view(torch.int32) & 0x7F800000) != 0x7F800000
    return torch.where(finite, _rna_tf32(r), _trunc_tf32(r))


def test_split_keeps_nan_and_inf_non_finite():
    """A NaN whose top mantissa bits are set (CUDA's canonical NaN among
    them) rounds to a zero hi; its lo, truncated, stays NaN."""
    bits = torch.tensor([0x7FFFFFFF, -1, 0x7FC00000, 0x7F800001, 0x7F800000, -0x800000],
                        dtype=torch.int32)
    v = bits.view(torch.float32)
    hi = _rna_tf32(v)
    lo = _trunc_tf32(v - hi)
    assert not (torch.isfinite(hi) & torch.isfinite(lo)).any()


def test_k1_split_keeps_nan_and_inf_non_finite():
    """K1's split rounds lo to nearest where v - hi is finite; where v is a
    NaN or an Inf, v - hi is not, and lo stays non-finite. A finite v keeps
    hi + lo within 2^-22 of it."""
    bits = torch.tensor([0x7FFFFFFF, -1, 0x7FC00000, 0x7F800001, 0x7F800000, -0x800000],
                        dtype=torch.int32)
    v = bits.view(torch.float32)
    hi = _rna_tf32(v)
    assert not (torch.isfinite(hi) & torch.isfinite(_rn_lo(v - hi))).any()
    r = torch.from_numpy(np.random.default_rng(1).standard_normal(4096).astype(np.float32))
    hi = _rna_tf32(r)
    lo = _rn_lo(r - hi)
    assert not (lo.view(torch.int32) & 0x1FFF).any()
    assert ((hi.double() + lo.double() - r.double()).abs() <= 2.0 ** -22 * r.abs().double()).all()


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


K1_STAGE_TAPS = 8  # taps (of 8 lanes each) per stage of K1's ring


def _mma_rz(c: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """c + a @ b for one 16x8x8 TF32 tile as the tensor core is modelled
    (module doc): c (M, N) float32, a (M, 8) and b (8, N) TF32 values."""
    terms = torch.cat([c.double()[:, None], a.double()[:, :, None] * b.double()[None]], 1)
    _, e = torch.frexp(terms.abs().amax(1, keepdim=True))
    quantum = torch.ldexp(torch.ones_like(terms), e - 27)  # 3 bits below float32's last
    f = (torch.trunc(terms / quantum) * quantum).sum(1)
    r = f.float()
    return torch.where(r.double().abs() > f.abs(), torch.nextafter(r, torch.zeros_like(r)), r)


def _k1_tf32(x: torch.Tensor, w: torch.Tensor, passes: int, taps_per_sum: int | None
             ) -> torch.Tensor:
    """x (M, K) @ w (K, N) as K1 computes it: each operand split into hi and
    lo, both rounded to nearest; K in taps of 8 lanes, each tap's passes (lo*hi, hi*lo, hi*hi, or hi*hi alone) as modelled mma
    products; a fresh sum every `taps_per_sum` taps, added into the running
    one by a float32 add, or (None) every product straight into the
    running sum."""
    xh, wh = _rna_tf32(x), _rna_tf32(w)
    xl, wl = _rna_tf32(x - xh), _rna_tf32(w - wh)  # K1 rounds lo too (split_tf32_rn)
    terms = [(xh, wh)] if passes == 1 else [(xl, wh), (xh, wl), (xh, wh)]
    out = torch.zeros(x.shape[0], w.shape[1])
    step = 8 * (taps_per_sum or K1_STAGE_TAPS)
    for s in range(0, x.shape[1], step):
        acc = out if taps_per_sum is None else torch.zeros_like(out)
        for k in range(s, s + step, 8):
            for a, b in terms:
                acc = _mma_rz(acc, a[:, k:k + 8], b[k:k + 8])
        out = acc if taps_per_sum is None else out + acc
    return out


def _k1_case(lin: int, voxels: int):
    """x (voxels, 8 L_in) standard normal, w (8 L_in, 8) scaled by
    1/sqrt(8 L_in) as the smoke's wf, and x @ w in float64."""
    rng = np.random.default_rng(lin)
    k = 8 * lin
    x = torch.from_numpy(rng.standard_normal((voxels, k), np.float32))
    w = torch.from_numpy((rng.standard_normal((k, 8)) / np.sqrt(k)).astype(np.float32))
    return x, w, x.double() @ w.double()


VARIANTS = {"stage sums": (3, K1_STAGE_TAPS), "tap sums": (3, 1), "running sum": (3, None),
            "one pass": (1, K1_STAGE_TAPS)}


@pytest.mark.parametrize("lin", [128, 768])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_k1_tf32_against_its_gate(variant, lin):
    """Over 256 output voxels and 8 lanes, against float64 with K1's gate
    1e-4 x max|ref|: fresh sums per stage (K1's choice) or per tap within
    4x of the float32 plain version's max error; the running sum within the
    gate, but above a quarter of it at L_in 768; one pass outside it."""
    x, w, ref = _k1_case(lin, 256)
    err_plain = ((x @ w).double() - ref).abs().max().item()
    gate = 1e-4 * ref.abs().max().item()
    err = (_k1_tf32(x, w, *VARIANTS[variant]).double() - ref).abs().max().item()
    if variant in ("tap sums", "stage sums"):
        assert err <= 4 * err_plain <= gate, (err, err_plain, gate)
    elif variant == "running sum":
        assert 20 * err_plain < err <= gate, (err, err_plain, gate)
        assert err > gate / 4 if lin == 768 else err < gate / 4, (err, gate)
    else:
        assert err > gate, (err, gate)


@pytest.mark.parametrize("lin", [8, 128])
def test_k1_fresh_sums_rms_error(lin):
    """Over 1024 output voxels, the rms error against float64: a fresh sum
    per stage (K1's) within 4x of the float32 plain version's, and at least
    twice that of a fresh sum per tap, which stays within 1.25x of it."""
    x, w, ref = _k1_case(lin, 1024)

    def rms(y):
        return (y.double() - ref).square().mean().sqrt().item()

    plain = rms(x @ w)
    stage, tap = (rms(_k1_tf32(x, w, 3, n)) for n in (K1_STAGE_TAPS, 1))
    assert stage <= 4 * plain and stage >= 2 * tap and tap <= 1.25 * plain, (stage, tap, plain)
