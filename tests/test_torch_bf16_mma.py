"""The numeric argument of the bf16 wgmma kernels' float32 sums, on the CPU.

K1-bf16 (dycon_paper_replication_tpu_torch/ops/csrc/folded_conv3.cu) and
K1-dW-bf16 (csrc/folded_conv3_dw.cu), at L_in % 64 == 0, multiply bf16
operands on the tensor cores with wgmma m64n128k16 into float32 sums. The
product of two bf16 values is exact in float32, but the tensor core does not
round its sums to nearest. Each k16 step is emulated here as
tests/test_torch_tf32.py models an mma.sync: the sum and the step's products
aligned to the largest of them with 3 bits below float32's last, truncated,
added exactly, and the result truncated toward zero to float32 ("k16"); the
harsher variant "k8" does the same per half step, twice the truncations.

The question is how often a fresh sum must start, to be added into a running
sum by a float add rounded to nearest (the "promotion interval", in k16
steps). The kernels promote never: K1 keeps one running sum over its whole
contraction K = 8 L_in, and K1-dW one over each split of its voxels, whose
float32 partials the split sum then adds in split order, rounded. Here that
choice is held to the gate that chip_smoke.py holds the kernels to against a
float64 reference of the same bf16 values, max(2^-8 max|ref|, 2 x the plain
bf16 version's error), with a margin of 4: the float32 error before the bf16
store is at most a quarter of the room that the gate leaves above one bf16
rounding (gate - the plain version's error). A fresh sum every 4 steps (one
64-lane tap of K1, like the mma.sync instances' stage sums) is the
comparison.
"""

import numpy as np
import pytest
import torch

from dycon_paper_replication_tpu_torch.ops.folded_conv_cuda import dw_bf16_plan

torch.set_num_threads(1)
BF = torch.bfloat16


def _bf16(a: np.ndarray) -> torch.Tensor:
    """float32 values rounded to bf16, held as float32."""
    return torch.from_numpy(a.astype(np.float32)).to(BF).float()


def _step_rz(c: torch.Tensor, a: torch.Tensor, b: torch.Tensor, group: int) -> torch.Tensor:
    """c + a @ b over one k16 step as the tensor core is modelled (module
    doc): c (..., M, N) float32, a (..., M, 16) and b (..., 16, N) bf16
    values, `group` products (16 or 8) aligned and truncated together."""
    for g0 in range(0, a.shape[-1], group):
        prods = a[..., g0:g0 + group, None].double() * b[..., None, g0:g0 + group, :].double()
        terms = torch.cat([c.double()[..., None, :], prods], -2)  # (..., M, 1 + group, N)
        _, e = torch.frexp(terms.abs().amax(-2, keepdim=True))
        quantum = torch.ldexp(torch.ones_like(terms), e - 27)
        f = (torch.trunc(terms / quantum) * quantum).sum(-2)
        r = f.float()
        c = torch.where(r.double().abs() > f.abs(), torch.nextafter(r, torch.zeros_like(r)), r)
    return c


def _gemm_rz(a: torch.Tensor, b: torch.Tensor, group: int, every: int | None) -> torch.Tensor:
    """a (..., M, K) @ b (..., K, N) in k16 steps, the sums as modelled; a
    fresh sum every `every` steps added into the running one rounded to
    nearest, or (None) every step straight into the running sum."""
    out = torch.zeros(*a.shape[:-1], b.shape[-1])
    acc = out
    for i, k in enumerate(range(0, a.shape[-1], 16)):
        if every is not None and i % every == 0:
            out = out + acc if i else out
            acc = torch.zeros_like(out)
        acc = _step_rz(acc, a[..., k:k + 16], b[..., k:k + 16, :], group)
    return acc if every is None else out + acc


def _gate(ref: torch.Tensor, plain_err: float) -> float:
    return max(2.0 ** -8 * ref.abs().max().item(), 2 * plain_err)


def _check(sums: torch.Tensor, ref: torch.Tensor):
    """The margin rule (module doc) and the gate on the bf16 store."""
    plain_err = (ref.float().to(BF).double() - ref).abs().max().item()
    gate = _gate(ref, plain_err)
    delta = (sums.double() - ref).abs().max().item()
    err = (sums.to(BF).double() - ref).abs().max().item()
    assert delta > 0 and 4 * delta <= gate - plain_err and err <= gate, (delta, err, plain_err,
                                                                          gate)
    return delta, gate - plain_err


def test_bf16_products_are_exact_in_float32():
    rng = np.random.default_rng(0)
    a, b = _bf16(rng.standard_normal(4096)), _bf16(rng.standard_normal(4096))
    assert torch.equal((a * b).double(), a.double() * b.double())


def test_step_model_truncates():
    """One k16 step of the model: exact where nothing is shifted out; with
    terms of one sign never above the exact sum in magnitude; within a few
    float32 ulps of the largest term otherwise."""
    ones = torch.ones(1, 16)
    assert _step_rz(torch.zeros(1, 1), ones, ones.T, 16).item() == 16.0
    rng = np.random.default_rng(1)
    c = torch.from_numpy(rng.uniform(50, 100, (8, 4)).astype(np.float32))
    a, b = _bf16(rng.uniform(0.5, 2, (8, 16))), _bf16(rng.uniform(0.5, 2, (16, 4)))
    exact = c.double() + a.double() @ b.double()
    for group in (16, 8):
        got = _step_rz(c, a, b, group).double()
        assert (got <= exact).all() and (got >= exact * (1 - 2.0 ** -21)).all()
    c, a, b = c * torch.tensor([1.0, -1.0, 1.0, -1.0]), a - 1.25, b - 1.25
    exact = c.double() + a.double() @ b.double()
    top = torch.cat([c.double().abs()[:, None], (a.double()[:, :, None] * b.double()[None]).abs()],
                    1).amax(1)
    assert ((_step_rz(c, a, b, 16).double() - exact).abs() <= top * 2.0 ** -20).all()


@pytest.mark.parametrize("model", {"k16": 16, "k8": 8}.items(), ids=["k16", "k8"])
@pytest.mark.parametrize("every", [None, 4], ids=["running sum", "fresh every 4"])
@pytest.mark.parametrize("lin", [128, 768])
def test_k1_bf16_sums_against_the_gate(lin, every, model):
    """K1-bf16: 64 output voxels x 16 lanes over K = 8 L_in of the smoke's
    inputs (x standard normal, wf scaled by 1/sqrt(8 L_in), both bf16): the
    running sum (the kernel's) meets the gate with the margin at L_in 768,
    within 1/50 of the room; so does a fresh sum every 4 steps."""
    rng = np.random.default_rng(lin)
    k = 8 * lin
    x = _bf16(rng.standard_normal((64, k)))
    w = _bf16(rng.standard_normal((k, 16)) / np.sqrt(k))
    ref = x.double() @ w.double()
    delta, room = _check(_gemm_rz(x, w, model[1], every), ref)
    assert 50 * delta <= room, (delta, room)


@pytest.mark.parametrize("model", {"k16": 16, "k8": 8}.items(), ids=["k16", "k8"])
def test_k1_dw_bf16_split_sums_against_the_gate(model):
    """K1-dW-bf16 at the Pancreas up_concat1.conv1 shape (x (8, 56, 56, 48,
    384), dy at grid 57^2 x 49, 128 lanes): the split chunk that
    dw_bf16_plan gives on a 132-SM card (chunk_voxels, the most voxels a
    split sums, its tiles' padding included), the voxels laid out so that
    every split but the last sums that many, each split's running sum
    emulated (4 x 8 outputs, x and dy standard normal bf16, all splits at
    once), the partials then added in split order rounded to nearest as the
    split sum does: the gate met with the margin."""
    plan = dw_bf16_plan((8, 56, 56, 48, 384), 128, 1, 132)
    voxels = 8 * 57 * 57 * 49
    assert plan.splits * plan.chunk_voxels >= voxels
    chunk = plan.chunk_voxels
    rng = np.random.default_rng(5)
    x = torch.zeros(plan.splits * chunk, 4)
    dy = torch.zeros(plan.splits * chunk, 8)
    x[:voxels] = _bf16(rng.standard_normal((voxels, 4)))
    dy[:voxels] = _bf16(rng.standard_normal((voxels, 8)))
    a = x.reshape(plan.splits, chunk, 4).transpose(1, 2)
    b = dy.reshape(plan.splits, chunk, 8)
    parts = _gemm_rz(a, b, model[1], None)
    sums = parts[0]
    for p in parts[1:]:
        sums = sums + p
    _check(sums, x.double().T @ dy.double())
