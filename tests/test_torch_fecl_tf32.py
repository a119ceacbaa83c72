"""The numeric argument of K2's three TF32 passes, on the CPU.

K2 (dycon_paper_replication_tpu_torch/ops/csrc/fecl_fused.cu) runs every
B x N x N x D product of the fused FeCL on the TF32 tensor cores: each
operand v is split once into hi = rna_tf32(v) and lo = v - hi truncated
to TF32 (split_tf32), and each m16n8k8 product accumulates lo_a*hi_b,
hi_a*lo_b, hi_a*hi_b. The pair products L = F F^T and cs = F T^T contract
over D in stages of 32 (four k-steps), the backward's (dL + dL^T) F / tau
+ dcs T over N in stages of 8 streamed rows; each stage's products go
into a fresh float32 sum, added into the running one by a float add
rounded to nearest. The column max is L's row max (the emulated L is not
symmetric bit for bit), and the backward's dL_ji for the block's row i
takes its L from row i's side, L_ji = E[i, j] with E = F F^T as emulated.

Here that arithmetic is emulated in plain torch, with each m16n8k8
product as tests/test_torch_tf32.py models the tensor core (exact
products, the sum truncated toward zero), and the per-pair terms in
float32 as the kernel forms them, on one batch item of N = 384 rows of
D = 256, cs spread around the cross threshold as chip_smoke.py's inputs.
The float64 reference takes the emulated side at the pairs within 1e-5 of
the threshold, as chip_smoke.py does. Held to K2's gates:

  * three passes: the loss within 1e-5 relative of float64 (measured
    5.2e-9), dF within 1e-4 x max|dF| of the float32 twin (measured
    4.5e-7), the column max within 1e-5 x its max of the twin's (6.8e-7);
  * one pass (hi_a*hi_b alone): the loss stays inside its gate (3.9e-7
    relative), but dF is off by 3.5e-3 x max|dF| (35x its gate) and the
    column max by 1.1e-4 x its max (11x): asserted, dF beyond 10x its gate
    and the column max beyond its own.

dF is emulated on its first DF_COLS feature columns, which keeps the test
near 11 s with one torch thread.
"""

import numpy as np
import pytest
import torch

from dycon_paper_replication_tpu_torch.ops import fecl_fused as ff
from test_torch_tf32 import _mma_rz, _rna_tf32, _trunc_tf32

torch.set_num_threads(1)
N, D = 384, 256
DK = 32  # D per stage of the pair products
JK = 8  # streamed rows per stage of the backward's second products
DF_COLS = 64  # dF's columns emulated (each column's arithmetic is its own)
OPTS = ff.FeclOptions(0.6, 2.0, True, 1.3, 0.3, 1.0, 128)


def _split(v: torch.Tensor):
    """split_tf32: hi rounded to TF32, lo = v - hi truncated to TF32."""
    hi = _rna_tf32(v)
    return hi, _trunc_tf32(v - hi)


def _emulated(pairs, stage: int, passes: int) -> torch.Tensor:
    """sum_p a_p @ b_p (a_p (M, K), b_p (K, N), float32) as K2 computes it:
    per stage of `stage` contraction steps a fresh sum of the modelled
    m16n8k8 products of every pair in turn (lo*hi, hi*lo, hi*hi, or hi*hi
    alone), added into the running sum by a float32 add."""
    split = [(_split(a), _split(b)) for a, b in pairs]
    k_all = pairs[0][0].shape[1]
    out = torch.zeros(pairs[0][0].shape[0], pairs[0][1].shape[1])
    for s in range(0, k_all, stage):
        fresh = torch.zeros_like(out)
        for k in range(s, min(s + stage, k_all), 8):
            for (ah, al), (bh, bl) in split:
                terms = [(ah, bh)] if passes == 1 else [(al, bh), (ah, bl), (ah, bh)]
                for a, b in terms:
                    fresh = _mma_rz(fresh, a[:, k:k + 8], b[k:k + 8])
        out = out + fresh
    return out


def _inputs(seed: int = 0):
    """chip_smoke.py's construction at one batch item: a shared direction,
    one per class and noise, so that pairs of different class have cs
    spread around the cross threshold 0.3; a binary mask of two blobs."""
    rng = np.random.default_rng(seed)

    def unit(a):
        return a / np.linalg.norm(a, axis=-1, keepdims=True)

    mask = np.zeros(N, np.float32)
    mask[40:150] = mask[260:300] = 1.0
    noise = rng.standard_normal((3 + 2 * N, D)) / np.sqrt(D)
    shared, classes = unit(noise[0]), unit(noise[1:3])
    feat = unit(shared + classes[mask.astype(int)] + 1.2 * noise[3:3 + N])
    tfeat = unit(feat + 0.3 * noise[3 + N:])
    return (torch.from_numpy(feat.astype(np.float32)), torch.from_numpy(mask),
            torch.from_numpy(tfeat.astype(np.float32)))


def _forward(lt, cs, mask, side, col_max, dtype):
    """The loss (FeclFusedFn's, focal, no gambling weights) and the
    residuals S and rho from L (over tau, diagonal zeroed) and cs, in
    `dtype`, as the twin and the kernel form the per-pair terms."""
    eps = ff.EPS
    off = 1.0 - torch.eye(N, dtype=dtype)
    same = (mask[:, None] == mask[None, :]).to(dtype)
    e = torch.exp(lt - col_max[None, :])
    s = (e * (1 - same)).sum(-1)
    den = e + s[:, None] + eps
    phi, psi = ff._phi_psi(e / den, ff._thresh(OPTS.pos_thresh, dtype), OPTS.gamma, OPTS.focal)
    so = same * off
    rho = (so * psi * (-e / (den * den))).sum(-1)
    hard = (same == 0) & side
    cnt = hard.to(dtype).sum()
    c_sum = torch.where(hard, -torch.log(torch.clamp_min(1.0 - cs, 0.0) + eps),
                        torch.zeros_like(cs)).sum()
    w = ff._row_weights(mask[None])[0].to(dtype)
    loss = (phi * so).sum(-1).mul(w).sum() / N + OPTS.lambda_cross * c_sum / (cnt + eps)
    return loss, s, rho, cnt


def _dl(lt, cs, mask, side, col_max, s, rho, cnt):
    """dL / tau and dcs (core_bwd's, gbar = 1) from L, cs and the forward's
    residuals, in float32."""
    eps = ff.EPS
    off = 1.0 - torch.eye(N)
    same = (mask[:, None] == mask[None, :]).float()
    e = torch.exp(lt - col_max[None, :])
    den = e + s[:, None] + eps
    _, psi = ff._phi_psi(e / den, ff._thresh(OPTS.pos_thresh, torch.float32), OPTS.gamma,
                         OPTS.focal)
    a = ff._row_weights(mask[None])[0] / N
    dl = a[:, None] * (same * off * psi * (s[:, None] + eps) * e / (den * den)
                       + rho[:, None] * (1 - same) * e)
    gap = torch.clamp_min(1.0 - cs, 0.0)
    dcs = torch.where((same == 0) & side & (cs < 1.0), OPTS.lambda_cross / (cnt + eps)
                      / (gap + eps), torch.zeros_like(cs))
    return dl / OPTS.temperature, dcs


def _side(cs_model, cs_ref):
    """The reference's side of the cross threshold: its own, but the
    model's at pairs within 1e-5 of the threshold."""
    neg_t = ff._thresh(OPTS.neg_thresh, cs_ref.dtype)
    close = (cs_ref - neg_t).abs() <= 1e-5
    return torch.where(close, cs_model.double() > float(neg_t), cs_ref > neg_t)


def _k2_model(feat, mask, tfeat, passes: int):
    """Loss, column max, cs and dF as K2 computes them (module doc)."""
    tau = OPTS.temperature
    gram = _emulated([(feat, feat.T)], DK, passes)  # E[i, j]: own row i, streamed row j
    cs = _emulated([(feat, tfeat.T)], DK, passes)
    off = 1.0 - torch.eye(N)
    col_max = (gram / tau * off).amax(1)  # L's row max stands for the column max
    side = cs > ff._thresh(OPTS.neg_thresh, torch.float32)
    loss, s, rho, cnt = _forward(gram / tau * off, cs, mask, side, col_max, torch.float32)
    dl, dcs = _dl(gram / tau * off, cs, mask, side, col_max, s, rho, cnt)
    # dL_ji for the block's row i and streamed row j, from L_ji = E[i, j]
    dl_t, _ = _dl(gram.T / tau * off, cs, mask, side, col_max, s, rho, cnt)
    f, t = feat[:, :DF_COLS], tfeat[:, :DF_COLS]
    return loss, col_max, cs, _emulated([(dl + dl_t.T, f), (dcs, t)], JK, passes)


def _reference(feat, mask, tfeat, cs_model):
    """The float64 loss (taking the model's side near the threshold), the
    float32 twin's column max and dF."""
    f, t = feat.double(), tfeat.double()
    lt = f @ f.T / OPTS.temperature * (1.0 - torch.eye(N, dtype=torch.float64))
    cs = f @ t.T
    loss64, _, _, _ = _forward(lt, cs, mask.double(), _side(cs_model, cs), lt.amax(0),
                               torch.float64)
    res = ff._twin_forward(feat[None], mask[None], tfeat[None], OPTS)
    col_max, s_all, rho = res[0], res[1], res[4]
    a_all = ff._row_weights(mask[None]) / N
    g_cross = 1.0 / (res[6].sum() + ff.EPS)
    dfeat = ff._twin_backward(feat[None], mask[None], tfeat[None], col_max, s_all, rho, a_all,
                              float(g_cross), OPTS)
    return loss64, col_max[0], dfeat[0, :, :DF_COLS]


@pytest.mark.parametrize("passes", [3, 1])
def test_k2_tf32_against_its_gates(passes):
    feat, mask, tfeat = _inputs()
    loss, col_max, cs, dfeat = _k2_model(feat, mask, tfeat, passes)
    loss64, col_max_twin, dfeat_twin = _reference(feat, mask, tfeat, cs)
    err_loss = abs(float(loss) - float(loss64))
    err_max = (col_max - col_max_twin).abs().max().item()
    gate_max = 1e-5 * col_max_twin.abs().max().item()
    err_grad = (dfeat - dfeat_twin).abs().max().item()
    gate_grad = 1e-4 * dfeat_twin.abs().max().item()
    assert err_loss <= 1e-5 * abs(float(loss64)), (err_loss, float(loss64))
    if passes == 3:
        assert err_max <= gate_max and err_grad <= gate_grad, (err_max, err_grad)
    else:
        assert err_max > gate_max and err_grad > 10 * gate_grad, (err_max, err_grad)
