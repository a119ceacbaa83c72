"""The port's CUDA kernels on the card: K1 and K1-dW against their plain
versions, FoldedConv3Fn's gradients against autograd of the plain conv, the
folded UNet3D on CUDA against the same module on the CPU, its gradients
against autograd of the plain folded path, one train step on CUDA against
the same step on the CPU (the Pancreas, ISLES, VNet and ASPP cases), K2,
the fused FeCL, against its plain twin, and the VNet's instances of K1 and
K1-dW (L_in 8 to phase 0: its input folded at phase 1) and its folded
model on CUDA against the CPU; the bfloat16 instances (K1-bf16 forward and
dx, K1-dW-bf16) against float64 convs of the same bf16 values within
chip_smoke.py's gate, the bf16 wrappers' dtype checks and counts, and the
bf16 step check. Marked `cuda`; each test skips when no
GPU is present. On the card:
    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest
"""

from unittest import mock

import numpy as np
import pytest
import torch

from dycon_paper_replication_tpu_torch import weights
from dycon_paper_replication_tpu_torch.config import resolve_device
from dycon_paper_replication_tpu_torch.models import UNet3D, UNet3DConfig, VNet, VNetConfig
from dycon_paper_replication_tpu_torch.ops import folding
from dycon_paper_replication_tpu_torch.ops.folded_conv_cuda import (
    FoldedConv3,
    FoldedConv3Dw,
    FoldedConv3Fn,
    K1ValuedPlainConvFn,
    folded_conv3,
    folded_conv3_dw,
    folded_conv3_dw_plain,
    folded_conv3_dx,
    folded_conv3_plain,
)
from dycon_paper_replication_tpu_torch.train.device_check import check_step
from dycon_paper_replication_tpu_torch.train.step import SCALAR_METRICS

pytestmark = pytest.mark.cuda
torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return resolve_device("cuda")


@pytest.mark.parametrize("to_phase", [0, 1])
@pytest.mark.parametrize("lin,lout", [(8, 128), (136, 256)])
def test_k1_matches_plain(cuda, to_phase, lin, lout):
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(2, 5, 7, 6, lin, device=cuda, generator=g)
    wf = torch.randn(2, 2, 2, lin, lout, device=cuda, generator=g) / (8 * lin) ** 0.5
    k1 = FoldedConv3()
    y = k1(x, wf, to_phase=to_phase)
    want = folded_conv3_plain(x, wf, to_phase=to_phase)
    torch.cuda.synchronize()
    assert k1.launches == 1 and y.shape == want.shape
    assert (y - want).abs().max().item() <= 1e-4 * want.abs().max().item()


def test_k1_rejects_bad_operands(cuda):
    k1 = FoldedConv3()
    x = torch.zeros(1, 2, 2, 2, 8, device=cuda)
    with pytest.raises(ValueError):
        k1(x, torch.zeros(2, 2, 2, 8, 64, device=cuda), to_phase=1)  # L_out % 128
    with pytest.raises(TypeError):
        k1(x.double(), torch.zeros(2, 2, 2, 8, 128, device=cuda, dtype=torch.float64),
           to_phase=1)
    assert k1.launches == 0


def test_folded_model_on_cuda_matches_cpu(cuda):
    params, state = weights.init_jax_tree(UNet3DConfig(), seed=1)
    sd = weights.jax_tree_to_state_dict(params, state)
    x = torch.from_numpy(np.random.default_rng(2).random((2, 32, 32, 16, 1), np.float32))
    outs = []
    for device in ("cpu", cuda):
        net = UNet3D(UNet3DConfig(layout="folded")).to(device).eval()
        net.load_state_dict(sd)
        with torch.inference_mode():
            outs.append([t.cpu() for t in net(x.to(device))])
    for a, b in zip(*outs):
        assert (a - b).abs().max().item() <= 1e-4 * a.abs().max().item()


@pytest.mark.parametrize("to_phase", [0, 1])
@pytest.mark.parametrize("lin,lout", [(8, 128), (136, 256)])
def test_k1_dw_matches_plain(cuda, to_phase, lin, lout):
    """Against a float64 plain version: within max(1e-4 x max|ref|, 4 x the
    float32 plain version's own error); a rerun is bit-identical."""
    g = torch.Generator(device=cuda).manual_seed(1)
    step = 1 if to_phase == 1 else -1
    x = torch.randn(2, 5, 7, 6, lin, device=cuda, generator=g)
    dy = torch.randn(2, 5 + step, 7 + step, 6 + step, lout, device=cuda, generator=g)
    dw = FoldedConv3Dw()
    got, again = dw(x, dy, to_phase=to_phase), dw(x, dy, to_phase=to_phase)
    ref = folded_conv3_dw_plain(x.double(), dy.double(), to_phase=to_phase)
    err_plain = (folded_conv3_dw_plain(x, dy, to_phase=to_phase).double() - ref).abs().max()
    torch.cuda.synchronize()
    assert dw.launches == 2 and got.shape == (2, 2, 2, lin, lout)
    assert (got.double() - ref).abs().max().item() <= max(1e-4 * ref.abs().max().item(),
                                                         4 * err_plain.item())
    assert torch.equal(got, again)


def test_k1_dw_rejects_bad_operands(cuda):
    dw = FoldedConv3Dw()
    x = torch.zeros(1, 2, 2, 2, 8, device=cuda)
    with pytest.raises(ValueError):
        dw(x, torch.zeros(1, 3, 3, 3, 64, device=cuda), to_phase=1)  # L_out % 128
    with pytest.raises(ValueError):
        dw(x, torch.zeros(1, 2, 2, 2, 128, device=cuda), to_phase=1)  # grid G, not G+1
    with pytest.raises(TypeError):
        dw(x.double(), torch.zeros(1, 3, 3, 3, 128, device=cuda, dtype=torch.float64),
           to_phase=1)
    assert dw.launches == 0


@pytest.mark.parametrize("to_phase", [0, 1])
def test_folded_conv3_fn_grads_match_plain(cuda, to_phase):
    """FoldedConv3Fn (K1, K1 dx, K1-dW) against autograd of F.conv3d: x, w
    and b within 1e-4 x max|plain|."""
    g = torch.Generator(device=cuda).manual_seed(2)
    x = torch.randn(2, 5, 6, 7, 128, device=cuda, generator=g)
    w = torch.randn(3, 3, 3, 16, 16, device=cuda, generator=g) * 0.1
    b = torch.randn(16, device=cuda, generator=g)
    step = 1 if to_phase == 1 else -1
    cot = torch.randn(2, 5 + step, 6 + step, 7 + step, 128, device=cuda, generator=g)
    grads = []
    for fn in (folding.FoldedConv3Fn, K1ValuedPlainConvFn):
        xr, wr, br = (t.clone().requires_grad_() for t in (x, w, b))
        with mock.patch.object(folding, "FoldedConv3Fn", fn):
            y = folding.folded_conv3(xr, wr, br, to_phase=to_phase)
        (y * cot).sum().backward()
        grads.append((xr.grad, wr.grad, br.grad))
    for got, want in zip(*grads):
        assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item()


def test_folded_unet_grads_match_plain_autograd(cuda):
    """Every parameter of a full-width folded UNet3D in training mode gets
    the plain path's gradient: within 1e-4 x max|plain| (a conv bias in
    front of a norm, whose true gradient is 0: of its weight's)."""
    params, state = weights.init_jax_tree(UNet3DConfig(), seed=3)
    net = UNet3D(UNet3DConfig(layout="folded", dropout_rate=0.0)).to(cuda).train()
    net.load_state_dict(weights.jax_tree_to_state_dict(params, state))
    x = torch.from_numpy(np.random.default_rng(4).random((2, 32, 32, 16, 1), np.float32)).to(cuda)
    grads = []
    launches = folded_conv3_dw.launches
    for fn in (folding.FoldedConv3Fn, K1ValuedPlainConvFn):
        net.zero_grad(set_to_none=True)
        with mock.patch.object(folding, "FoldedConv3Fn", fn):
            _, seg, features = net(x)
        (seg.square().mean() + features.square().mean()).backward()
        grads.append({k: p.grad for k, p in net.named_parameters()})
    assert folded_conv3_dw.launches - launches == 8
    for k, want in grads[1].items():
        got = grads[0][k]
        if want is None:  # the SDF head: no loss reads it here
            assert got is None
            continue
        assert got is not None, k
        normalised_bias = k.endswith(".b") and not k.startswith(("final.", "out_conv2."))
        ref = grads[1][k[:-1] + "w"] if normalised_bias else want
        assert (got - want).abs().max().item() <= 1e-4 * ref.abs().max().item(), k


def test_train_step_on_cuda_matches_cpu(cuda):
    """One train step on the card against the same step on the CPU from
    equal states: losses, parameters, momentum, EMA teacher and BatchNorm
    stats within the path-scaled tolerances (train/device_check.py), through
    16 + 7 K1 and 8 K1-dW launches."""
    counters = (folded_conv3, folded_conv3_dx, folded_conv3_dw)
    before = [c.launches for c in counters]
    diffs, scalars, _, _ = check_step(cuda)
    assert [c.launches - n for c, n in zip(counters, before)] == [16, 7, 8]
    assert diffs == []
    assert np.isfinite(scalars).all() and scalars[SCALAR_METRICS.index("skipped")] == 0


def test_isles_train_step_on_cuda_matches_cpu(cuda):
    """The ISLES case of the same check: the fused FeCL through K2 (one
    forward and one backward call) on the card against its twin on the CPU,
    with the K1 launches of the Pancreas case."""
    from dycon_paper_replication_tpu_torch.ops.fecl_fused import fecl_bwd, fecl_fwd

    counters = (folded_conv3, folded_conv3_dx, folded_conv3_dw, fecl_fwd, fecl_bwd)
    before = [c.launches for c in counters]
    diffs, scalars, _, sides = check_step(cuda, config="isles22")
    assert [c.launches - n for c, n in zip(counters, before)] == [16, 7, 8, 1, 1]
    assert diffs == [], (diffs, sides)
    assert np.isfinite(scalars).all() and scalars[SCALAR_METRICS.index("skipped")] == 0


# the VNet's six folded convs at a small grid: (L_in, L_out, to_phase), enc0
# from the phase-1 image fold (L_in 8, VALID) and the others as in
# chip_smoke.py's VNET_TRAIN_SHAPES
VNET_INSTANCES = [(8, 128, 0), (256, 256, 1), (256, 256, 0), (128, 128, 1)]


@pytest.mark.parametrize("lin,lout,to_phase", VNET_INSTANCES)
def test_k1_and_k1_dw_at_vnet_instances(cuda, lin, lout, to_phase):
    """K1 within 1e-4 x max|plain|, K1-dW within max(1e-4 x max|ref|, 4 x
    the float32 plain error) of float64 and bit-identical on a rerun, dx
    (where the model asks for it: L_in > 8) within K1's gate."""
    g = torch.Generator(device=cuda).manual_seed(lin + to_phase)
    step = 1 if to_phase == 1 else -1
    x = torch.randn(2, 6, 7, 5, lin, device=cuda, generator=g)
    wf = torch.randn(2, 2, 2, lin, lout, device=cuda, generator=g) / (8 * lin) ** 0.5
    dy = torch.randn(2, 6 + step, 7 + step, 5 + step, lout, device=cuda, generator=g)
    k1, dw = FoldedConv3(), FoldedConv3Dw()
    y = k1(x, wf, to_phase=to_phase)
    want = folded_conv3_plain(x, wf, to_phase=to_phase)
    got, again = dw(x, dy, to_phase=to_phase), dw(x, dy, to_phase=to_phase)
    ref = folded_conv3_dw_plain(x.double(), dy.double(), to_phase=to_phase)
    err_plain = (folded_conv3_dw_plain(x, dy, to_phase=to_phase).double() - ref).abs().max()
    torch.cuda.synchronize()
    assert (y - want).abs().max().item() <= 1e-4 * want.abs().max().item()
    assert (got.double() - ref).abs().max().item() <= max(1e-4 * ref.abs().max().item(),
                                                         4 * err_plain.item())
    assert torch.equal(got, again)
    if lin > 8:
        wf_t = wf.flip(0, 1, 2).transpose(3, 4).contiguous()
        dx = k1(dy, wf_t, to_phase=1 - to_phase)
        dx_want = folded_conv3_plain(dy, wf_t, to_phase=1 - to_phase)
        assert (dx - dx_want).abs().max().item() <= 1e-4 * dx_want.abs().max().item()


def test_folded_vnet_on_cuda_matches_cpu(cuda):
    """The folded VNet (6 K1 launches) on the card against the same module
    on the CPU, eval mode: within tests/test_vnet_folded.py's atol + rtol
    5e-4 (seg, sdf) and 1e-3 (features)."""
    sd = weights.jax_tree_to_state_dict(*weights.init_jax_tree(VNetConfig(), seed=1))
    x = torch.from_numpy(np.random.default_rng(2).random((2, 32, 32, 16, 1), np.float32))
    outs = []
    launches = folded_conv3.launches
    for device in ("cpu", cuda):
        net = VNet(VNetConfig(layout="folded")).to(device).eval()
        net.load_state_dict(sd)
        with torch.inference_mode():
            outs.append([t.cpu() for t in net(x.to(device))])
    assert folded_conv3.launches - launches == 6
    for (a, b), tol in zip(zip(*outs), (5e-4, 5e-4, 1e-3)):
        assert ((b - a).abs() - tol * a.abs()).max().item() <= tol


@pytest.mark.parametrize("config,launches", [("vnet", [12, 5, 6]), ("aspp", [16, 7, 8])])
def test_vnet_and_aspp_train_steps_on_cuda_match_cpu(cuda, config, launches):
    counters = (folded_conv3, folded_conv3_dx, folded_conv3_dw)
    before = [c.launches for c in counters]
    diffs, scalars, _, sides = check_step(cuda, config=config)
    assert [c.launches - n for c, n in zip(counters, before)] == launches
    assert diffs == [], (diffs, sides)
    assert np.isfinite(scalars).all() and scalars[SCALAR_METRICS.index("skipped")] == 0


def _fecl_inputs(device, b, n, d, seed):
    """L2-normalised student and teacher rows and a binary mask, from numpy."""
    rng = np.random.default_rng(seed)
    feat = rng.standard_normal((b, n, d)).astype(np.float32)
    tfeat = feat + 0.5 * rng.standard_normal((b, n, d)).astype(np.float32)
    feat /= np.linalg.norm(feat, axis=-1, keepdims=True)
    tfeat /= np.linalg.norm(tfeat, axis=-1, keepdims=True)
    mask = (rng.random((b, n)) < 0.3).astype(np.float32)
    return tuple(torch.from_numpy(a).to(device) for a in (feat, mask, tfeat))


@pytest.mark.parametrize("n,d,teacher,focal", [(300, 256, True, True), (256, 256, True, True),
                                               (200, 256, False, False), (1000, 256, True, True),
                                               (24, 256, True, False)])
def test_k2_matches_twin(cuda, n, d, teacher, focal):
    """K2 (forward and backward) against the plain twin on the card, TF32
    off: the loss within 1e-5 relative and the residuals within 1e-5 x
    their max, dF within 1e-4 x max|dF twin|; one K2 call each way, and a
    rerun bit-identical. N 1000 is no multiple of K2's tiles (64 owned rows,
    128, 64 or 32 streamed rows), N 24 smaller than any of them."""
    from dycon_paper_replication_tpu_torch.ops import fecl_fused as ff

    feat, mask, tfeat = _fecl_inputs(cuda, 2, n, d, seed=n)
    tfeat = tfeat if teacher else None
    opts = ff.FeclOptions(0.6, 2.0, focal, 1.3, 0.3, 1.0, 128)
    fwd, bwd = ff.FeclForward(), ff.FeclBackward()
    got = fwd(feat, mask, tfeat, opts)
    again = fwd(feat, mask, tfeat, opts)
    want = [t.contiguous() for t in ff._twin_forward(feat, mask, tfeat, opts)]
    for name, g, a, w in zip(("col_max", "S", "row", "unf", "rho", "csum", "ccnt"),
                             got, again, want):
        assert torch.equal(g, a), name
        assert (g - w).abs().max().item() <= 1e-5 * max(w.abs().max().item(), 1.0), name
    col_max, s_all, _, _, rho = want[:5]
    a_all = torch.rand(feat.shape[:2], device=cuda) * 1e-3
    dgot = bwd(feat, mask, tfeat, col_max, s_all, rho, a_all, 0.25, opts)
    dagain = bwd(feat, mask, tfeat, col_max, s_all, rho, a_all, 0.25, opts)
    dwant = ff._twin_backward(feat, mask, tfeat, col_max, s_all, rho, a_all, 0.25, opts)
    torch.cuda.synchronize()
    assert (fwd.launches, bwd.launches) == (2, 2)
    assert torch.equal(dgot, dagain)
    assert (dgot - dwant).abs().max().item() <= 1e-4 * dwant.abs().max().item()


def test_k2_loss_and_grad_match_twin_and_nan(cuda):
    """fecl_loss_fused on the card against the same call on the CPU (the
    twin); a NaN row makes the loss NaN."""
    from dycon_paper_replication_tpu_torch.ops import fecl_fused as ff

    feat, mask, tfeat = _fecl_inputs(cuda, 2, 333, 256, seed=5)
    vals = []
    for device in (cuda, "cpu"):
        f = feat.to(device).clone().requires_grad_()
        loss = ff.fecl_loss_fused(f, mask.to(device), tfeat.to(device), pos_thresh=1.3,
                                  neg_thresh=0.3, row_chunk=128)
        loss.backward()
        vals.append((loss.item(), f.grad.cpu()))
    (lc, gc), (lp, gp) = vals
    assert abs(lc - lp) <= 1e-5 * abs(lp)
    assert (gc - gp).abs().max().item() <= 1e-4 * gp.abs().max().item()
    bad = feat.clone()
    bad[1, 17, 3] = float("nan")
    assert torch.isnan(ff.fecl_loss_fused(bad, mask, tfeat, pos_thresh=1.3, neg_thresh=0.3))


def test_k2_rejects_bad_operands(cuda):
    from dycon_paper_replication_tpu_torch.ops import fecl_fused as ff

    feat, mask, tfeat = _fecl_inputs(cuda, 1, 64, 256, seed=1)
    opts = ff.FeclOptions(0.6, 2.0, True, 1.3, 0.3, 1.0, 64)
    fwd = ff.FeclForward()
    with pytest.raises(ValueError):
        fwd(feat[..., :64].contiguous(), mask, None, opts)  # D not K2's width
    with pytest.raises(TypeError):
        fwd(feat.double(), mask.double(), None, opts)
    assert fwd.launches == 0


def _bf16_gate(got, plain, ref):
    """chip_smoke.py's bf16 gate: max|got - ref| <= max(2^-8 max|ref|, 2 x
    the bf16 plain version's max error against ref)."""
    err_plain = (plain.double() - ref).abs().max().item()
    return (got.double() - ref).abs().max().item() <= max(2.0 ** -8 * ref.abs().max().item(),
                                                          2 * err_plain)


@pytest.mark.parametrize("to_phase", [0, 1])
@pytest.mark.parametrize("lin,lout", [(8, 128), (136, 256), (256, 128)])
def test_k1_bf16_matches_plain(cuda, to_phase, lin, lout):
    """K1-bf16 forward and, through FoldedConv3Fn, its dx and K1-dW-bf16,
    all bfloat16, against float64 convs of the same bf16 values; launches
    counted on the bf16 instances only; reruns bit-identical. dx where its
    output lanes, L_in, are a multiple of 128 (K1's L_out), as in the
    models."""
    g = torch.Generator(device=cuda).manual_seed(3)
    bf = torch.bfloat16
    x = torch.randn(2, 5, 7, 6, lin, device=cuda, generator=g).to(bf)
    wf = (torch.randn(2, 2, 2, lin, lout, device=cuda, generator=g) / (8 * lin) ** 0.5).to(bf)
    k1 = FoldedConv3()
    y, again = k1(x, wf, to_phase=to_phase), k1(x, wf, to_phase=to_phase)
    plain = folded_conv3_plain(x, wf, to_phase=to_phase)
    ref = folded_conv3_plain(x.double(), wf.double(), to_phase=to_phase)
    torch.cuda.synchronize()
    assert y.dtype == bf and k1.by_dtype == {torch.float32: 0, bf: 2} and k1.launches == 2
    assert _bf16_gate(y, plain, ref) and torch.equal(y, again)

    dy = torch.randn(y.shape, device=cuda, generator=g).to(bf)
    with_dx = lin % 128 == 0
    counts = [c.by_dtype[bf] for c in (folded_conv3_dx, folded_conv3_dw)]
    xr, wr = x.clone().requires_grad_(with_dx), wf.clone().requires_grad_()
    FoldedConv3Fn.apply(xr, wr, to_phase).backward(dy)
    x64, w64 = x.double().requires_grad_(with_dx), wf.double().requires_grad_()
    folded_conv3_plain(x64, w64, to_phase=to_phase).backward(dy.double())
    if with_dx:
        xp = x.clone().requires_grad_()
        folded_conv3_plain(xp, wf, to_phase=to_phase).backward(dy)
    torch.cuda.synchronize()
    assert [c.by_dtype[bf] for c in (folded_conv3_dx, folded_conv3_dw)] == [
        counts[0] + with_dx, counts[1] + 1]
    assert wr.grad.dtype == bf
    assert _bf16_gate(wr.grad, folded_conv3_dw_plain(x, dy, to_phase=to_phase), w64.grad)
    if with_dx:
        assert xr.grad.dtype == bf and _bf16_gate(xr.grad, xp.grad, x64.grad)


def test_bf16_wrappers_refuse_mixed_operands(cuda):
    bf = torch.bfloat16
    x = torch.zeros(1, 2, 2, 2, 8, device=cuda)
    k1, dw = FoldedConv3(), FoldedConv3Dw()
    with pytest.raises(TypeError):
        k1(x.to(bf), torch.zeros(2, 2, 2, 8, 128, device=cuda), to_phase=1)
    with pytest.raises(TypeError):
        k1(x, torch.zeros(2, 2, 2, 8, 128, device=cuda, dtype=bf), to_phase=1)
    with pytest.raises(TypeError):
        dw(x.to(bf), torch.zeros(1, 3, 3, 3, 128, device=cuda), to_phase=1)
    with pytest.raises(TypeError):
        dw(x.to(torch.float16), torch.zeros(1, 3, 3, 3, 128, device=cuda, dtype=torch.float16),
           to_phase=1)
    assert k1.launches == 0 == dw.launches


@pytest.mark.parametrize("config,launches", [("pancreas_bf16", [16, 7, 8]),
                                             ("vnet_bf16", [12, 5, 6])])
def test_bf16_train_steps_on_cuda_match_cpu(cuda, config, launches):
    """The bfloat16 step check (train/device_check.py): the bf16 instances
    launched as the float32 ones are in the float32 cases, no float32 one."""
    counters = (folded_conv3, folded_conv3_dx, folded_conv3_dw)
    before = [dict(c.by_dtype) for c in counters]
    diffs, _, _, _ = check_step(cuda, config=config)
    assert diffs == []
    for c, b, n in zip(counters, before, launches):
        assert c.by_dtype[torch.bfloat16] - b[torch.bfloat16] == n
        assert c.by_dtype[torch.float32] == b[torch.float32]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_threefry_kernel_matches_plain(cuda, dtype):
    """ops/csrc/threefry.cu against its plain torch version on the card: the
    teacher noise within 4 ulp (erfinv), the dropout forward and backward
    bit-equal, whole and over a data-parallel rank's rows."""
    from dycon_paper_replication_tpu_torch.ops import threefry

    key = threefry.split(threefry.key(1337), 3)[0]
    shape, rows = (4, 16, 16, 8, 1), [1, 3]
    noise = threefry.teacher_noise(key, shape, device=cuda)
    want = threefry.noise_plain(key, shape, device=cuda)
    gap = (noise.view(torch.int32).long() - want.view(torch.int32).long()).abs().max().item()
    assert gap <= 4
    assert torch.equal(threefry.teacher_noise(key, shape, rows, cuda), noise[rows])
    g = torch.Generator(device=cuda).manual_seed(4)
    x = torch.randn(4, 6, 6, 5, 16, device=cuda, generator=g).to(dtype).requires_grad_(True)
    dy = torch.randn(x.shape, device=cuda, generator=g).to(dtype)
    before = threefry.dropout_kernel.launches
    y = threefry.dropout(x, key, 0.7)
    (dx,) = torch.autograd.grad(y, x, dy)
    assert threefry.dropout_kernel.launches - before == 2
    assert torch.equal(y, threefry.dropout_plain(x.detach(), key, 0.7))
    assert torch.equal(dx, threefry.dropout_plain(dy, key, 0.7))
    part = threefry.dropout(x.detach()[rows].contiguous(), key, 0.7, rows)
    assert torch.equal(part, y.detach()[rows])
