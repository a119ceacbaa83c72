"""The port's CUDA kernels on the card: K1 and K1-dW against their plain
versions, FoldedConv3Fn's gradients against autograd of the plain conv, the
folded UNet3D on CUDA against the same module on the CPU, its gradients
against autograd of the plain folded path, and one train step on CUDA
against the same step on the CPU. Marked `cuda`; each test skips when no
GPU is present. On the card:
    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest
"""

from unittest import mock

import numpy as np
import pytest
import torch

from dycon_paper_replication_tpu_torch import weights
from dycon_paper_replication_tpu_torch.config import resolve_device
from dycon_paper_replication_tpu_torch.models import UNet3D, UNet3DConfig
from dycon_paper_replication_tpu_torch.ops import folding
from dycon_paper_replication_tpu_torch.ops.folded_conv_cuda import (
    FoldedConv3,
    FoldedConv3Dw,
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
    diffs, scalars, _ = check_step(cuda)
    assert [c.launches - n for c, n in zip(counters, before)] == [16, 7, 8]
    assert diffs == []
    assert np.isfinite(scalars).all() and scalars[SCALAR_METRICS.index("skipped")] == 0
