"""The device cross-check of one train step (train/device_check.py) on the
CPU: two CPU runs of the same step from equal states agree (the Pancreas
and the ISLES case), the step moved the state, and each kind of leaf that
moves past its tolerance is reported. The kink sides, in every case
(Pancreas, ISLES, VNet and UNet3D + ASPP, device_check.CONFIGS): with
float32-level noise on one side's folded conv outputs (uniform, 2e-6 of
max|y|, about K1's own difference from the plain conv) the check passes at
seeds 0-3, the CPU step taking the noisy side's ReLU sides within the
margin; with a real fault on that side (1e-3 noise, or one conv's weight
gradient zeroed; for ISLES also the fused FeCL's dF 1e-2 off, or its cross
term dropped) it fails. On the card, tests/test_torch_cuda.py and chip_smoke.py run it
against CUDA."""

from unittest import mock

import numpy as np
import pytest
import torch

from dycon_paper_replication_tpu_torch.ops import fecl_fused, folded_conv_cuda, folding
from dycon_paper_replication_tpu_torch.train import device_check as dc
from dycon_paper_replication_tpu_torch.train.step import SCALAR_METRICS

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def stepped():
    """The initial state, one CPU step of it, its scalars and the batch."""
    state = dc.initial_state(0)
    batch, noise = dc.make_inputs(0)
    after = dc.state_on(state, dc.CPU)
    scalars = dc.run_step(after, batch, noise, dc.CPU)
    return state, after, scalars, batch


def test_check_step_on_cpu_agrees_with_itself():
    diffs, scalars, worst, _ = dc.check_step("cpu")
    assert diffs == []
    assert np.isfinite(scalars).all() and scalars[SCALAR_METRICS.index("skipped")] == 0
    groups = {"scalar", "momentum", "params", "teacher", "stats", "teacher stats"}
    assert set(worst) == groups and all(ratio == 0.0 for _, ratio in worst.values())


def test_step_moves_student_teacher_and_momentum(stepped):
    state, after, _, _ = stepped
    assert (state.step, after.step) == (1, 2)
    moved = [not torch.equal(a, b) for a, b in zip(after.student.parameters(),
                                                   state.student.parameters())]
    assert sum(moved) > len(moved) // 2
    # alpha 0.5: the teacher is halfway between its old self and the new student
    for t_new, t_old, s_new in zip(after.teacher.parameters(), state.teacher.parameters(),
                                   after.student.parameters()):
        torch.testing.assert_close(t_new, 0.5 * t_old + 0.5 * s_new, rtol=1e-6, atol=1e-7)
    assert any(float(m.abs().max()) > 0 for m in after.momentum.values())


def _moved(tensor: torch.Tensor) -> None:
    with torch.no_grad():
        tensor.add_(1e-2 * tensor.abs().max() + 1e-2)


@pytest.mark.parametrize("leaf", ["scalar", "momentum", "params", "teacher", "stats"])
def test_differences_reports_a_moved_leaf(stepped, leaf):
    _, after, scalars, batch = stepped
    got = dc.state_on(after, dc.CPU)
    got_scalars = scalars.copy()
    if leaf == "scalar":
        got_scalars[SCALAR_METRICS.index("f_loss")] *= 1.001
    elif leaf == "momentum":
        _moved(got.momentum["conv1.conv1.w"])
    elif leaf == "params":
        _moved(dict(got.student.named_parameters())["up_concat1.conv2.w"])
    elif leaf == "teacher":
        _moved(dict(got.teacher.named_parameters())["center.conv1.w"])
    else:
        _moved(next(b for k, b in got.student.named_buffers() if k.endswith("mean")))
    lr = dc.step_config(dc.CPU).base_lr
    assert dc.differences(after, scalars, after, scalars, batch["label"], lr) == []
    diffs = dc.differences(got, got_scalars, after, scalars, batch["label"], lr)
    assert len(diffs) == 1 and diffs[0].startswith(leaf), diffs


def test_isles_check_step_on_cpu_agrees_with_itself():
    """The ISLES case (fused FeCL through the twin) against itself: equal,
    and the kink sides shared without a single change of side."""
    fwd = dc.fecl_fused.fecl_fwd.launches
    diffs, scalars, worst, counts = dc.check_step("cpu", config="isles22")
    assert diffs == [] and all(ratio == 0.0 for _, ratio in worst.values())
    assert np.isfinite(scalars).all() and scalars[SCALAR_METRICS.index("skipped")] == 0
    assert counts["relu_near"] > 0 and counts["cross_near"] > 0
    assert counts["relu_taken"] == 0 == counts["cross_taken"]
    assert dc.fecl_fused.fecl_fwd.launches == fwd  # the CPU runs the twin, not K2


def _noisy_convs(rel: float, seed: int):
    """A device_context: every folded conv output plus uniform noise in
    +-rel x max|y|, from a seeded generator."""
    gen = torch.Generator().manual_seed(seed)
    real = folding.FoldedConv3Fn

    class Noisy:
        @staticmethod
        def apply(x, wf, to_phase):
            y = real.apply(x, wf, to_phase)
            scale = rel * y.detach().abs().max()
            return y + (2 * torch.rand(y.shape, generator=gen) - 1) * scale

    return lambda: mock.patch.object(folding, "FoldedConv3Fn", Noisy)


@pytest.mark.parametrize("config", dc.CONFIGS)
@pytest.mark.parametrize("seed", range(4))
def test_check_passes_under_float32_noise(config, seed):
    diffs, _, _, counts = dc.check_step("cpu", seed, config=config,
                                        device_context=_noisy_convs(2e-6, seed))
    assert diffs == []
    assert counts["relu_taken"] > 0  # the noise moved values across a kink


def _zero_first_weight_gradient():
    real = folded_conv_cuda.folded_conv3_dw
    calls = []

    def dw(x, dy, *, to_phase):
        calls.append(to_phase)
        out = real(x, dy, to_phase=to_phase)
        return torch.zeros_like(out) if len(calls) == 1 else out

    return mock.patch.object(folded_conv_cuda, "folded_conv3_dw", dw)


def _faulty_fecl_backward(fault: str):
    """A device_context: the fused FeCL's backward (K2's on the card, the
    twin's here) with its dF scaled by 1 + 1e-2, or with the cross term's
    cotangent g_cross zeroed (the teacher cross term dropped from dF)."""
    real = fecl_fused.fecl_bwd

    def bwd(feat, mask, tfeat, col_max, s_all, rho, a_all, g_cross, o):
        if fault == "k2_no_cross_term":
            return real(feat, mask, tfeat, col_max, s_all, rho, a_all, 0.0, o)
        return real(feat, mask, tfeat, col_max, s_all, rho, a_all, g_cross, o) * (1 + 1e-2)

    return lambda: mock.patch.object(fecl_fused, "fecl_bwd", bwd)


@pytest.mark.parametrize("config,fault", [
    *[(c, f) for c in dc.CONFIGS for f in ("noise_1e-3", "zeroed_weight_gradient")],
    ("isles22", "k2_dF_1e-2"), ("isles22", "k2_no_cross_term")])
def test_check_fails_on_a_real_fault(config, fault):
    """Each fault moves some leaf past its tolerance. For K2's dF the check
    resolves a relative error of 1e-2 (worst leaf 1.9 x its tolerance) but
    not 1e-3 (0.19 x): the step tolerances are 5e-3 of a leaf's gradient;
    chip_smoke.py holds K2's dF itself to 1e-4 x max|dF|."""
    context = {"noise_1e-3": _noisy_convs(1e-3, 0),
               "zeroed_weight_gradient": _zero_first_weight_gradient}.get(fault)
    diffs, _, _, _ = dc.check_step("cpu", 0, config=config,
                                   device_context=context or _faulty_fecl_backward(fault))
    assert diffs, fault
