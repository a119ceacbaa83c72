"""The device cross-check of one train step (train/device_check.py) on the
CPU: two CPU runs of the same step from equal states agree, the step moved
the state, and each kind of leaf that moves past its tolerance is
reported. On the card, tests/test_torch_cuda.py and chip_smoke.py run it
against CUDA."""

import numpy as np
import pytest
import torch

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
    diffs, scalars, worst = dc.check_step("cpu")
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
