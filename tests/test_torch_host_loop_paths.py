"""tests/test_torch_host_loop.py's (b) on the VNet and on 2 gloo ranks:
`fetch_ahead` 0 and 1 x `step_diagnostics` "always" and "cadence" end 8
iterations in bit-identical states, equal best-val bars and equal logged
scalars (that file's module doc). A file of its own, so that each file
runs within about a minute on one worker."""

import pytest
import torch

from test_torch_host_loop import hold_schedules

torch.set_num_threads(1)


@pytest.mark.parametrize("kind", ["vnet", "dp2"])
def test_schedules_end_in_the_same_state(tmp_path, kind):
    hold_schedules(tmp_path, kind)
