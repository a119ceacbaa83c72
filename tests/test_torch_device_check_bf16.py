"""The device cross-check of one train step (train/device_check.py) in its
bfloat16 cases ("pancreas_bf16", "vnet_bf16", BF16_CONFIGS) on the CPU.

The card's side is a CPU step here. Against itself the check finds no
difference. Under bfloat16-level noise on that side's folded conv outputs
(one bfloat16 ulp added or taken at 1e-3 of them, more than the 1e-4 of
outputs where K1-bf16 and the CPU's bfloat16 conv round differently on the
card, chip_smoke.py phase k1_bf16) the check passes at seeds 0-1, the CPU
steps taking the noisy side's ReLU sides within the margin (the module doc
of train/device_check.py gives the ratios measured under this noise at
seeds 0-5); with a real
fault on that side (uniform noise of 1e-1 x max|y| on every folded conv
output, or one conv's weight gradient zeroed) it fails. Its resolution is
bfloat16's: under these tolerances (4 x the bfloat16-against-float64
difference) noise of 1e-2 x max|y|, or every K1-dW output 5 % off, need
not fail it, while K1-bf16's own gates (chip_smoke.py phase k1_bf16, 2^-8
x max|ref|) hold each kernel to one rounding. The float32 cases
are tests/test_torch_device_check.py's; this file keeps the bfloat16 ones
out of that file's parametrisation (each bfloat16 case runs three steps,
the float64 yardstick among them)."""

from unittest import mock

import numpy as np
import pytest
import torch

from dycon_paper_replication_tpu_torch.ops import folding
from dycon_paper_replication_tpu_torch.train import device_check as dc
from dycon_paper_replication_tpu_torch.train.step import SCALAR_METRICS
from test_torch_device_check import _zero_first_weight_gradient

torch.set_num_threads(1)


def _perturbed_convs(seed: int, *, ulp_share: float = 0.0, rel: float = 0.0):
    """A device_context: every folded conv output with one bfloat16 ulp
    added or taken at `ulp_share` of its elements, plus uniform noise in
    +-rel x max|y|, from a seeded generator."""
    gen = torch.Generator().manual_seed(seed)
    real = folding.FoldedConv3Fn

    class Perturbed:
        @staticmethod
        def apply(x, wf, to_phase):
            y = real.apply(x, wf, to_phase)
            yd = y.detach().float()
            ulp = torch.exp2(torch.floor(torch.log2(yd.abs().clamp_min(1e-30))) - 7)
            pick = torch.rand(y.shape, generator=gen) < ulp_share
            sign = torch.where(torch.rand(y.shape, generator=gen) < 0.5, -1.0, 1.0)
            noise = torch.where(pick, sign * ulp, 0.0)
            noise += (2 * torch.rand(y.shape, generator=gen) - 1) * rel * yd.abs().max()
            return y + noise.to(y.dtype)

    return lambda: mock.patch.object(folding, "FoldedConv3Fn", Perturbed)


@pytest.mark.parametrize("config", dc.BF16_CONFIGS)
def test_bf16_check_step_on_cpu_agrees_with_itself(config):
    diffs, scalars, worst, counts = dc.check_step("cpu", config=config)
    assert diffs == [] and all(ratio == 0.0 for _, ratio in worst.values())
    assert np.isfinite(scalars).all() and scalars[SCALAR_METRICS.index("skipped")] == 0
    assert counts["relu_near"] > 0
    assert dc.step_config(dc.CPU, config).torch_compute_dtype() == torch.bfloat16


@pytest.mark.parametrize("config", dc.BF16_CONFIGS)
@pytest.mark.parametrize("seed", range(2))
def test_bf16_check_passes_under_bf16_noise(config, seed):
    diffs, _, _, counts = dc.check_step("cpu", seed, config=config,
                                        device_context=_perturbed_convs(seed, ulp_share=1e-3))
    assert diffs == []
    assert counts["relu_taken"] > 0  # the noise moved values across a kink


@pytest.mark.parametrize("config", dc.BF16_CONFIGS)
@pytest.mark.parametrize("fault", ["noise_1e-1", "zeroed_weight_gradient"])
def test_bf16_check_fails_on_a_real_fault(config, fault):
    context = (_perturbed_convs(0, rel=1e-1) if fault == "noise_1e-1"
               else _zero_first_weight_gradient)
    diffs, _, _, _ = dc.check_step("cpu", 0, config=config, device_context=context)
    assert diffs, fault


def test_bf16_comparisons_refuse_mismatched_leaves():
    rows = [("params", "a.w", 1.0, 0.5)]
    with pytest.raises(ValueError):
        dc.bf16_comparisons(rows, [("params", "b.w", 1.0, 0.5)], np.zeros(len(SCALAR_METRICS)))
    assert dc.bf16_comparisons(rows, [("params", "a.w", 0.3, 9.0)],
                               np.zeros(len(SCALAR_METRICS))) == [("params", "a.w", 1.0,
                                                                   dc.BF16_K * 0.3)]
