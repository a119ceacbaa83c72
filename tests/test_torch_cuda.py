"""The port's CUDA kernel on the card: K1 against its plain version, and the
folded UNet3D on CUDA against the same module on the CPU. Marked `cuda`;
each test skips when no GPU is present. On the card:
    python -m pytest tests/test_torch_cuda.py -m cuda
"""

import numpy as np
import pytest
import torch

from dycon_paper_replication_tpu_torch import weights
from dycon_paper_replication_tpu_torch.config import resolve_device
from dycon_paper_replication_tpu_torch.models import UNet3D, UNet3DConfig
from dycon_paper_replication_tpu_torch.ops.folded_conv_cuda import (
    FoldedConv3,
    folded_conv3_plain,
)

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
