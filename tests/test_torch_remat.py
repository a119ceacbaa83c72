"""`--remat full` (train/step.py: the student forward recomputed in the
backward pass) against `none`, and against the JAX package's remat step,
on the CPU.

Tolerances, the JAX package's own for its remat step against its plain one
(tests/test_train.py:306-320), stated before the first run: from one state
on one batch, the loss within rtol 1e-6 and every parameter within atol
1e-6; on top of them, bit-equal: the BatchNorms' running statistics (the
recompute must not move them a second time), the teacher's, and the dropout
generator's state after the step (the recompute replays the forward's
masks and puts the generator back where the step without remat leaves
it). Cases, patch (32, 32, 16), batch 4 of which 2 labeled, each model at
its defaults with dropout on (the teacher noise and both dropouts drawn
from one explicit generator): the UNet3D in the folded layout (its K1
twin, FoldedConv3Fn, under the checkpoint), the VNet (31 BatchNorms,
folded) and the UNet3D with ASPP (NDHWC). The student forward runs twice
with remat and once without. Against JAX (tests/test_torch_train_step.py's
case and tolerances: the folded UNet3D with dropout 0, the JAX step's
noise): the port's remat step after the JAX package's remat step, the 8
scalars within rtol 1e-5 + atol 1e-6 and the state within that file's
path-scaled tolerances. A data-parallel remat step is refused.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dycon_paper_replication_tpu import config as jconfig
from dycon_paper_replication_tpu.models.factory import Model
from dycon_paper_replication_tpu.models.unet3d import UNet3DConfig as JaxNetConfig
from dycon_paper_replication_tpu.models.unet3d import init_unet3d, unet3d_apply
from dycon_paper_replication_tpu.train.state import create_train_state as jax_create_state
from dycon_paper_replication_tpu.train.state import make_optimizer
from dycon_paper_replication_tpu.train.step import StepScalars as JaxScalars
from dycon_paper_replication_tpu.train.step import build_train_step as jax_build_train_step
from dycon_paper_replication_tpu_torch import config as tconfig
from dycon_paper_replication_tpu_torch import parallel, weights
from dycon_paper_replication_tpu_torch.models import UNet3DConfig, build_model, model_config
from dycon_paper_replication_tpu_torch.train.state import create_train_state
from dycon_paper_replication_tpu_torch.train.step import StepScalars, build_train_step
from test_torch_train_step import B, LBS, PATCH, _batch, _compare_states, _noise, _np

torch.set_num_threads(1)
SCALARS = (5.0, 0.1 * np.exp(-5.0), 1.3, 0.3)
CASES = {"unet_3D": dict(model="unet_3D", layout="folded"),
         "vnet": dict(model="vnet", layout="folded"),
         "aspp": dict(model="unet_3D", use_aspp=True, layout="NDHWC")}


def _state(case, seed=3):
    net_cfg = model_config(case["model"], scaler=2, use_aspp=case.get("use_aspp", False),
                           layout=case["layout"])
    net = build_model(net_cfg)
    net.load_state_dict(weights.jax_tree_to_state_dict(*weights.init_jax_tree(net_cfg, seed)))
    return create_train_state(net)


@pytest.mark.parametrize("name", list(CASES))
def test_remat_matches_none(name):
    case = CASES[name]
    runs = {}
    for remat in ("none", "full"):
        cfg = tconfig.make_config("pancreas", patch_size=PATCH, batch_size=B, labeled_bs=LBS,
                                  device="cpu", model=case["model"],
                                  use_aspp=case.get("use_aspp", False), remat=remat)
        state = _state(case)
        calls = []
        state.student.register_forward_pre_hook(lambda *_: calls.append(1))
        gen = torch.Generator().manual_seed(7)
        vec, _ = build_train_step(cfg, lambda s: cfg.base_lr)(
            state, {k: torch.from_numpy(v) for k, v in _batch(1).items()}, gen,
            StepScalars(*SCALARS))
        runs[remat] = (vec, state, gen.get_state(), len(calls))
    (vec0, s0, g0, n0), (vec1, s1, g1, n1) = runs["none"], runs["full"]
    assert (n0, n1) == (1, 2)
    assert not vec0[-1] and not vec1[-1]
    np.testing.assert_allclose(vec1[0].item(), vec0[0].item(), rtol=1e-6)
    for (k, p0), p1 in zip(s0.student.named_parameters(), s1.student.parameters()):
        np.testing.assert_allclose(p1.detach().numpy(), p0.detach().numpy(), rtol=0, atol=1e-6,
                                   err_msg=k)
    stats = [(f"student.{k}", b, dict(s1.student.named_buffers())[k])
             for k, b in s0.student.named_buffers()]
    stats += [(f"teacher.{k}", b, dict(s1.teacher.named_buffers())[k])
              for k, b in s0.teacher.named_buffers()]
    assert stats or name == "unet_3D"
    for k, b0, b1 in stats:
        assert torch.equal(b0, b1), k
    assert torch.equal(g0, g1)


def test_remat_refused_with_data_parallel():
    cfg = tconfig.make_config("pancreas", patch_size=PATCH, batch_size=B, labeled_bs=LBS,
                              device="cpu", remat="full")
    with pytest.raises(ValueError, match="data parallelism"):
        build_train_step(cfg, lambda s: cfg.base_lr, parallel.Shard(0, 2, B, LBS))


def test_remat_matches_jax_remat():
    net_cfg = JaxNetConfig(dropout_rate=0.0, layout="folded")
    model = Model(net_cfg, init_unet3d, unet3d_apply)
    cfg = jconfig.make_config("pancreas", patch_size=PATCH, batch_size=B, labeled_bs=LBS,
                              remat="full")
    optimizer = make_optimizer(lambda step: cfg.base_lr, cfg.momentum, cfg.weight_decay,
                               cfg.grad_clip_norm)
    js0 = jax_create_state(model, jax.random.key(11), optimizer)
    step = jax.jit(jax_build_train_step(model, optimizer, cfg, diagnostics=False))
    batch, key = _batch(1), jax.random.key(21)
    js1, metrics = step(js0, {k: jnp.asarray(v) for k, v in batch.items()}, key,
                        JaxScalars.make(*SCALARS))

    tcfg = tconfig.make_config("pancreas", patch_size=PATCH, batch_size=B, labeled_bs=LBS,
                               device="cpu", remat="full")
    port = weights.jax_train_state_to_torch(_np(js0), UNet3DConfig(dropout_rate=0.0,
                                                                  layout="folded"))
    got, _ = build_train_step(tcfg, lambda s: tcfg.base_lr)(
        port, {k: torch.from_numpy(v) for k, v in batch.items()}, torch.Generator().manual_seed(0),
        StepScalars(*SCALARS), noise=torch.tensor(_noise(key, batch["image"].shape)))
    np.testing.assert_allclose(got.numpy(), np.asarray(metrics["scalars"]), rtol=1e-5, atol=1e-6)
    _compare_states(port, [_np(js1)], _np(js0), cfg.base_lr)
