"""The port's UNet3D against the JAX package's, on the CPU in float32.

JAX parameters from `init_unet3d` (feature_scale 16: filters 4..64) go
through numpy and the port's weight mapper into the port's module. The
port's plain and folded forwards must match `unet3d_apply` in the NDHWC and
folded layouts, eval mode, with and without the projection head, to 1e-4
of the largest output magnitude. The mapper must round-trip exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dycon_paper_replication_tpu.models.unet3d import (
    UNet3DConfig as JaxConfig,
    init_unet3d,
    unet3d_apply,
)
from dycon_paper_replication_tpu.models.unet3d_folded import unet3d_seg_folded_io
from dycon_paper_replication_tpu.ops.folding import fold2 as jfold2
from dycon_paper_replication_tpu_torch import weights
from dycon_paper_replication_tpu_torch.models import UNet3D, UNet3DConfig, net_factory_3d
from dycon_paper_replication_tpu_torch.ops.folding import fold2

torch.set_num_threads(1)
REL = 1e-4


@pytest.fixture(scope="module")
def jax_weights():
    cfg = JaxConfig(feature_scale=16)
    params, state = jax.jit(init_unet3d, static_argnums=1)(jax.random.key(3), cfg)
    to_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return cfg, to_np(params), to_np(state)


@pytest.fixture(scope="module")
def image():
    return np.random.default_rng(5).normal(size=(2, 32, 16, 16, 1)).astype(np.float32)


def _port(jax_weights, layout):
    _, params, state = jax_weights
    net = UNet3D(UNet3DConfig(feature_scale=16, layout=layout)).eval()
    net.load_state_dict(weights.jax_tree_to_state_dict(params, state))
    return net


def _close_rel(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=REL * float(np.abs(want).max()))


def test_mapper_round_trip(jax_weights):
    _, params, state = jax_weights
    sd = weights.jax_tree_to_state_dict(params, state)
    p2, s2 = weights.state_dict_to_jax_tree(sd)
    flat = lambda t: jax.tree_util.tree_flatten_with_path(t)[0]  # noqa: E731
    for (ka, a), (kb, b) in zip(flat((params, state)), flat((p2, s2))):
        assert ka == kb
        np.testing.assert_array_equal(a, b)
    assert len(flat((params, state))) == len(flat((p2, s2)))
    # the port's module has exactly these keys and shapes
    net = UNet3D(UNet3DConfig(feature_scale=16))
    assert {k: tuple(v.shape) for k, v in net.state_dict().items()} == {
        k: tuple(v.shape) for k, v in sd.items()}


def test_init_tree_matches_jax_layout(jax_weights):
    cfg, params, state = jax_weights
    p2, s2 = weights.init_jax_tree(UNet3DConfig(feature_scale=16), seed=0)
    shapes = lambda t: jax.tree.map(np.shape, t)  # noqa: E731
    assert shapes(p2) == shapes(params) and shapes(s2) == shapes(state)


@pytest.mark.parametrize("layout", ["NDHWC", "folded"])
@pytest.mark.parametrize("with_projection", [False, True])
def test_forward_matches_jax(jax_weights, image, layout, with_projection):
    cfg, params, state = jax_weights
    jcfg = dataclasses.replace(cfg, layout=layout)
    fwd = jax.jit(lambda p, s, x: unet3d_apply(p, s, x, jcfg,
                                               with_projection=with_projection)[0])
    jsdf, jseg, jfeat = fwd(params, state, jnp.asarray(image))
    net = _port(jax_weights, layout)
    with torch.no_grad():
        sdf, seg, feat = net(torch.from_numpy(image), with_projection=with_projection)
    _close_rel(sdf, jsdf)
    _close_rel(seg, jseg)
    if with_projection:
        _close_rel(feat, jfeat)
    else:
        assert feat is None and jfeat is None


def test_folded_io_matches_jax_and_plain(jax_weights, image):
    cfg, params, state = jax_weights
    fcfg = dataclasses.replace(cfg, layout="folded")
    want = jax.jit(lambda p, s, x: unet3d_seg_folded_io(p, s, x, fcfg))(
        params, state, jfold2(jnp.asarray(image)))
    folded = _port(jax_weights, "folded")
    plain = _port(jax_weights, "NDHWC")
    with torch.no_grad():
        got = folded.apply_seg_folded(fold2(torch.from_numpy(image)))
        _, seg, _ = plain(torch.from_numpy(image), with_projection=False)
    _close_rel(got, want)
    _close_rel(got, fold2(seg).numpy())


def test_factory_builds_on_cpu_and_refuses_other_nets():
    net = net_factory_3d("unet_3D", layout="folded", device="cpu")
    assert net.cfg.filters == (16, 32, 64, 128, 256) and not net.training
    with pytest.raises(ValueError):
        net_factory_3d("unet_2D", device="cpu")
