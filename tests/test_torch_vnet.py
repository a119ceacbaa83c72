"""The port's VNet against the JAX package's, on the CPU in float32.

Inputs come from a numpy seed. JAX parameters from `init_vnet` (n_filters
16, filters 16..256) go through numpy and the port's weight mapper into the
port's module, their running stats moved off 0 / 1 so that eval mode reads
them. Tolerances, each stated where it is used:
  * the fold-2 ops and the plain layers: 1e-5 x the largest output
    magnitude (float32 order of a few sums), fold2_phase1 exactly;
  * the forwards (plain and folded, eval and train mode with dropout 0, at
    (2, 32, 32, 16)): 1e-4 x max|output| in eval mode; in train mode the
    nine stacked BatchNorms take batch statistics, and at this size the
    centre's (enc4, 2 x 2 x 1 per sample) span 16 values, so float32 order
    is amplified: 1e-3 x max|output| there, and for the running stats rtol
    1e-4 + atol 1e-5 (tests/test_torch_train_step.py's); the JAX package's
    own folded-vs-plain test holds its VNet to atol + rtol 5e-4 (seg, sdf)
    and 1e-3 (features);
  * gradients of the folded VNet against the plain autograd and against
    jax.grad: tests/test_vnet_folded.py's atol 2e-4 + rtol 1e-2 and a
    cosine above 1 - 1e-5.
The weight mapper must round-trip exactly. Dropout parity: each package
draws its own masks from one key (the port JAX's streams, ops/threefry.py),
and one train-mode forward with dropout on is compared, for the UNet3D and
the VNet, plain and folded (the folded VNet's last mask is drawn on the
phase-1 folded tensor in both packages, tests/test_vnet_folded.py), the
calls' shapes equal.
compute_sdf is held to the JAX package's to 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from dycon_paper_replication_tpu.models import layers as jlayers
from dycon_paper_replication_tpu.models.unet3d import UNet3DConfig as JaxUNetConfig
from dycon_paper_replication_tpu.models.unet3d import init_unet3d, unet3d_apply
from dycon_paper_replication_tpu.models.vnet import VNetConfig as JaxVNetConfig
from dycon_paper_replication_tpu.models.vnet import init_vnet, vnet_apply
from dycon_paper_replication_tpu.ops import folding as jfolding
from dycon_paper_replication_tpu.ops.sdf import compute_sdf as jax_compute_sdf
from dycon_paper_replication_tpu_torch import weights
from dycon_paper_replication_tpu_torch.models import (
    UNet3D,
    UNet3DConfig,
    VNet,
    VNetConfig,
    layers,
    net_factory_3d,
)
from dycon_paper_replication_tpu_torch.ops import folding
from dycon_paper_replication_tpu_torch.ops.sdf import compute_sdf

torch.set_num_threads(1)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _close_rel(got, want, rel):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * float(np.abs(want).max()))


@pytest.fixture(scope="module")
def jax_vnet():
    params, state = jax.jit(init_vnet, static_argnums=1)(jax.random.key(11), JaxVNetConfig())
    state = jax.tree.map(lambda v: v + 0.25, _np(state))  # running stats off 0 / 1
    return _np(params), state


@pytest.fixture(scope="module")
def image():
    return np.random.default_rng(5).normal(size=(2, 32, 32, 16, 1)).astype(np.float32)


def _port_vnet(jax_vnet, **kw):
    net = VNet(VNetConfig(**kw))
    net.load_state_dict(weights.jax_tree_to_state_dict(*jax_vnet))
    return net


# --- the five fold-2 ops ---------------------------------------------------

def test_fold2_phase1_matches_jax():
    x = np.random.default_rng(0).normal(size=(2, 8, 12, 4, 3)).astype(np.float32)
    got = folding.fold2_phase1(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jfolding.fold2_phase1(jnp.asarray(x))))
    assert got.shape == (2, 5, 7, 3, 24)
    np.testing.assert_array_equal(folding.unfold2_phase1(got).numpy(), x)


@pytest.mark.parametrize("fold_output", [False, True])
def test_strided_conv2_folded_matches_jax(fold_output):
    rng = np.random.default_rng(1)
    x = folding.fold2(torch.from_numpy(rng.normal(size=(2, 8, 8, 16, 3)).astype(np.float32)))
    w = rng.normal(size=(2, 2, 2, 3, 7)).astype(np.float32) * 0.2
    b = rng.normal(size=7).astype(np.float32)
    want = jfolding.strided_conv2_folded(jnp.asarray(x.numpy()), jnp.asarray(w), jnp.asarray(b),
                                         fold_output=fold_output)
    got = folding.strided_conv2_folded(x, torch.from_numpy(w), torch.from_numpy(b),
                                       fold_output=fold_output)
    _close_rel(got, want, 1e-5)


def test_transposed_conv2_to_folded_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 4, 4, 3, 5)).astype(np.float32)
    w = rng.normal(size=(2, 2, 2, 5, 3)).astype(np.float32) * 0.2
    b = rng.normal(size=3).astype(np.float32)
    want = jfolding.transposed_conv2_to_folded(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    got = folding.transposed_conv2_to_folded(*(torch.from_numpy(a) for a in (x, w, b)))
    _close_rel(got, want, 1e-5)
    # equal to the plain transposed conv, folded
    plain = layers.conv_transpose3d(*(torch.from_numpy(a) for a in (x, w, b)))
    _close_rel(got, folding.fold2(plain).numpy(), 1e-5)


@pytest.mark.parametrize("phase", [0, 1])
@pytest.mark.parametrize("train", [True, False])
def test_batch_norm_folded_matches_jax(phase, train):
    """Phase 0 without masks, phase 1 (grid + 1) with the factored masks;
    the output, and the new running stats (moved in train mode, the old
    ones in eval mode)."""
    rng = np.random.default_rng(3)
    grid, c = (4, 5, 3), 3
    g = tuple(n + phase for n in grid)
    x = (rng.normal(size=(2, *g, 8 * c)) * 1.5 + 0.4).astype(np.float32)
    params = {"scale": rng.normal(size=c).astype(np.float32) + 1.0,
              "bias": rng.normal(size=c).astype(np.float32)}
    state = {"mean": rng.normal(size=c).astype(np.float32) * 0.1,
             "var": rng.random(c).astype(np.float32) + 0.5}
    n_valid = 8 * np.prod(grid)
    jmasks = jfolding.phase1_lane_masks(g, c) if phase else None
    want, want_state = jfolding.batch_norm_folded(params, state, jnp.asarray(x), n_valid, jmasks,
                                                  train=train)
    masks = folding.phase1_lane_masks(g, c) if phase else None
    t = {k: torch.from_numpy(v) for k, v in {**params, **state}.items()}
    got, mean, var = folding.batch_norm_folded(torch.from_numpy(x), t["scale"], t["bias"],
                                               t["mean"], t["var"], n_valid, masks, train=train)
    _close_rel(got, want, 1e-5)
    np.testing.assert_allclose(mean.numpy(), want_state["mean"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(var.numpy(), want_state["var"], rtol=1e-5, atol=1e-6)
    if not train:
        assert mean is t["mean"] and var is t["var"]


# --- the plain layers ------------------------------------------------------

def test_conv_transpose3d_matches_jax_and_needs_the_flip():
    """The JAX layer mirrors the kernel against F.conv_transpose3d: the
    port's layer equals JAX's, and torch's transposed conv of the same,
    unflipped weights does not (so the flip cannot be dropped)."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 3, 4, 2, 5)).astype(np.float32)
    w = rng.normal(size=(2, 2, 2, 5, 6)).astype(np.float32)
    b = rng.normal(size=6).astype(np.float32)
    want = np.asarray(jlayers.conv_transpose3d({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                                               jnp.asarray(x)))
    got = layers.conv_transpose3d(*(torch.from_numpy(a) for a in (x, w, b)))
    _close_rel(got, want, 1e-5)
    unflipped = F.conv_transpose3d(torch.from_numpy(x).permute(0, 4, 1, 2, 3),
                                   torch.from_numpy(w).permute(3, 4, 0, 1, 2),
                                   torch.from_numpy(b), stride=2).permute(0, 2, 3, 4, 1)
    assert np.abs(unflipped.numpy() - want).max() > 0.1 * np.abs(want).max()


@pytest.mark.parametrize("kind", ["strided", "dilated", "bias_free"])
def test_conv3d_options_match_jax(kind):
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 8, 6, 4, 3)).astype(np.float32)
    k = 2 if kind == "strided" else 3
    w = rng.normal(size=(k, k, k, 3, 4)).astype(np.float32) * 0.2
    b = rng.normal(size=4).astype(np.float32)
    jp = {"w": jnp.asarray(w)} if kind == "bias_free" else {"w": jnp.asarray(w),
                                                             "b": jnp.asarray(b)}
    kw = {"strided": dict(stride=2, padding="VALID"), "dilated": dict(dilation=3),
          "bias_free": {}}[kind]
    jkw = {"strided": dict(stride=(2, 2, 2), padding="VALID"), "dilated":
           dict(dilation=(3, 3, 3)), "bias_free": {}}[kind]
    want = jlayers.conv3d(jp, jnp.asarray(x), **jkw)
    got = layers.conv3d(torch.from_numpy(x), torch.from_numpy(w),
                        None if kind == "bias_free" else torch.from_numpy(b), **kw)
    _close_rel(got, want, 1e-5)
    conv = layers.Conv3d(3, 4, (3, 3, 3), use_bias=False)
    assert conv.b is None and set(conv.state_dict()) == {"w"}


# --- the model -------------------------------------------------------------

@pytest.mark.parametrize("layout", ["NDHWC", "folded"])
@pytest.mark.parametrize("train", [False, True])
def test_vnet_forward_matches_jax(jax_vnet, image, layout, train):
    params, state = jax_vnet
    jcfg = JaxVNetConfig(dropout_rate=0.0, layout=layout)
    (jsdf, jseg, jfeat), jstate = jax.jit(
        lambda p, s, x: vnet_apply(p, s, x, jcfg, train=train))(params, state, jnp.asarray(image))
    net = _port_vnet(jax_vnet, dropout_rate=0.0, layout=layout).train(train)
    with torch.no_grad():
        sdf, seg, feat = net(torch.from_numpy(image))
    rel = 1e-3 if train else 1e-4
    for got, want in ((sdf, jsdf), (seg, jseg), (feat, jfeat)):
        _close_rel(got, want, rel)
    # the BatchNorm state after the forward, leaf by leaf: moved in train
    # mode, untouched in eval mode
    _, got_state = weights.state_dict_to_jax_tree(net.state_dict())
    got_flat, want_flat = _flat(got_state), _flat(_np(jstate))
    assert got_flat.keys() == want_flat.keys() and len(want_flat) == 2 * 31
    for k, v in want_flat.items():
        np.testing.assert_allclose(got_flat[k], v, rtol=1e-4, atol=1e-5, err_msg=k)
        assert train or np.array_equal(got_flat[k], _flat(state)[k])


def test_vnet_without_projection(jax_vnet, image):
    net = _port_vnet(jax_vnet, layout="folded").eval()
    with torch.no_grad():
        sdf, seg, feat = net(torch.from_numpy(image), with_projection=False)
    assert feat is None and sdf.shape == seg.shape == (2, 32, 32, 16, 2)


def test_folded_vnet_grads_match_plain_and_jax(jax_vnet):
    """d(cross entropy of seg)/d(params) in eval mode at (1, 16, 16, 16), as
    tests/test_vnet_folded.py: the port's folded autograd against its plain
    autograd and against jax.grad of the JAX plain VNet."""
    params, state = jax_vnet
    rng = np.random.default_rng(6)
    x = rng.normal(size=(1, 16, 16, 16, 1)).astype(np.float32)
    y = rng.integers(0, 2, size=(1, 16, 16, 16))

    def jloss(p):
        (_, seg, _), _ = vnet_apply(p, state, jnp.asarray(x), JaxVNetConfig(),
                                    with_projection=False)
        lp = jax.nn.log_softmax(seg, axis=-1)
        return -jnp.mean(jnp.take_along_axis(lp, jnp.asarray(y)[..., None], axis=-1))

    want = _flat(_np(jax.jit(jax.grad(jloss))(params)))
    grads = {}
    for layout in ("NDHWC", "folded"):
        net = _port_vnet(jax_vnet, layout=layout).eval()
        _, seg, _ = net(torch.from_numpy(x), with_projection=False)
        F.cross_entropy(seg.reshape(-1, 2), torch.from_numpy(y).reshape(-1)).backward()
        grads[layout] = {k: (p.grad if p.grad is not None else torch.zeros_like(p)).numpy()
                         for k, p in net.named_parameters()}
    keys = sorted(want)
    assert sorted(grads["folded"]) == keys
    flat = {name: np.concatenate([g[k].ravel() for k in keys])
            for name, g in (("jax", want), *grads.items())}
    for a, b in (("folded", "NDHWC"), ("folded", "jax"), ("NDHWC", "jax")):
        np.testing.assert_allclose(flat[a], flat[b], atol=2e-4, rtol=1e-2, err_msg=f"{a} {b}")
        cos = flat[a] @ flat[b] / (np.linalg.norm(flat[a]) * np.linalg.norm(flat[b]))
        assert cos > 1 - 1e-5, (a, b, cos)


def test_mapper_round_trip_and_init_layout(jax_vnet):
    params, state = jax_vnet
    sd = weights.jax_tree_to_state_dict(params, state)
    p2, s2 = weights.state_dict_to_jax_tree(sd)
    leaves = lambda t: jax.tree_util.tree_flatten_with_path(t)[0]  # noqa: E731
    assert len(leaves((params, state))) == len(leaves((p2, s2)))
    for (ka, a), (kb, b) in zip(leaves((params, state)), leaves((p2, s2))):
        assert ka == kb
        np.testing.assert_array_equal(a, b)
    net = VNet(VNetConfig())
    assert {k: tuple(v.shape) for k, v in net.state_dict().items()} == {
        k: tuple(v.shape) for k, v in sd.items()}
    ip, is_ = weights.init_jax_tree(VNetConfig(), seed=0)
    shapes = lambda t: jax.tree.map(np.shape, t)  # noqa: E731
    assert shapes(ip) == shapes(params) and shapes(is_) == shapes(state)


def test_factory_builds_vnet_and_ignores_aspp():
    net = net_factory_3d("vnet", scaler=2, use_aspp=True, layout="folded", device="cpu")
    assert isinstance(net, VNet) and not net.training and net.cfg.layout == "folded"
    assert net.cfg.filters == (16, 32, 64, 128, 256) and net.cfg.scale_factor == 2
    assert not any(k.startswith("aspp") for k in net.state_dict())
    assert not hasattr(net, "apply_seg_folded")


# --- dropout parity --------------------------------------------------------

class _DropoutShapes:
    """Both packages' layers.dropout, unchanged, recording the shape of each
    call that drops out (the JAX one at its trace)."""

    def __init__(self):
        self.jax_shapes, self.port_shapes = [], []
        self.real_jax, self.real_port = jlayers.dropout, layers.dropout

    def jax(self, x, rate, key, train):
        if train and rate != 0.0 and key is not None:
            self.jax_shapes.append(tuple(x.shape))
        return self.real_jax(x, rate, key, train)

    def port(self, x, rate, key, train):
        if train and rate != 0.0 and key is not None:
            self.port_shapes.append(tuple(x.shape))
        return self.real_port(x, rate, key, train)


@pytest.mark.parametrize("model", ["unet_3D", "vnet"])
@pytest.mark.parametrize("layout", ["NDHWC", "folded"])
def test_dropout_on_matches_jax(jax_vnet, image, monkeypatch, model, layout):
    """One train-mode forward with dropout on (0.3 in the UNet3D, 0.5 in the
    VNet) through both packages from the same key, each drawing its own
    masks (JAX's streams in the port, ops/threefry.py): 1e-3 x max|output|
    (the train-mode tolerance above)."""
    if model == "vnet":
        params, state = jax_vnet
        jcfg = JaxVNetConfig(layout=layout)
        apply, net = vnet_apply, _port_vnet(jax_vnet, layout=layout)
    else:
        jcfg = JaxUNetConfig(feature_scale=16, layout=layout)
        params, state = _np(jax.jit(init_unet3d, static_argnums=1)(jax.random.key(3), jcfg))
        apply, net = unet3d_apply, UNet3D(UNet3DConfig(feature_scale=16, layout=layout))
        net.load_state_dict(weights.jax_tree_to_state_dict(params, state))
    calls = _DropoutShapes()
    monkeypatch.setattr(jlayers, "dropout", calls.jax)
    monkeypatch.setattr(layers, "dropout", calls.port)
    want, _ = jax.jit(lambda p, s, x: apply(p, s, x, jcfg, train=True, rng=jax.random.key(0)))(
        params, state, jnp.asarray(image))
    with torch.no_grad():
        got = net.train()(torch.from_numpy(image),
                          key=np.asarray(jax.random.key_data(jax.random.key(0))))
    assert len(calls.jax_shapes) == 2 and calls.port_shapes == calls.jax_shapes
    for g, w in zip(got, want):
        _close_rel(g, w, 1e-3)


# --- compute_sdf -----------------------------------------------------------

def test_compute_sdf_matches_jax():
    rng = np.random.default_rng(8)
    grid = np.stack(np.meshgrid(*[np.arange(s) for s in (20, 18, 16)], indexing="ij"), -1)
    masks = [(((grid - rng.uniform(5, 12, 3)) / rng.uniform(3, 6, 3)) ** 2).sum(-1) <= 1.0
             for _ in range(2)]
    seg = np.stack(masks + [np.zeros((20, 18, 16), bool)]).astype(np.float32)
    got = compute_sdf(seg)
    want = jax_compute_sdf(seg)
    assert got.dtype == np.float32 and got.shape == seg.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert not got[2].any()  # the empty mask
    assert got[0].min() == -1.0 and got[0].max() == 1.0
    assert (got[0][seg[0] > 0] <= 0).all() and (got[0][seg[0] == 0] > 0).all()
