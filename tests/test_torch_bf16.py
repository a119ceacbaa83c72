"""The port's bfloat16 compute against the JAX package's, on the CPU.

Same numpy inputs and weights through both packages with compute dtype
bfloat16: every conv casts its input and weight to bfloat16 and emits
bfloat16, the bias cast to the output's dtype; the norms keep their input's
dtype; the heads are float32.

Tolerance rule, stated before the first run and not tuned afterwards:
max |port - JAX| <= K x max |JAX_bf16 - float64|, with K = 2, where
float64 is the same function of the same (float32) inputs and weights in
float64 (the port's NDHWC path in double: an independent layout from the
folded one under test). Both packages round each conv output to bfloat16
once from a float32 sum; their sums differ in order, so at most a rounding
flip per output separates them, while the yardstick carries the
bfloat16 rounding of inputs, weights and outputs.

  * each fold-2 op (ops/folding.py: folded_conv3 in both phases,
    conv1x1_folded, strided_conv2_folded, transposed_conv2_to_folded) and
    models/layers.py's conv3d (3^3, strided, dilated, 1^3) and
    conv_transpose3d; the norms keep bfloat16;
  * the plain versions of K1 and K1-dW in bfloat16 (the CPU side of the
    kernels) against the Pallas kernel `folded_conv3_pallas` run in
    interpret mode and its custom VJP `_conv_wf`: y, dx and dwf, all
    bfloat16 (the Pallas kernel takes square taps only: L 16 -> 16), and
    the plain K1-dW against `_dwf(...).astype(bfloat16)` (square lanes) and
    against jax.vjp of the JAX package's XLA folded conv in bfloat16 at
    L 8 -> 128;
  * a dtype trace: every conv call's input and output dtype equals JAX's,
    call site by call site, for both families in both layouts (no silent
    float32 promotion at a bias or a concatenation);
  * the UNet3D (plain, folded, with ASPP) and the VNet (plain, folded), in
    eval and train mode. The JAX ASPP passes no compute dtype to its convs,
    so its bfloat16 model stops at lax.conv's mixed operands; the reference
    for the ASPP case casts those convs as the JAX package's other convs do
    (a test-side patch, no JAX file changes).
"""

import contextlib
import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dycon_paper_replication_tpu.models import layers as jlayers
from dycon_paper_replication_tpu.models import unet3d_folded as jufold
from dycon_paper_replication_tpu.models import vnet_folded as jvfold
from dycon_paper_replication_tpu.models.unet3d import UNet3DConfig as JU
from dycon_paper_replication_tpu.models.unet3d import init_unet3d, unet3d_apply
from dycon_paper_replication_tpu.models.vnet import VNetConfig as JV
from dycon_paper_replication_tpu.models.vnet import init_vnet, vnet_apply
from dycon_paper_replication_tpu.ops import folding as jfold
from dycon_paper_replication_tpu.ops.folded_conv_pallas import (
    _conv_wf,
    _dwf,
    folded_conv3_pallas,
)
from dycon_paper_replication_tpu_torch import weights
from dycon_paper_replication_tpu_torch.models import UNet3D, UNet3DConfig, VNet, VNetConfig
from dycon_paper_replication_tpu_torch.models import layers as tlayers
from dycon_paper_replication_tpu_torch.models import unet3d_folded as tufold
from dycon_paper_replication_tpu_torch.models import vnet_folded as tvfold
from dycon_paper_replication_tpu_torch.ops import folding as tfold
from dycon_paper_replication_tpu_torch.ops.folded_conv_cuda import (
    FoldedConv3Fn,
    folded_conv3_dw_plain,
    folded_conv3_plain,
)

torch.set_num_threads(1)
K = 2.0
BF = torch.bfloat16
JBF = jnp.bfloat16
IMAGE = (2, 32, 32, 16, 1)


def _f32(a):
    return np.asarray(jnp.asarray(a, jnp.float32) if isinstance(a, jax.Array) else a,
                      np.float64)


def _t(a):
    """A torch tensor of `a` (torch or JAX or numpy) as float64 numpy."""
    if isinstance(a, torch.Tensor):
        return a.detach().to(torch.float64).numpy()
    return _f32(a)


def _rule(got, want, ref, what=""):
    """The module doc's rule: max|got - want| <= K x max|want - ref|."""
    g, w, r = _t(got), _t(want), _t(ref)
    assert g.shape == w.shape == r.shape, (what, g.shape, w.shape, r.shape)
    diff, yard = np.abs(g - w).max(), np.abs(w - r).max()
    assert np.isfinite(g).all() and diff <= K * yard, f"{what}: {diff} > {K} x {yard}"


def _arr(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _both(a):
    return torch.from_numpy(a), jnp.asarray(a)


@pytest.mark.parametrize("op", ["conv3_to1", "conv3_to0", "conv1x1", "strided", "strided_fold",
                                "transposed"])
def test_folding_ops_bf16_match_jax(rng, op):
    ci, co = 2, 4
    if op.startswith("conv3"):
        tp = 1 if op == "conv3_to1" else 0
        x = _arr(rng, 2, *((5, 6, 4) if tp else (6, 7, 5)), 8 * ci)
        w, b = _arr(rng, 3, 3, 3, ci, co, scale=0.3), _arr(rng, co)
        fn_t = lambda x_, w_, b_, cd: tfold.folded_conv3(x_, w_, b_, to_phase=tp,  # noqa: E731
                                                         compute_dtype=cd)
        fn_j = lambda x_, w_, b_, cd: jfold.folded_conv3(x_, w_, b_, to_phase=tp,  # noqa: E731
                                                         compute_dtype=cd)
    elif op == "conv1x1":
        x, w, b = _arr(rng, 2, 4, 4, 2, 8 * ci), _arr(rng, 1, 1, 1, ci, co), _arr(rng, co)
        fn_t = lambda x_, w_, b_, cd: tfold.conv1x1_folded(x_, w_, b_, cd)  # noqa: E731
        fn_j = lambda x_, w_, b_, cd: jfold.conv1x1_folded(x_, w_, b_, cd)  # noqa: E731
    elif op.startswith("strided"):
        fo = op == "strided_fold"
        x, w, b = _arr(rng, 2, 4, 4, 2, 8 * ci), _arr(rng, 2, 2, 2, ci, co), _arr(rng, co)
        fn_t = lambda x_, w_, b_, cd: tfold.strided_conv2_folded(  # noqa: E731
            x_, w_, b_, compute_dtype=cd, fold_output=fo)
        fn_j = lambda x_, w_, b_, cd: jfold.strided_conv2_folded(  # noqa: E731
            x_, w_, b_, compute_dtype=cd, fold_output=fo)
    else:
        x, w, b = _arr(rng, 2, 3, 4, 2, ci), _arr(rng, 2, 2, 2, ci, co), _arr(rng, co)
        fn_t = lambda x_, w_, b_, cd: tfold.transposed_conv2_to_folded(  # noqa: E731
            x_, w_, b_, compute_dtype=cd)
        fn_j = lambda x_, w_, b_, cd: jfold.transposed_conv2_to_folded(  # noqa: E731
            x_, w_, b_, compute_dtype=cd)
    (tx, jx), (tw, jw), (tb, jb) = _both(x), _both(w), _both(b)
    got = fn_t(tx, tw, tb, BF)
    want = fn_j(jx, jw, jb, JBF)
    ref = fn_t(tx.double(), tw.double(), tb.double(), torch.float64)
    assert got.dtype == BF and want.dtype == JBF
    _rule(got, want, ref, op)


@pytest.mark.parametrize("case", ["3x3x3", "strided", "dilated", "1x1x1", "transposed"])
def test_layer_convs_bf16_match_jax(rng, case):
    ci, co = 3, 5
    kernel = {"strided": (2, 2, 2), "1x1x1": (1, 1, 1), "transposed": (2, 2, 2)}.get(case,
                                                                                  (3, 3, 3))
    x, w, b = _arr(rng, 2, 6, 8, 4, ci), _arr(rng, *kernel, ci, co, scale=0.3), _arr(rng, co)
    kw_t, kw_j = {}, {}
    if case == "strided":
        kw_t, kw_j = dict(stride=2, padding="VALID"), dict(stride=(2, 2, 2), padding="VALID")
    elif case == "dilated":
        kw_t, kw_j = dict(dilation=2), dict(dilation=(2, 2, 2))
    (tx, jx), (tw, jw), (tb, jb) = _both(x), _both(w), _both(b)
    if case == "transposed":
        got = tlayers.conv_transpose3d(tx, tw, tb, compute_dtype=BF)
        want = jlayers.conv_transpose3d({"w": jw, "b": jb}, jx, compute_dtype=JBF)
        ref = tlayers.conv_transpose3d(tx.double(), tw.double(), tb.double())
    else:
        got = tlayers.conv3d(tx, tw, tb, compute_dtype=BF, **kw_t)
        want = jlayers.conv3d({"w": jw, "b": jb}, jx, compute_dtype=JBF, **kw_j)
        ref = tlayers.conv3d(tx.double(), tw.double(), tb.double(), **kw_t)
    assert got.dtype == BF and want.dtype == JBF
    _rule(got, want, ref, case)


def test_norms_keep_bf16_and_match_jax(rng):
    x = _arr(rng, 2, 4, 4, 3, 6, scale=3.0)
    tx, jx = torch.from_numpy(x).to(BF), jnp.asarray(x).astype(JBF)
    ref = torch.from_numpy(x).to(BF).double()
    got = tlayers.instance_norm(tx)
    assert got.dtype == BF
    _rule(got, jlayers.instance_norm(jx), tlayers.instance_norm(ref), "instance_norm")
    scale, bias = _arr(rng, 6) + 1.0, _arr(rng, 6)
    mean, var = np.zeros(6, np.float32), np.ones(6, np.float32)
    p = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}
    s = {"mean": jnp.asarray(mean), "var": jnp.asarray(var)}
    args = [torch.from_numpy(a) for a in (scale, bias, mean, var)]
    y, new_mean, new_var = tlayers.batch_norm_train(tx, *args)
    jy, js = jlayers.batch_norm(p, s, jx, train=True)
    y64, _, _ = tlayers.batch_norm_train(ref, *args)
    assert y.dtype == BF and new_mean.dtype == new_var.dtype == torch.float32
    _rule(y, jy, y64, "batch_norm train")
    _rule(new_var, js["var"], tlayers.batch_norm_train(ref, *args)[2], "running var")
    ye = tlayers.batch_norm(tx, *args)
    assert ye.dtype == BF
    _rule(ye, jlayers.batch_norm(p, s, jx, train=False)[0], tlayers.batch_norm(ref, *args),
          "batch_norm eval")
    keep = tlayers.dropout(tx, 0.3, np.array([0, 0], np.uint32), True)
    assert keep.dtype == BF


@pytest.mark.parametrize("to_phase", [1, 0])
def test_k1_twins_bf16_match_pallas_and_custom_vjp(rng, to_phase):
    """y, dx and dwf of FoldedConv3Fn's CPU side (the plain twins of K1,
    its dx and K1-dW) in bfloat16 against the Pallas kernel in interpret
    mode and its custom VJP, at L 16 -> 16."""
    grid = (4, 5, 3) if to_phase == 1 else (5, 6, 4)
    q = tuple(g + (1 if to_phase == 1 else -1) for g in grid)
    x, wf, dy = _arr(rng, 2, *grid, 16), _arr(rng, 2, 2, 2, 16, 16, scale=0.3), _arr(rng, 2, *q, 16)
    (tx, jx), (tw, jw), (tdy, jdy) = _both(x), _both(wf), _both(dy)
    jx, jw, jdy = jx.astype(JBF), jw.astype(JBF), jdy.astype(JBF)
    pallas = folded_conv3_pallas(jx, jw, to_phase=to_phase, interpret=True)
    jy, vjp = jax.vjp(lambda a, b: _conv_wf(a, b, to_phase, True), jx, jw)
    jdx, jdwf = vjp(jdy)
    assert pallas.dtype == jy.dtype == jdx.dtype == jdwf.dtype == JBF
    np.testing.assert_array_equal(_t(pallas), _t(jy))

    xr = tx.to(BF).requires_grad_()
    wr = tw.to(BF).requires_grad_()
    y = FoldedConv3Fn.apply(xr, wr, to_phase)
    y.backward(tdy.to(BF))
    assert y.dtype == xr.grad.dtype == wr.grad.dtype == BF
    x64, w64 = tx.to(BF).double().requires_grad_(), tw.to(BF).double().requires_grad_()
    y64 = folded_conv3_plain(x64, w64, to_phase=to_phase)
    y64.backward(tdy.to(BF).double())
    _rule(y, jy, y64, "y")
    _rule(xr.grad, jdx, x64.grad, "dx")
    _rule(wr.grad, jdwf, w64.grad, "dwf")


@pytest.mark.parametrize("to_phase", [1, 0])
@pytest.mark.parametrize("lin,lout", [(16, 16), (8, 128)])
def test_dw_twin_bf16_matches_jax_dwf(rng, to_phase, lin, lout):
    grid = (4, 3, 5)
    q = tuple(g + (1 if to_phase == 1 else -1) for g in grid)
    x, dy = _arr(rng, 2, *grid, lin), _arr(rng, 2, *q, lout)
    tx, tdy = torch.from_numpy(x).to(BF), torch.from_numpy(dy).to(BF)
    got = folded_conv3_dw_plain(tx, tdy, to_phase=to_phase)
    jx, jdy = jnp.asarray(x).astype(JBF), jnp.asarray(dy).astype(JBF)
    if lin == lout:
        want = _dwf(jx, jdy, to_phase).astype(JBF)
    else:  # `_dwf` reshapes to (.., L, L): the XLA conv's own weight gradient
        conv = lambda wf: jax.lax.conv_general_dilated(  # noqa: E731
            jx, wf, (1, 1, 1), [(1, 1) if to_phase else (0, 0)] * 3,
            dimension_numbers=("NDHWC", "DHWIO", "NDHWC"))
        want = jax.vjp(conv, jnp.zeros((2, 2, 2, lin, lout), JBF))[1](jdy)[0]
    ref = folded_conv3_dw_plain(tx.double(), tdy.double(), to_phase=to_phase)
    assert got.dtype == BF
    _rule(got, want, ref, "dwf")


# ---- models ------------------------------------------------------------------

_JAX_CONVS = {
    "conv3d": (jlayers, "conv3d"), "conv_transpose3d": (jlayers, "conv_transpose3d"),
    "folded_conv3": [(jufold, "folded_conv3"), (jvfold, "folded_conv3")],
    "conv1x1_folded": [(jufold, "conv1x1_folded"), (jvfold, "conv1x1_folded")],
    "strided_conv2_folded": [(jvfold, "strided_conv2_folded")],
    "transposed_conv2_to_folded": [(jvfold, "transposed_conv2_to_folded")],
}
_PORT_CONVS = {
    "conv3d": [(tlayers, "conv3d")], "conv_transpose3d": [(tlayers, "conv_transpose3d")],
    "folded_conv3": [(tufold, "folded_conv3"), (tvfold, "folded_conv3")],
    "conv1x1_folded": [(tufold, "conv1x1_folded"), (tvfold, "conv1x1_folded")],
    "strided_conv2_folded": [(tvfold, "strided_conv2_folded")],
    "transposed_conv2_to_folded": [(tvfold, "transposed_conv2_to_folded")],
}


def _traced(table, calls, x_arg):
    """mock.patch objects that record (conv, input shape, input dtype,
    output dtype) of every call of the convs in `table`; `x_arg` is the
    position of the input (JAX layers take params first)."""
    patches = []
    for name, sites in table.items():
        sites = sites if isinstance(sites, list) else [sites]
        for module, attr in sites:
            real = getattr(module, attr)

            def wrapped(*args, _real=real, _name=name, **kwargs):
                i = x_arg if _name in ("conv3d", "conv_transpose3d") else 0
                x = args[i]
                y = _real(*args, **kwargs)
                calls.append((_name, tuple(x.shape), str(x.dtype).split(".")[-1],
                              str(y.dtype).split(".")[-1]))
                return y

            patches.append(mock.patch.object(module, attr, wrapped))
    return patches


def _stack(patches):
    stack = contextlib.ExitStack()
    for p in patches:
        stack.enter_context(p)
    return stack


def _family(family, layout, dtype):
    """(JAX config, init, apply, port module) of a family at test width."""
    if family == "vnet":
        jcfg = JV(n_filters=4, dropout_rate=0.0, layout=layout,
                  compute_dtype=JBF if dtype == BF else jnp.float32)
        net = VNet(VNetConfig(n_filters=4, dropout_rate=0.0, layout=layout, compute_dtype=dtype))
        return jcfg, init_vnet, vnet_apply, net
    aspp = family == "aspp"
    jcfg = JU(feature_scale=16, dropout_rate=0.0, layout=layout, use_aspp=aspp,
              compute_dtype=JBF if dtype == BF else jnp.float32)
    net = UNet3D(UNet3DConfig(feature_scale=16, dropout_rate=0.0, layout=layout, use_aspp=aspp,
                              compute_dtype=dtype))
    return jcfg, init_unet3d, unet3d_apply, net


@functools.lru_cache(maxsize=None)
def _weights(family):
    """The JAX (params, state) of a family, as numpy; they depend on neither
    the layout nor the compute dtype."""
    jcfg, init, _, _ = _family(family, "NDHWC", torch.float32)
    return jax.tree.map(np.asarray, jax.jit(init, static_argnums=1)(jax.random.key(3), jcfg))


@pytest.fixture(scope="module")
def image():
    return np.random.default_rng(5).normal(size=IMAGE).astype(np.float32)


def _aspp_convs_in_compute_dtype():
    """The JAX ASPP's convs with the compute dtype of their input: the
    reference's stand-in (module doc)."""
    real = jlayers.conv3d

    def conv3d(params, x, **kwargs):
        if kwargs.get("compute_dtype") is None:
            kwargs["compute_dtype"] = x.dtype
        return real(params, x, **kwargs)

    from dycon_paper_replication_tpu.models import aspp as jaspp

    return mock.patch.object(jaspp.layers, "conv3d", conv3d)


@pytest.mark.parametrize("family,layout", [("unet_3D", "NDHWC"), ("unet_3D", "folded"),
                                           ("vnet", "NDHWC"), ("vnet", "folded")])
def test_dtype_trace_matches_jax(image, family, layout):
    jcfg, _, apply, net = _family(family, layout, BF)
    params, state = _weights(family)
    net.load_state_dict(weights.jax_tree_to_state_dict(params, state))
    want, got = [], []
    patches = _traced(_JAX_CONVS, want, 1)
    with _stack(patches):  # traced only: the dtypes are known at trace time
        jax.eval_shape(lambda p, s, x: apply(p, s, x, jcfg, train=True), params, state,
                       jnp.asarray(image))
    with _stack(_traced(_PORT_CONVS, got, 0)), torch.no_grad():
        net.train()(torch.from_numpy(image))
    assert got and sorted(got) == sorted(want)
    assert any(c[3] == "bfloat16" for c in got)


@pytest.mark.parametrize("family,layout", [("unet_3D", "NDHWC"), ("unet_3D", "folded"),
                                           ("aspp", "NDHWC"), ("aspp", "folded"),
                                           ("vnet", "NDHWC"), ("vnet", "folded")])
@pytest.mark.parametrize("train", [False, True])
def test_model_bf16_matches_jax(image, family, layout, train):
    jcfg, _, apply, net = _family(family, layout, BF)
    params, state = _weights(family)
    sd = weights.jax_tree_to_state_dict(params, state)
    net.load_state_dict(sd)
    _, _, _, ref = _family(family, "NDHWC", torch.float64)
    ref.load_state_dict(sd)
    ref = ref.double()
    with _aspp_convs_in_compute_dtype():
        (jsdf, jseg, jfeat), _ = jax.jit(lambda p, s, x: apply(p, s, x, jcfg, train=train))(
            params, state, jnp.asarray(image))
    with torch.no_grad():
        got = net.train(train)(torch.from_numpy(image))
        want64 = ref.train(train)(torch.from_numpy(image).double())
    for name, g, w, r in zip(("sdf", "seg", "features"), got, (jsdf, jseg, jfeat), want64):
        assert g.dtype == torch.float32
        _rule(g, w, r, f"{family} {layout} train={train} {name}")
