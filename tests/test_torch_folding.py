"""The port's fold-2 engine against the JAX package's, on the CPU in float32.

Each function of dycon_paper_replication_tpu_torch/ops/folding.py gets the
same numpy inputs as its JAX counterpart; the port's folded conv (on the
CPU, its plain F.conv3d version) is also held against the Pallas kernel
`folded_conv3_pallas` run in interpret mode, as the JAX package's own test
runs it. Tolerance: absolute 2e-4, as in tests/test_folded_conv_pallas.py.

The differentiable conv `FoldedConv3Fn` (forward K1, backward dx through K1
and dwf through K1-dW; on the CPU their plain versions) is held against
`jax.vjp` of `folded_conv3_via_pallas(..., interpret=True)`, the Pallas
kernel's custom VJP, at L 16 -> 16. That kernel takes square taps only
(its weight block is (2, 2, 2, L, L)), so at L 8 -> 128 it is held against
`jax.vjp` of the XLA folded conv and the VJP's own `_dwf`. Tolerance for
dx, dw and db: 1e-5 x the largest magnitude of the JAX gradient. It is
also held against autograd of the plain F.conv3d path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dycon_paper_replication_tpu.ops import folding as jfold
from dycon_paper_replication_tpu.ops.folded_conv_pallas import (
    _dwf,
    folded_conv3_pallas,
    folded_conv3_via_pallas,
)
from dycon_paper_replication_tpu_torch.ops import folding as tfold
from dycon_paper_replication_tpu_torch.ops.folded_conv_cuda import (
    FoldedConv3Fn,
    DW_BLOCKS_PER_SM,
    DW_STAGE_VOXELS,
    K1ValuedPlainConvFn,
    dw_splits,
    dw_tiles,
    folded_conv3_dw_plain,
    folded_conv3_plain,
)
from dycon_paper_replication_tpu_torch.ops import resize as tresize
from dycon_paper_replication_tpu.ops import resize as jresize

torch.set_num_threads(1)
ATOL = 2e-4


def _both(a):
    return jnp.asarray(a), torch.from_numpy(np.ascontiguousarray(a))


def _close(j, t, atol=ATOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=atol, rtol=0)


def test_fold_unfold(rng):
    x = rng.normal(size=(2, 8, 12, 4, 3)).astype(np.float32)
    jx, tx = _both(x)
    np.testing.assert_array_equal(tfold.fold2(tx).numpy(), np.asarray(jfold.fold2(jx)))
    f = rng.normal(size=(2, 3, 4, 2, 24)).astype(np.float32)
    jf, tf = _both(f)
    np.testing.assert_array_equal(tfold.unfold2(tf).numpy(), np.asarray(jfold.unfold2(jf)))
    np.testing.assert_array_equal(tfold.unfold2(tfold.fold2(tx)).numpy(), x)


def test_fold_conv3_weights_and_bias(rng):
    w = rng.normal(size=(3, 3, 3, 3, 5)).astype(np.float32)
    jw, tw = _both(w)
    np.testing.assert_array_equal(tfold.fold_conv3_weights(tw).numpy(),
                                  np.asarray(jfold.fold_conv3_weights(jw)))
    b = rng.normal(size=(5,)).astype(np.float32)
    jb, tb = _both(b)
    np.testing.assert_array_equal(tfold.fold_bias(tb).numpy(), np.asarray(jfold.fold_bias(jb)))


@pytest.mark.parametrize("to_phase", [0, 1])
@pytest.mark.parametrize("c", [2, 4])
def test_folded_conv3_matches_jax_and_pallas(rng, to_phase, c):
    b, g = 2, 4
    x = rng.normal(size=(b, g, g + 1, g, 8 * c)).astype(np.float32)
    w = (rng.normal(size=(3, 3, 3, c, c)) * 0.1).astype(np.float32)
    bias = rng.normal(size=(c,)).astype(np.float32)
    jx, tx = _both(x)
    jw, tw = _both(w)
    jb, tb = _both(bias)
    got = tfold.folded_conv3(tx, tw, tb, to_phase=to_phase)
    _close(jfold.folded_conv3(jx, jw, jb, to_phase=to_phase), got)
    pallas = folded_conv3_pallas(jx, jfold.fold_conv3_weights(jw), to_phase=to_phase,
                                 interpret=True)
    _close(pallas + jfold.fold_bias(jb), got)


@pytest.mark.parametrize("grid", [(3, 4, 5), (5, 5, 2)])
def test_phase1_lane_masks(grid):
    for j, t in zip(jfold.phase1_lane_masks(grid, 3), tfold.phase1_lane_masks(grid, 3)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("phase1", [False, True])
def test_instance_norm_folded(rng, phase1):
    grid, c = (4, 5, 3), 3
    x = rng.normal(size=(2, *grid, 8 * c)).astype(np.float32) * 2 + 0.5
    jx, tx = _both(x)
    n_valid = 8 * (grid[0] - 1) * (grid[1] - 1) * (grid[2] - 1) if phase1 else 8 * np.prod(grid)
    jm = jfold.phase1_lane_masks(grid, c) if phase1 else None
    tm = tfold.phase1_lane_masks(grid, c) if phase1 else None
    _close(jfold.instance_norm_folded(jx, int(n_valid), masks=jm),
           tfold.instance_norm_folded(tx, int(n_valid), masks=tm), atol=1e-5)


def test_pools(rng):
    x = rng.normal(size=(2, 4, 6, 2, 16)).astype(np.float32)
    jx, tx = _both(x)
    np.testing.assert_array_equal(tfold.pool_consume_fold(tx).numpy(),
                                  np.asarray(jfold.pool_consume_fold(jx)))
    np.testing.assert_array_equal(tfold.pool_refold(tx).numpy(),
                                  np.asarray(jfold.pool_refold(jx)))


def test_upsample2x_folded(rng):
    x = rng.normal(size=(2, 3, 4, 2, 5)).astype(np.float32)
    jx, tx = _both(x)
    _close(jfold.upsample2x_folded(jx), tfold.upsample2x_folded(tx), atol=1e-6)
    # c-major lane order: the fold of the plain upsample
    _close(jfold.fold2(jresize.upsample2x(jx)), tfold.upsample2x_folded(tx), atol=1e-6)


def test_conv1x1_folded(rng):
    x = rng.normal(size=(2, 3, 2, 4, 8 * 4)).astype(np.float32)
    w = rng.normal(size=(1, 1, 1, 4, 2)).astype(np.float32)
    b = rng.normal(size=(2,)).astype(np.float32)
    (jx, tx), (jw, tw), (jb, tb) = _both(x), _both(w), _both(b)
    _close(jfold.conv1x1_folded(jx, jw, jb), tfold.conv1x1_folded(tx, tw, tb), atol=1e-5)


@pytest.mark.parametrize("align_corners", [False, True])
def test_resize(rng, align_corners):
    x = rng.normal(size=(2, 3, 4, 5, 2)).astype(np.float32)
    jx, tx = _both(x)
    _close(jresize.trilinear_resize(jx, (6, 8, 10), align_corners=align_corners),
           tresize.trilinear_resize(tx, (6, 8, 10), align_corners=align_corners), atol=1e-6)
    _close(jresize.upsample2x(jx), tresize.upsample2x(tx), atol=1e-6)
    np.testing.assert_array_equal(tresize.max_pool_2x(tx[:, :2, :4, :4]).numpy(),
                                  np.asarray(jresize.max_pool_2x(jx[:, :2, :4, :4])))


def _grad_case(rng, to_phase, ci, co, grid):
    x = rng.normal(size=(2, *grid, 8 * ci)).astype(np.float32)
    w = (rng.normal(size=(3, 3, 3, ci, co)) * 0.2).astype(np.float32)
    bias = rng.normal(size=(co,)).astype(np.float32)
    step = 1 if to_phase == 1 else -1
    cot = rng.normal(size=(2, *(g + step for g in grid), 8 * co)).astype(np.float32)
    return x, w, bias, cot


def _port_grads(x, w, bias, cot, to_phase, conv=None):
    tx, tw, tb = (torch.from_numpy(a).requires_grad_() for a in (x, w, bias))
    if conv is None:
        y = tfold.folded_conv3(tx, tw, tb, to_phase=to_phase)
    else:  # the same function with `conv` in place of FoldedConv3Fn
        y = conv(tx, tfold.fold_conv3_weights(tw), to_phase=to_phase) + tfold.fold_bias(tb)
    y.backward(torch.from_numpy(cot))
    return y.detach(), (tx.grad, tw.grad, tb.grad)


def _close_scaled(got, want, rel=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=rel * float(np.abs(want).max()))


@pytest.mark.parametrize("to_phase", [0, 1])
@pytest.mark.parametrize("ci,co,grid", [(2, 2, (5, 6, 7)), (1, 16, (6, 5, 5))])
def test_folded_conv3_fn_matches_jax_vjp(rng, to_phase, ci, co, grid):
    x, w, bias, cot = _grad_case(rng, to_phase, ci, co, grid)
    if ci == co:
        fn = lambda a, b_, c: folded_conv3_via_pallas(  # noqa: E731
            a, b_, c, to_phase=to_phase, interpret=True)
    else:
        fn = lambda a, b_, c: jfold.folded_conv3(a, b_, c, to_phase=to_phase)  # noqa: E731
    want_y, vjp = jax.vjp(fn, jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias))
    want = vjp(jnp.asarray(cot))
    y, got = _port_grads(x, w, bias, cot, to_phase)
    _close(want_y, y)
    for g, r in zip(got, want):
        _close_scaled(g, r)


@pytest.mark.parametrize("to_phase", [0, 1])
@pytest.mark.parametrize("lin,lout", [(16, 16), (8, 128)])
def test_folded_conv3_dw_plain_matches_jax_dwf(rng, to_phase, lin, lout):
    """Square lanes against `_dwf` itself (which reshapes to (.., L, L));
    8 -> 128 against jax.vjp of XLA's conv in the taps."""
    grid = (5, 7, 6)
    step = 1 if to_phase == 1 else -1
    x = rng.normal(size=(2, *grid, lin)).astype(np.float32)
    dy = rng.normal(size=(2, *(g + step for g in grid), lout)).astype(np.float32)
    if lin == lout:
        want = _dwf(jnp.asarray(x), jnp.asarray(dy), to_phase)
    else:
        conv = lambda wf: jax.lax.conv_general_dilated(  # noqa: E731
            jnp.asarray(x), wf, (1, 1, 1), [(1, 1) if to_phase else (0, 0)] * 3,
            dimension_numbers=("NDHWC", "DHWIO", "NDHWC"))
        want = jax.vjp(conv, jnp.zeros((2, 2, 2, lin, lout), jnp.float32))[1](
            jnp.asarray(dy))[0]
    got = folded_conv3_dw_plain(torch.from_numpy(x), torch.from_numpy(dy), to_phase=to_phase)
    _close_scaled(got, want)


@pytest.mark.parametrize("to_phase", [0, 1])
@pytest.mark.parametrize("ci,co,grid", [(2, 2, (5, 6, 7)), (1, 16, (6, 5, 5))])
def test_folded_conv3_fn_matches_plain_autograd(rng, to_phase, ci, co, grid):
    x, w, bias, cot = _grad_case(rng, to_phase, ci, co, grid)
    y, got = _port_grads(x, w, bias, cot, to_phase)
    y_plain, want = _port_grads(x, w, bias, cot, to_phase, conv=folded_conv3_plain)
    _close_scaled(y, y_plain.numpy())
    for g, r in zip(got, want):
        _close_scaled(g, r.numpy())


@pytest.mark.parametrize("to_phase", [0, 1])
def test_k1_valued_plain_conv_fn_is_plain_autograd(rng, to_phase):
    """The gradient checks' stand-in for FoldedConv3Fn: on the CPU, where K1's
    forward values are the plain ones, it is autograd of the plain conv,
    exactly."""
    x, w, bias, cot = _grad_case(rng, to_phase, 2, 16, (5, 4, 6))
    y, got = _port_grads(x, w, bias, cot, to_phase,
                         conv=lambda a, wf, to_phase: K1ValuedPlainConvFn.apply(a, wf, to_phase))
    y_plain, want = _port_grads(x, w, bias, cot, to_phase, conv=folded_conv3_plain)
    assert torch.equal(y, y_plain)
    for g, r in zip(got, want):
        assert torch.equal(g, r)


def test_folded_conv3_fn_skips_dx_when_not_needed(rng):
    x, w, bias, cot = _grad_case(rng, 1, 1, 16, (4, 4, 4))
    tw = torch.from_numpy(w).requires_grad_()
    tx = torch.from_numpy(x)
    y = FoldedConv3Fn.apply(tx, tfold.fold_conv3_weights(tw), 1)
    y.backward(torch.from_numpy(cot))
    assert tx.grad is None and tw.grad is not None


@pytest.mark.parametrize("n,tiles,sms", [(1_273_608, 1, 132), (168_200, 96, 132), (10, 4, 132),
                                         (7, 1, 1)])
def test_dw_splits_cover_the_voxels(n, tiles, sms):
    splits, chunk = dw_splits(n, tiles, sms)
    assert chunk % 8 == 0 and splits >= 1
    assert (splits - 1) * chunk < n <= splits * chunk


@pytest.mark.parametrize("grid,lin,lout,to_phase", [
    ((56, 56, 48), 8, 128, 1), ((57, 57, 49), 128, 128, 0), ((28, 28, 24), 128, 256, 1),
    ((29, 29, 25), 256, 256, 0), ((28, 28, 24), 768, 256, 1), ((56, 56, 48), 384, 128, 1)])
def test_dw_splits_fill_the_card_at_the_training_shapes(grid, lin, lout, to_phase):
    """At the Pancreas training shapes (B 8) on a 132-SM card: whole stages
    per split, and the last wave of blocks at least 95 % full."""
    n = 8 * int(np.prod([g + (1 if to_phase == 1 else -1) for g in grid]))
    tiles = dw_tiles(lin, lout)
    assert tiles == 8 * lin // (64 if lin == 8 else 128) * (lout // 128)
    splits, chunk = dw_splits(n, tiles, 132)
    assert chunk % DW_STAGE_VOXELS == 0 and (splits - 1) * chunk < n <= splits * chunk
    slots = DW_BLOCKS_PER_SM * 132
    blocks = splits * tiles
    assert blocks >= slots and blocks / (-(-blocks // slots) * slots) >= 0.95
