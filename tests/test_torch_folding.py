"""The port's fold-2 engine against the JAX package's, on the CPU in float32.

Each function of dycon_paper_replication_tpu_torch/ops/folding.py gets the
same numpy inputs as its JAX counterpart; the port's folded conv (on the
CPU, its plain F.conv3d version) is also held against the Pallas kernel
`folded_conv3_pallas` run in interpret mode, as the JAX package's own test
runs it. Tolerance: absolute 2e-4, as in tests/test_folded_conv_pallas.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dycon_paper_replication_tpu.ops import folding as jfold
from dycon_paper_replication_tpu.ops.folded_conv_pallas import folded_conv3_pallas
from dycon_paper_replication_tpu_torch.ops import folding as tfold
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
