"""The port's row-tiled FeCL against the JAX package's, on the CPU in float32.

`ops/dycon.py:fecl_loss_chunked` (autograd through checkpointed row tiles)
and `ops/fecl_fused.py:fecl_loss_fused` (the closed-form backward; on a CPU
tensor its plain twin, the counterpart of K2) against JAX
`fecl_loss_chunked` and `fecl_loss_fused`, value and feat-gradient, with and
without the teacher, focal and unfocal, with gambling weights, at N a
multiple of row_chunk and not (the padded rows). Inputs: L2-normalised rows
and a binary mask from numpy, with teacher rows close enough to the
student's that the cross term has pairs above its threshold.

Tolerances: the value within 1e-5 relative and the gradient within 1e-5 x
max|gradient| of JAX's; float32 sums in another order differ by ~1e-7
(measured: value 0 to 7e-8 relative, gradient 1e-7 to 2.4e-7 of its max).
The fused FeCL's result does not depend on row_chunk beyond float32 sums
(1e-6), and its teacher cotangent is exactly zero.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dycon_paper_replication_tpu.ops.dycon import fecl_loss_chunked as jax_chunked
from dycon_paper_replication_tpu.ops.fecl_fused import fecl_loss_fused as jax_fused
from dycon_paper_replication_tpu_torch.ops import dycon, fecl_fused

torch.set_num_threads(1)
D, B = 16, 2
CHUNK = 32


def _inputs(n, seed=0):
    rng = np.random.default_rng(seed)
    feat = rng.standard_normal((B, n, D)).astype(np.float32)
    feat /= np.linalg.norm(feat, axis=-1, keepdims=True)
    tfeat = feat + 0.5 * rng.standard_normal((B, n, D)).astype(np.float32)
    tfeat /= np.linalg.norm(tfeat, axis=-1, keepdims=True)
    mask = (rng.random((B, n)) < 0.3).astype(np.float32)
    gamb = rng.random((B, n)).astype(np.float32)
    return feat, mask, tfeat, gamb


CASES = [  # (teacher, focal, gambling weights)
    (True, True, False), (True, False, False), (False, True, False), (True, True, True),
    (False, False, True),
]
IMPLS = {"chunked": (jax_chunked, dycon.fecl_loss_chunked),
         "fused": (jax_fused, fecl_fused.fecl_loss_fused)}


@pytest.mark.parametrize("impl", list(IMPLS))
@pytest.mark.parametrize("n", [96, 100])
@pytest.mark.parametrize("teacher,focal,gambling", CASES)
def test_matches_jax(impl, n, teacher, focal, gambling):
    feat, mask, tfeat, gamb = _inputs(n, seed=n)
    kw = dict(temperature=0.6, gamma=2.0, use_focal=focal, pos_thresh=1.3, neg_thresh=0.3,
              row_chunk=CHUNK)
    jfn, tfn = IMPLS[impl]
    jt = jnp.asarray(tfeat) if teacher else None
    jg = jnp.asarray(gamb) if gambling else None
    want, want_grad = jax.value_and_grad(lambda f: jfn(f, jnp.asarray(mask), jt, jg, **kw))(
        jnp.asarray(feat))
    f = torch.tensor(feat, requires_grad=True)
    got = tfn(f, torch.tensor(mask), torch.tensor(tfeat) if teacher else None,
              torch.tensor(gamb) if gambling else None, **kw)
    got.backward()
    want_grad = np.asarray(want_grad)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(f.grad.numpy(), want_grad, rtol=0,
                               atol=1e-5 * np.abs(want_grad).max())


def test_cross_term_is_exercised():
    """The inputs put pairs above the cross threshold: the teacher moves the
    loss."""
    feat, mask, tfeat, _ = _inputs(100)
    args = (torch.tensor(feat), torch.tensor(mask))
    with_t = fecl_fused.fecl_loss_fused(*args, torch.tensor(tfeat), pos_thresh=1.3,
                                        neg_thresh=0.3, row_chunk=CHUNK)
    without = fecl_fused.fecl_loss_fused(*args, pos_thresh=1.3, neg_thresh=0.3, row_chunk=CHUNK)
    assert with_t.item() > without.item() + 0.1


def test_fused_matches_dense_and_does_not_depend_on_row_chunk():
    feat, mask, tfeat, _ = _inputs(100, seed=3)
    kw = dict(pos_thresh=1.3, neg_thresh=0.3)
    dense_f = torch.tensor(feat, requires_grad=True)
    dense = dycon.fecl_loss(dense_f, torch.tensor(mask), torch.tensor(tfeat), **kw)
    dense.backward()
    for chunk in (16, 32, 100, 128):
        f = torch.tensor(feat, requires_grad=True)
        got = fecl_fused.fecl_loss_fused(f, torch.tensor(mask), torch.tensor(tfeat),
                                         row_chunk=chunk, **kw)
        got.backward()
        np.testing.assert_allclose(got.item(), dense.item(), rtol=1e-6)
        np.testing.assert_allclose(f.grad.numpy(), dense_f.grad.numpy(), rtol=0,
                                   atol=1e-6 * dense_f.grad.abs().max().item())


def test_teacher_cotangent_is_zero():
    feat, mask, tfeat, _ = _inputs(96)
    f = torch.tensor(feat, requires_grad=True)
    t = torch.tensor(tfeat, requires_grad=True)
    fecl_fused.fecl_loss_fused(f, torch.tensor(mask), t, pos_thresh=1.3, neg_thresh=0.3,
                               row_chunk=CHUNK).backward()
    assert t.grad is not None and torch.count_nonzero(t.grad) == 0
    assert torch.count_nonzero(f.grad) > 0


def test_k2_wrappers_run_the_twin_on_cpu_and_refuse_to_launch_there():
    """A CPU tensor goes to the twin and counts no K2 call; asking K2 itself
    to launch without CUDA raises."""
    feat, mask, tfeat, _ = _inputs(96)
    feat, mask, tfeat = (torch.tensor(a) for a in (feat, mask, tfeat))
    o = fecl_fused.FeclOptions(0.6, 2.0, True, 1.3, 0.3, 1.0, CHUNK)
    fwd, bwd = fecl_fused.FeclForward(), fecl_fused.FeclBackward()
    res = fwd(feat, mask, tfeat, o)
    assert len(res) == 7 and all(r.shape == (B, 96) for r in res)
    dfeat = bwd(feat, mask, tfeat, res[0], res[1], res[4], torch.full((B, 96), 1e-3), 0.5, o)
    assert dfeat.shape == feat.shape and fwd.launches == 0 == bwd.launches
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fwd.launch(feat, mask, tfeat, o)


def test_nan_row_makes_the_loss_nan():
    feat, mask, tfeat, _ = _inputs(100)
    feat[1, 40, 3] = np.nan
    for fn in (fecl_fused.fecl_loss_fused, dycon.fecl_loss_chunked):
        loss = fn(torch.tensor(feat), torch.tensor(mask), torch.tensor(tfeat), pos_thresh=1.3,
                  neg_thresh=0.3, row_chunk=CHUNK)
        assert torch.isnan(loss), fn.__name__
