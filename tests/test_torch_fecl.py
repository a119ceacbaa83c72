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

At the canonical sizes, with the same tolerances (stated before their
first run): the dense `fecl_loss` against JAX's at the Pancreas step's
N = 14 x 14 x 12 = 2352, D = 256, B = 2, and `fecl_loss_chunked` and the
fused FeCL's twin against JAX's `fecl_loss_chunked` at the ISLES step's
N = 12 x 12 x 8 x 8 = 9216 (patch 96x96x64 at projection scale 4), D = 256,
B = 1, row_chunk 512 (the ISLES fecl_chunk). Their rows are clustered as
trained embeddings are: two class prototypes at cosine 0.5 plus noise of
the prototype's norm, so that rows of one class lie near cosine 0.5 and of
two classes near 0.25, about the cross threshold 0.3, which puts hard
negatives in the cross term; the teacher's rows are the student's plus a
little noise. The dense test shares JAX's side of the cross threshold
(its doc says why).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dycon_paper_replication_tpu.ops.dycon import fecl_loss_chunked as jax_chunked
from dycon_paper_replication_tpu.ops.fecl_fused import fecl_loss_fused as jax_fused
from dycon_paper_replication_tpu_torch.ops import dycon, fecl_fused
from dycon_paper_replication_tpu_torch.train.device_check import KINK_MARGIN

torch.set_num_threads(1)
D, B = 16, 2
CHUNK = 32
FECL_D = 256  # the projection head's output width
CANONICAL_KW = dict(temperature=0.6, gamma=2.0, use_focal=True, pos_thresh=1.3, neg_thresh=0.3)


def _inputs(n, seed=0):
    rng = np.random.default_rng(seed)
    feat = rng.standard_normal((B, n, D)).astype(np.float32)
    feat /= np.linalg.norm(feat, axis=-1, keepdims=True)
    tfeat = feat + 0.5 * rng.standard_normal((B, n, D)).astype(np.float32)
    tfeat /= np.linalg.norm(tfeat, axis=-1, keepdims=True)
    mask = (rng.random((B, n)) < 0.3).astype(np.float32)
    gamb = rng.random((B, n)).astype(np.float32)
    return feat, mask, tfeat, gamb


def _clustered_inputs(b, n, seed):
    """(feat, mask, tfeat) of `b` x `n` rows of D = FECL_D (module doc)."""
    rng = np.random.default_rng(seed)
    p0 = rng.standard_normal(FECL_D)
    p0 /= np.linalg.norm(p0)
    q = rng.standard_normal(FECL_D)
    q -= (q @ p0) * p0
    protos = np.stack([p0, 0.5 * p0 + np.sqrt(0.75) * q / np.linalg.norm(q)])
    mask = (rng.random((b, n)) < 0.2).astype(np.float32)
    noise = rng.standard_normal((b, n, FECL_D)) / np.sqrt(FECL_D)
    feat = protos[mask.astype(int)] + noise
    feat /= np.linalg.norm(feat, axis=-1, keepdims=True)
    tfeat = feat + 0.3 * rng.standard_normal((b, n, FECL_D)) / np.sqrt(FECL_D)
    tfeat /= np.linalg.norm(tfeat, axis=-1, keepdims=True)
    return feat.astype(np.float32), mask, tfeat.astype(np.float32)


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


def _hold(got, f, want, want_grad):
    want_grad = np.asarray(want_grad)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(f.grad.numpy(), want_grad, rtol=0,
                               atol=1e-5 * np.abs(want_grad).max())


def _cross_pairs(feat, mask, tfeat):
    """The negatives (pairs of two classes) whose student-teacher cosine
    passes the cross threshold."""
    cs = np.einsum("bnd,bmd->bnm", feat, tfeat)
    return int(((cs > CANONICAL_KW["neg_thresh"]) & (mask[:, :, None] != mask[:, None, :])).sum())


def test_dense_matches_jax_at_the_pancreas_size(monkeypatch):
    """The port's dense FeCL takes JAX's side of the cross threshold at the
    pairs within train/device_check.py's margin of it (its `cross_side`
    hook, as in the step checks). Without that the first run failed: pair
    (0, 540, 894) lies within 1e-6 of neg_thresh, JAX's float32 cosine puts
    it on the other side from a float64 one, and the gradient rows 540 and
    1657 of JAX's differ from float64 by 8.8e-4 x max|gradient|, while the
    port's float32 gradient is within 2.3e-7 x max of float64."""
    from dycon_paper_replication_tpu.ops.dycon import fecl_loss as jax_dense

    feat, mask, tfeat = _clustered_inputs(2, 2352, seed=11)
    assert _cross_pairs(feat, mask, tfeat) > 0
    want, want_grad = jax.value_and_grad(
        lambda f: jax_dense(f, jnp.asarray(mask), jnp.asarray(tfeat), **CANONICAL_KW))(
        jnp.asarray(feat))
    # JAX's float32 cosines, as its fecl_loss computes them
    jax_cs = jax.jit(lambda f, t: jnp.einsum("bnd,bmd->bnm", f, t,
                                             preferred_element_type=jnp.float32))(feat, tfeat)
    jax_side = torch.from_numpy(np.asarray(jax_cs > np.float32(CANONICAL_KW["neg_thresh"])))
    taken = []

    def cross_side(rows, cs, neg_t, own):
        gap = cs.detach() - neg_t
        near = gap.abs() <= KINK_MARGIN * gap.abs().max()
        side = torch.where(near, jax_side[:, rows], own)
        taken.append(int((side != own).sum()))
        return side

    monkeypatch.setattr(fecl_fused, "cross_side", cross_side)
    f = torch.tensor(feat, requires_grad=True)
    got = dycon.fecl_loss(f, torch.tensor(mask), torch.tensor(tfeat), **CANONICAL_KW)
    got.backward()
    print(f"cross-threshold sides taken from JAX: {taken}")
    _hold(got, f, want, want_grad)


@pytest.fixture(scope="module")
def isles_size():
    """The ISLES-size inputs and JAX's chunked value and feat-gradient."""
    feat, mask, tfeat = _clustered_inputs(1, 9216, seed=12)
    want, want_grad = jax.value_and_grad(
        lambda f: jax_chunked(f, jnp.asarray(mask), jnp.asarray(tfeat), row_chunk=512,
                              **CANONICAL_KW))(jnp.asarray(feat))
    return feat, mask, tfeat, want, want_grad


@pytest.mark.parametrize("impl", list(IMPLS))
def test_row_tiled_matches_jax_at_the_isles_size(isles_size, impl):
    feat, mask, tfeat, want, want_grad = isles_size
    f = torch.tensor(feat, requires_grad=True)
    got = IMPLS[impl][1](f, torch.tensor(mask), torch.tensor(tfeat), row_chunk=512,
                         **CANONICAL_KW)
    got.backward()
    _hold(got, f, want, want_grad)
