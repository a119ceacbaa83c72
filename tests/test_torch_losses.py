"""The port's losses, ramps and mask pooling against the JAX package's, on
the CPU in float32.

The same numpy inputs go through each JAX function and its counterpart in
dycon_paper_replication_tpu_torch; values and gradients (jax.grad against
torch autograd) must agree to rtol 1e-5, with an absolute floor of 1e-5 x
the largest magnitude for elements near zero. The ramps are host float
arithmetic and must agree exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dycon_paper_replication_tpu.ops import dycon as jdycon
from dycon_paper_replication_tpu.ops import losses as jlosses
from dycon_paper_replication_tpu.ops import ramps as jramps
from dycon_paper_replication_tpu.ops.resize import avg_pool_nonoverlap as javg_pool
from dycon_paper_replication_tpu_torch.ops import dycon as tdycon
from dycon_paper_replication_tpu_torch.ops import losses as tlosses
from dycon_paper_replication_tpu_torch.ops import ramps as tramps
from dycon_paper_replication_tpu_torch.ops.resize import avg_pool_nonoverlap as tavg_pool

torch.set_num_threads(1)
RTOL = 1e-5


def _close(got, want):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * float(np.abs(want).max()))


def _check_value_and_grad(jfn, tfn, arrays, argnums=(0,)):
    """jfn(*jax arrays) and tfn(*torch tensors) -> scalars; values and the
    gradients in `argnums` must agree."""
    jargs = [jnp.asarray(a) for a in arrays]
    targs = [torch.tensor(a) for a in arrays]
    for i in argnums:
        targs[i].requires_grad_()
    want, want_grads = jax.value_and_grad(jfn, argnums=argnums)(*jargs)
    got = tfn(*targs)
    got.backward()
    _close(got, want)
    for i, wg in zip(argnums, want_grads):
        # no gradient (a detached target) is JAX's zero gradient
        g = targs[i].grad
        _close(torch.zeros_like(targs[i]) if g is None else g, wg)


def _logits(rng, shape=(2, 4, 6, 4, 2), scale=2.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _labels(rng, shape=(2, 4, 6, 4), n=2):
    return rng.integers(0, n, size=shape).astype(np.int32)


def test_cross_entropy(rng):
    _check_value_and_grad(jlosses.cross_entropy_loss, tlosses.cross_entropy_loss,
                          [_logits(rng, (2, 4, 6, 4, 3)), _labels(rng, n=3)])


def test_dice_loss(rng):
    score = rng.random((2, 4, 6, 4)).astype(np.float32)
    target = _labels(rng)
    _check_value_and_grad(lambda s, t: jlosses.dice_loss(s, t == 1),
                          lambda s, t: tlosses.dice_loss(s, t == 1), [score, target])


def test_dice_loss_nclass(rng):
    probs = np.asarray(jax.nn.softmax(_logits(rng, (2, 4, 6, 4, 3)), axis=-1))
    _check_value_and_grad(lambda p, l: jlosses.dice_loss_nclass(p, l, 3),
                          lambda p, l: tlosses.dice_loss_nclass(p, l, 3),
                          [probs, _labels(rng, n=3)])


@pytest.mark.parametrize("kind", ["mse", "kl"])
def test_softmax_consistency(rng, kind):
    """Both orders of softmax: on logits, and on probabilities (the step's
    double softmax)."""
    a, b = _logits(rng), _logits(rng)
    if kind == "mse":
        jfn = lambda x, y: jnp.mean(jlosses.softmax_mse_loss(x, y))  # noqa: E731
        tfn = lambda x, y: tlosses.softmax_mse_loss(x, y).mean()  # noqa: E731
    else:
        jfn, tfn = jlosses.softmax_kl_loss, tlosses.softmax_kl_loss
    _check_value_and_grad(jfn, tfn, [a, b], argnums=(0, 1))
    pa, pb = (np.asarray(jax.nn.softmax(v, axis=-1)) for v in (a, b))
    _check_value_and_grad(jfn, tfn, [pa, pb], argnums=(0, 1))


@pytest.mark.parametrize("beta", [0.5, 5.0])
def test_uncl_loss(rng, beta):
    _check_value_and_grad(lambda s, t: jdycon.uncl_loss(s, t, beta),
                          lambda s, t: tdycon.uncl_loss(s, t, beta),
                          [_logits(rng), _logits(rng)], argnums=(0, 1))


def _embeddings(rng, b=2, n=24, d=8):
    f = rng.normal(size=(b, n, d)).astype(np.float32)
    return f / np.linalg.norm(f, axis=-1, keepdims=True)


def _fecl_case(rng, case):
    feat = _embeddings(rng)
    mask = rng.integers(0, 2, size=feat.shape[:2]).astype(np.float32)
    teacher = _embeddings(rng)
    if case == "no_positive_row":
        # sample 1: one location of class 1, so its row has no positive
        mask[1] = 0.0
        mask[1, 5] = 1.0
    elif case == "clamp":
        # a pair of different classes with identical embeddings and the
        # teacher a hair longer: their cosine similarity is ~1.0001 > 1
        feat[:, 1] = feat[:, 0]
        mask[:, 0], mask[:, 1] = 0.0, 1.0
        teacher = feat * np.float32(1.0001)
    return feat, mask, teacher


@pytest.mark.parametrize("use_focal", [True, False])
@pytest.mark.parametrize("with_teacher", [True, False])
@pytest.mark.parametrize("case", ["random", "no_positive_row", "clamp"])
def test_fecl_loss(rng, use_focal, with_teacher, case):
    feat, mask, teacher = _fecl_case(rng, case)
    kw = dict(temperature=0.6, gamma=2.0, use_focal=use_focal, pos_thresh=1.4, neg_thresh=0.35)

    def jfn(f, m, t):
        return jdycon.fecl_loss(f, m, t if with_teacher else None, **kw)

    def tfn(f, m, t):
        return tdycon.fecl_loss(f, m, t if with_teacher else None, **kw)

    _check_value_and_grad(jfn, tfn, [feat, mask, teacher])
    if case == "clamp" and with_teacher:
        # the clamped term -log(0 + 1e-18) = 41.4 dominates the cross mean
        assert float(tfn(*(torch.from_numpy(a) for a in (feat, mask, teacher)))) > 1.0


def test_fecl_loss_gambling_weights(rng):
    feat, mask, _ = _fecl_case(rng, "random")
    gamb = rng.random(mask.shape).astype(np.float32)
    _check_value_and_grad(lambda f, m, g: jdycon.fecl_loss(f, m, None, g),
                          lambda f, m, g: tdycon.fecl_loss(f, m, None, g), [feat, mask, gamb])


def test_gambling_softmax(rng):
    x = _logits(rng, (2, 5, 3))
    _close(tdycon.gambling_softmax(torch.from_numpy(x)), jdycon.gambling_softmax(jnp.asarray(x)))


def test_avg_pool_nonoverlap(rng):
    x = rng.random((2, 17, 16, 10)).astype(np.float32)
    _close(tavg_pool(torch.from_numpy(x), (4, 4, 2)), javg_pool(jnp.asarray(x), (4, 4, 2)))


@pytest.mark.parametrize("t", [0, 1, 37.5, 200, 1500, 3000])
def test_ramps(t):
    assert tramps.sigmoid_rampup(t, 200.0) == jramps.sigmoid_rampup(t, 200.0)
    assert tramps.sigmoid_rampup(t, 0) == jramps.sigmoid_rampup(t, 0)
    assert tramps.adaptive_beta(t, 1500, 5.0, 0.5) == jramps.adaptive_beta(t, 1500, 5.0, 0.5)
    for lo, hi in ((1.3, 1.5), (0.3, 0.5)):
        assert (tramps.threshold_rampup(t, 1500.0, lo, hi)
                == jramps.threshold_rampup(t, 1500.0, lo, hi))
    assert tramps.threshold_rampup(t, 0, 0.3, 0.5) == jramps.threshold_rampup(t, 0, 0.3, 0.5)
    step = int(t) % 3000
    assert tramps.poly_lr(0.01, step, 3000) == jramps.poly_lr(0.01, step, 3000)
