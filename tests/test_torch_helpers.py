"""The port's helper functions against the JAX package's, on the CPU.

Each of these takes the same inputs, made from a numpy seed, on both sides:
  * losses (ops/losses.py): mse_consistency_loss, kl_consistency_loss,
    entropy_loss, entropy_map, focal_loss (with and without class weights,
    two gammas), symmetric_mse_loss; values, and the gradients of the
    inputs that take one (jax.grad against autograd: none to a consistency
    target, both ways for symmetric_mse_loss). Float32 on both sides,
    summed in different orders: values within rtol 1e-5 + atol 1e-7,
    gradients within rtol 1e-5 + 1e-6 x max|JAX gradient|;
  * ramps (ops/ramps.py): linear_rampup and cosine_rampdown, the same
    Python floats, exactly, and both refusing the same out-of-range
    arguments;
  * metrics (ops/metrics.py): batch_dice and batch_jaccard on hard masks
    (float, bool, int) and on soft maps, within rtol 1e-6 + atol 1e-7;
  * resize (ops/resize.py): pad_to_shape, exactly, including axes already
    at or above the target;
  * samplers (data/samplers.py): ThreeStreamBatchSampler, the same indices
    from the same seed for three epochs;
  * transforms (data/transforms.py): CenterCrop (with and without its pad),
    RandomNoise (the same generator draws), Resize and CreateOnehotLabel,
    then ToArray: equal arrays, exactly.
The cases follow tests/test_losses.py, test_metrics.py, test_resize.py and
test_data.py, which hold the JAX functions to their definitions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dycon_paper_replication_tpu.data import samplers as jsamplers
from dycon_paper_replication_tpu.data import transforms as jtransforms
from dycon_paper_replication_tpu.ops import losses as jlosses
from dycon_paper_replication_tpu.ops import metrics as jmetrics
from dycon_paper_replication_tpu.ops import ramps as jramps
from dycon_paper_replication_tpu.ops import resize as jresize
from dycon_paper_replication_tpu_torch.data import samplers as tsamplers
from dycon_paper_replication_tpu_torch.data import transforms as ttransforms
from dycon_paper_replication_tpu_torch.ops import losses as tlosses
from dycon_paper_replication_tpu_torch.ops import metrics as tmetrics
from dycon_paper_replication_tpu_torch.ops import ramps as tramps
from dycon_paper_replication_tpu_torch.ops import resize as tresize

torch.set_num_threads(1)
RTOL, ATOL = 1e-5, 1e-7
GRAD_RTOL, GRAD_ATOL_REL = 1e-5, 1e-6


def _probs(rng, shape):
    x = rng.normal(size=shape).astype(np.float32)
    e = np.exp(x - x.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


def _pair(rng, kind):
    """Two inputs of a two-argument loss, channels-last (B, D1, D2, D3, C)."""
    shape = (3, 5, 4, 6, 2)
    if kind == "probs":
        return _probs(rng, shape), _probs(rng, shape)
    return (rng.normal(size=shape).astype(np.float32),
            rng.normal(size=shape).astype(np.float32))


PAIR_LOSSES = {
    # name: (input kind, which arguments take a gradient)
    "mse_consistency_loss": ("probs", (0,)),
    "kl_consistency_loss": ("probs", (0,)),
    "symmetric_mse_loss": ("normal", (0, 1)),
}


@pytest.mark.parametrize("name", sorted(PAIR_LOSSES))
def test_pair_loss_matches_jax(rng, name):
    kind, grad_args = PAIR_LOSSES[name]
    a, b = _pair(rng, kind)
    jfn, tfn = getattr(jlosses, name), getattr(tlosses, name)
    want = float(jfn(jnp.asarray(a), jnp.asarray(b)))
    ta = torch.tensor(a, requires_grad=True)
    tb = torch.tensor(b, requires_grad=True)
    got = tfn(ta, tb)
    np.testing.assert_allclose(got.item(), want, rtol=RTOL, atol=ATOL)
    got.backward()
    want_grads = jax.grad(jfn, argnums=(0, 1))(jnp.asarray(a), jnp.asarray(b))
    for i, (t, w) in enumerate(zip((ta, tb), want_grads)):
        w = np.asarray(w)
        if i in grad_args:
            np.testing.assert_allclose(t.grad.numpy(), w, rtol=GRAD_RTOL,
                                       atol=GRAD_ATOL_REL * np.abs(w).max())
        else:  # a consistency target takes no gradient on either side
            assert not w.any() and (t.grad is None or not t.grad.any())


@pytest.mark.parametrize("num_classes", [2, 3])
def test_entropy_matches_jax(rng, num_classes):
    p = _probs(rng, (2, 5, 4, 3, num_classes))
    want_map = np.asarray(jlosses.entropy_map(jnp.asarray(p)))
    got_map = tlosses.entropy_map(torch.from_numpy(p)).numpy()
    assert got_map.shape == want_map.shape == p.shape[:-1]
    np.testing.assert_allclose(got_map, want_map, rtol=RTOL, atol=ATOL)
    want = float(jlosses.entropy_loss(jnp.asarray(p), num_classes))
    tp = torch.tensor(p, requires_grad=True)
    got = tlosses.entropy_loss(tp, num_classes)
    np.testing.assert_allclose(got.item(), want, rtol=RTOL, atol=ATOL)
    got.backward()
    w = np.asarray(jax.grad(jlosses.entropy_loss)(jnp.asarray(p), num_classes))
    np.testing.assert_allclose(tp.grad.numpy(), w, rtol=GRAD_RTOL,
                               atol=GRAD_ATOL_REL * np.abs(w).max())


@pytest.mark.parametrize("gamma,alpha", [(2.0, None), (0.5, None), (2.0, (0.25, 0.75)),
                                         (1.0, (0.2, 0.3, 0.5))])
def test_focal_loss_matches_jax(rng, gamma, alpha):
    c = 2 if alpha is None else len(alpha)
    logits = rng.normal(size=(3, 5, 5, 5, c)).astype(np.float32)
    labels = rng.integers(0, c, size=(3, 5, 5, 5))
    jalpha = None if alpha is None else jnp.asarray(alpha, jnp.float32)
    want = float(jlosses.focal_loss(jnp.asarray(logits), jnp.asarray(labels), gamma, jalpha))
    tl = torch.tensor(logits, requires_grad=True)
    talpha = None if alpha is None else torch.tensor(alpha, dtype=torch.float32)
    got = tlosses.focal_loss(tl, torch.from_numpy(labels), gamma, talpha)
    np.testing.assert_allclose(got.item(), want, rtol=RTOL, atol=ATOL)
    got.backward()
    w = np.asarray(jax.grad(lambda x: jlosses.focal_loss(x, jnp.asarray(labels), gamma,
                                                         jalpha))(jnp.asarray(logits)))
    np.testing.assert_allclose(tl.grad.numpy(), w, rtol=GRAD_RTOL,
                               atol=GRAD_ATOL_REL * np.abs(w).max())


@pytest.mark.parametrize("name,length", [("linear_rampup", 40.0), ("linear_rampup", 0.0),
                                         ("cosine_rampdown", 40.0), ("cosine_rampdown", 7.0)])
def test_ramp_matches_jax(name, length):
    jfn, tfn = getattr(jramps, name), getattr(tramps, name)
    points = np.linspace(0.0, length, 23).tolist() + [0.0, length]
    if name == "linear_rampup":
        points += [length + 1.0, 3 * length + 5.0]
    for t in points:
        assert tfn(t, length) == jfn(t, length), t
    for bad in ([-1.0, length], [length + 1.0, length] if name == "cosine_rampdown" else
                [1.0, -1.0]):
        with pytest.raises(AssertionError):
            jfn(*bad)
        with pytest.raises(ValueError):
            tfn(*bad)


@pytest.mark.parametrize("kind", ["float", "bool", "int", "soft"])
def test_batch_dice_jaccard_match_jax(rng, kind):
    shape = (3, 8, 8, 6)
    if kind == "soft":
        a = rng.uniform(size=shape).astype(np.float32)
        b = rng.uniform(size=shape).astype(np.float32)
    else:
        a, b = rng.uniform(size=shape) > 0.5, rng.uniform(size=shape) > 0.6
        a[1] = False  # an empty prediction
        a, b = {"float": (a.astype(np.float32), b.astype(np.float32)), "bool": (a, b),
                "int": (a.astype(np.int32), b.astype(np.int32))}[kind]
    for name in ("batch_dice", "batch_jaccard"):
        want = np.asarray(getattr(jmetrics, name)(jnp.asarray(a), jnp.asarray(b)))
        got = getattr(tmetrics, name)(torch.from_numpy(a), torch.from_numpy(b))
        assert got.dtype == torch.float32 and got.shape == (3,)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7, err_msg=name)


@pytest.mark.parametrize("shape,target", [((1, 5, 8, 3, 2), (8, 8, 8)),
                                          ((2, 7, 4, 9, 3), (10, 9, 9)),
                                          ((1, 6, 6, 6, 1), (4, 7, 5))])
def test_pad_to_shape_matches_jax(rng, shape, target):
    x = rng.normal(size=shape).astype(np.float32)
    want = np.asarray(jresize.pad_to_shape(jnp.asarray(x), target))
    got = tresize.pad_to_shape(torch.from_numpy(x), target).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("sizes,seed", [((3, 1, 1), 0), ((6, 2, 2), 5), ((4, 1, 2), 11)])
def test_three_stream_sampler_matches_jax(sizes, seed):
    batch, secondary, tertiary = sizes
    args = (range(0, 7), range(7, 12), range(12, 15), batch, secondary, tertiary)
    jax_sampler = jsamplers.ThreeStreamBatchSampler(*args, seed=seed)
    port = tsamplers.ThreeStreamBatchSampler(*args, seed=seed)
    assert len(port) == len(jax_sampler)
    for _ in range(3):
        assert list(port) == [[int(i) for i in b] for b in jax_sampler]
    with pytest.raises(AssertionError):
        jsamplers.ThreeStreamBatchSampler(range(2), range(2), range(2), 4, 1, 0)
    with pytest.raises(ValueError):
        tsamplers.ThreeStreamBatchSampler(range(2), range(2), range(2), 4, 1, 0)


def _volume(rng, shape, classes=2):
    return {"image": rng.normal(size=shape).astype(np.float32),
            "label": rng.integers(0, classes, size=shape).astype(np.uint8)}


TRANSFORMS = {
    "center_crop": (lambda m: m.CenterCrop((8, 8, 8)), (20, 18, 16), 2),
    "center_crop_padded": (lambda m: m.CenterCrop((12, 10, 8)), (10, 14, 7), 2),
    "random_noise": (lambda m: m.RandomNoise(mu=0.05, sigma=0.1), (9, 8, 7), 2),
    "resize": (lambda m: m.Resize((10, 10, 8)), (20, 18, 16), 2),
    "resize_up": (lambda m: m.Resize((13, 11, 9)), (7, 6, 5), 2),
    "onehot": (lambda m: m.CreateOnehotLabel(3), (6, 6, 4), 3),
}


@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_transform_matches_jax(name):
    make, shape, classes = TRANSFORMS[name]
    sample = _volume(np.random.default_rng(3), shape, classes)
    outs = []
    for module in (jtransforms, ttransforms):
        pipeline = module.Compose([make(module), module.ToArray()])
        rng = np.random.default_rng(17)
        outs.append((pipeline(dict(sample), rng), rng.random()))
    (want, want_next), (got, got_next) = outs
    assert got_next == want_next  # the same number of draws
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
