"""The port's sliding-window engine and test driver against the JAX package's,
on the CPU in float32, at feature_scale 16 (filters 4..64).

The same JAX-initialised weights run in both engines, in the plain layout
and the folded one; an even volume takes the folded accumulator, a volume
with odd dims the plain one. Score maps must agree to SCORE_ATOL, label maps
exactly except at voxels whose score lies within SCORE_ATOL of the 0.5
threshold, and the test_all_case averages to 1e-6.

SCORE_ATOL is 2.5e-5: each package's float32 forward sits ~5e-5 from a
float64 forward on logits of magnitude ~13 at these weights, so the two can
differ by ~1e-4 in a logit, which the sigmoid (slope at most 1/4) turns into
at most 2.5e-5 of probability.
"""

import jax
import numpy as np
import pytest
import torch

from dycon_paper_replication_tpu.eval import evaluator as jeval
from dycon_paper_replication_tpu.eval.sliding_window import (
    SlidingWindowInference as JaxSW,
    compute_origins as jax_origins,
)
from dycon_paper_replication_tpu.models.factory import Model
from dycon_paper_replication_tpu.models.unet3d import UNet3DConfig as JaxConfig
from dycon_paper_replication_tpu.models.unet3d import init_unet3d, unet3d_apply
from dycon_paper_replication_tpu.models.unet3d_folded import unet3d_seg_folded_io
from dycon_paper_replication_tpu_torch import weights
from dycon_paper_replication_tpu_torch.data.synthetic import _ellipsoid_volume
from dycon_paper_replication_tpu_torch.eval import (
    SlidingWindowInference,
    compute_origins,
    test_all_case as port_test_all_case,
    var_all_case as port_var_all_case,
)
from dycon_paper_replication_tpu_torch.models import UNet3D, UNet3DConfig

torch.set_num_threads(1)
PATCH = (32, 32, 16)
STRIDES = (8, 8)
EVEN = (40, 36, 32)  # 12 origins, all even
ODD = (37, 34, 30)  # an odd origin on axis 0
SCORE_ATOL = 2.5e-5


def _jax_model(layout):
    cfg = JaxConfig(feature_scale=16, layout=layout)
    model = Model(cfg, init_unet3d, unet3d_apply)
    if layout == "folded":
        model.apply_seg_folded = lambda p, s, xf: unet3d_seg_folded_io(p, s, xf, cfg)
    return model


@pytest.fixture(scope="module")
def tree():
    params, state = jax.jit(init_unet3d, static_argnums=1)(
        jax.random.key(7), JaxConfig(feature_scale=16))
    return params, state


@pytest.fixture(scope="module")
def volumes():
    rng = np.random.default_rng(11)
    return [_ellipsoid_volume(rng, shape) for shape in (EVEN, ODD)]


def _port_engine(tree, layout, patch_batch=5):
    params, state = tree
    net = UNet3D(UNet3DConfig(feature_scale=16, layout=layout)).eval()
    net.load_state_dict(weights.jax_tree_to_state_dict(
        jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, state)))
    return SlidingWindowInference(net, PATCH, *STRIDES, patch_batch=patch_batch)


@pytest.mark.parametrize("shape", [(40, 36, 32), (37, 34, 30), (96, 80, 70), (20, 40, 8)])
def test_compute_origins(shape):
    np.testing.assert_array_equal(compute_origins(shape, PATCH, 16, 4),
                                  jax_origins(shape, PATCH, 16, 4))
    np.testing.assert_array_equal(compute_origins(shape, (96, 96, 96), 16, 4),
                                  jax_origins(shape, (96, 96, 96), 16, 4))


@pytest.mark.parametrize("layout,which", [("NDHWC", 0), ("folded", 0), ("folded", 1)])
def test_score_and_label_maps(tree, volumes, layout, which):
    image = volumes[which][0]
    params, state = tree
    jsw = JaxSW(_jax_model(layout), PATCH, *STRIDES, patch_batch=5)
    jlabel, jscore = jsw(params, state, image)
    sw = _port_engine(tree, layout)
    if layout == "folded":
        # the even volume takes the folded accumulator, the odd one the plain
        assert sw._folded(compute_origins(image.shape, PATCH, *STRIDES)) == (which == 0)
    label, score = sw(image)
    assert label.dtype == np.uint8 and label.shape == image.shape
    np.testing.assert_allclose(score, jscore, atol=SCORE_ATOL, rtol=0)
    settled = np.abs(jscore - 0.5) >= SCORE_ATOL
    np.testing.assert_array_equal(label[settled], jlabel[settled])


def test_test_all_case_averages(tree, volumes):
    params, state = tree
    jsw = JaxSW(_jax_model("folded"), PATCH, *STRIDES, patch_batch=5)
    want = jeval.test_all_case(jsw, params, state, iter(volumes), nms=True)
    got = port_test_all_case(_port_engine(tree, "folded"), iter(volumes), nms=True)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_var_all_case(tree, volumes):
    params, state = tree
    jsw = JaxSW(_jax_model("NDHWC"), PATCH, *STRIDES, patch_batch=5)
    want = jeval.var_all_case(jsw, params, state, iter(volumes))
    got = port_var_all_case(_port_engine(tree, "NDHWC"), iter(volumes))
    assert abs(got - want) <= 1e-6
