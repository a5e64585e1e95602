"""The port's image, NMS, morphology and labelling ops against the JAX
package's, on the same numpy inputs.

Tolerances: float outputs of resizes agree to 1e-4 absolute on 0..255
data (float32, weight matrices built by the same formula, contracted in
another order); integer and boolean outputs (rounded resizes, masks,
labels, keep masks) must be identical. The one exception is the rounded
grey level of enhance_lines: XLA fuses the blur's multiply-adds, so a
value on a .5 boundary may round one level apart; what the node stage
consumes — the binarized raster — must be identical.
"""
import glob
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from circuitvision_tpu.ops import cc as jcc
from circuitvision_tpu.ops import image as jimage
from circuitvision_tpu.ops import morphology as jmorph
from circuitvision_tpu.ops import nms as jnms
from circuitvision_tpu.topology import nodes as jnodes
from circuitvision_tpu_torch.ops import cc as tcc
from circuitvision_tpu_torch.ops import image as timage
from circuitvision_tpu_torch.ops import morphology as tmorph
from circuitvision_tpu_torch.ops import nms as tnms
from circuitvision_tpu_torch.topology import nodes as tnodes

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMAGES = sorted(glob.glob(os.path.join(ROOT, "eval_data", "images", "*.png")))


@pytest.fixture(autouse=True)
def _exact_matmuls():
    with jax.default_matmul_precision("highest"):
        yield


def _rgb(path):
    return cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)


@pytest.mark.parametrize("shape,out,antialias", [
    ((37, 53), (64, 80), True),      # upscale
    ((120, 90), (47, 33), True),     # antialiased downscale
    ((120, 90), (47, 33), False),    # plain 2-tap downscale
    ((64, 64, 3), (512, 512), True),
    ((300, 200, 3), (128, 128), True),
])
def test_resize_matches_jax_image_resize(shape, out, antialias):
    x = np.random.default_rng(0).random(shape).astype(np.float32) * 255
    ref = np.asarray(jimage.resize_bilinear(jnp.asarray(x), out, antialias=antialias))
    got = timage.resize_bilinear(torch.from_numpy(x), out, antialias=antialias).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)


@pytest.mark.parametrize("hw", [(1, 512, 512), (1, 97, 131)])
def test_resize_linear_logits_both_directions(hw):
    """The SAM2 logit resize back to the crop (analyzer.py:209-211),
    no antialias, up and down."""
    x = np.random.default_rng(1).standard_normal((1, 256, 256)).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(x), hw, method="linear", antialias=False))
    got = timage.resize_linear(torch.from_numpy(x), hw, antialias=False).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("path", IMAGES[:3])
def test_cv2_resize_u8_identical(path):
    mask = (cv2.imread(path, cv2.IMREAD_GRAYSCALE) < 128).astype(np.float32) * 255
    new_h, new_w = 600, int(600 * mask.shape[1] / mask.shape[0])
    ref = np.asarray(jnodes._cv2_resize_u8(jnp.asarray(mask), (new_h, new_w)))
    got = tnodes._cv2_resize_u8(torch.from_numpy(mask), (new_h, new_w)).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("path", IMAGES[:2])
def test_letterbox_and_sam2_preprocess(path):
    img = _rgb(path)
    ref_c, ref_s, ref_p = jimage.letterbox(jnp.asarray(img), 640)
    got_c, got_s, got_p = timage.letterbox(torch.from_numpy(img), 640)
    np.testing.assert_allclose(got_c.numpy(), np.asarray(ref_c), rtol=0, atol=1e-3)
    assert np.float32(got_s) == np.asarray(ref_s)
    assert tuple(np.float32(got_p)) == tuple(np.asarray(ref_p))
    ref = np.asarray(jimage.sam2_preprocess(jnp.asarray(img), 128))
    got = timage.sam2_preprocess(torch.from_numpy(img), 128).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("path", IMAGES[:3])
def test_gray_and_adaptive_threshold_identical(path):
    img = _rgb(path)
    ref_g = np.asarray(jimage.rgb_to_gray(jnp.asarray(img)))
    got_g = timage.rgb_to_gray(torch.from_numpy(img)).numpy()
    np.testing.assert_array_equal(got_g, ref_g)
    ref = np.asarray(jimage.adaptive_threshold_mean_inv(jnp.asarray(ref_g), 31, 21.0))
    got = timage.adaptive_threshold_mean_inv(torch.from_numpy(got_g), 31, 21.0).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("seed", [0, 1])
def test_enhance_lines_and_boundary_identical(seed):
    rng = np.random.default_rng(seed)
    mask = np.round(rng.random((97, 130)) * 1.2).clip(0, 1).astype(np.float32) * 255
    ref = np.round(np.asarray(jmorph.enhance_lines(jnp.asarray(mask))))
    got = torch.round(tmorph.enhance_lines(torch.from_numpy(mask))).numpy()
    np.testing.assert_array_equal(got > 0, ref > 0)
    assert np.abs(got - ref).max() <= 1
    assert np.mean(got != ref) < 1e-3
    fg = got > 0
    np.testing.assert_array_equal(
        tmorph.boundary_mask(torch.from_numpy(fg)).numpy(),
        np.asarray(jmorph.boundary_mask(jnp.asarray(fg))),
    )


def test_gaussian_taps_identical():
    ref = np.asarray(jmorph.gaussian_kernel_1d(5, 1.0))
    np.testing.assert_array_equal(np.asarray(tmorph.gaussian_kernel_1d(5, 1.0), np.float32), ref)


@pytest.mark.parametrize("path", IMAGES[:2])
def test_label_components_identical(path):
    fg = cv2.imread(path, cv2.IMREAD_GRAYSCALE) < 128
    ref = np.asarray(jcc.label_components(jnp.asarray(fg), max_iters=256))
    np.testing.assert_array_equal(tcc.label_image(fg), ref)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_greedy_nms_keep_identical(seed):
    rng = np.random.default_rng(seed)
    n = 64
    xy = rng.random((n, 2)).astype(np.float32) * 200
    wh = rng.random((n, 2)).astype(np.float32) * 60 + 5
    boxes = np.concatenate([xy, xy + wh], 1)
    scores = np.round(rng.random(n), 2).astype(np.float32)  # rounded: ties occur
    valid = rng.random(n) > 0.2
    ref = np.asarray(jnms.greedy_nms(jnp.asarray(boxes), jnp.asarray(scores),
                                     jnp.asarray(valid), iou_threshold=0.5))
    got = tnms.greedy_nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                          torch.from_numpy(valid), iou_threshold=0.5).numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(
        tnms.iou_matrix(torch.from_numpy(boxes), torch.from_numpy(boxes)).numpy(),
        np.asarray(jnms.iou_matrix(jnp.asarray(boxes), jnp.asarray(boxes))),
    )
