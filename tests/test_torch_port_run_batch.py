"""The port's `BatchedPipeline.run_batch` against the JAX package's, on the
CPU at a tiny configuration (YOLOv11-n@128 and a Hiera at resolution 128
from seeded weights), with and without SAM2.

JAX runs float32 under `jax.default_matmul_precision("highest")` on a
one-device CPU mesh. Classes and the valid mask must be identical, the
boxes (letterbox pixels) and scores agree to float32 rounding of the
two packages' op orders (`BOX_ATOL`, `SCORE_ATOL`); the scales and pads
are identical. SAM2's thresholded masks must be identical on every pixel
whose logit (the port's) lies farther than `MASK_BAND` from the
threshold; the tiny model's logits differ between the packages by far
less than that.
"""
import glob
from pathlib import Path

import cv2
import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from circuitvision_tpu.core.config import DetectorConfig as JDet
from circuitvision_tpu.core.config import PipelineConfig as JPipe
from circuitvision_tpu.core.config import SAM2Config as JSAM2Config
from circuitvision_tpu.models.sam2.wrapper import SAM2ImageSegmenter as JSAM2
from circuitvision_tpu.models.sam2.wrapper import init_params as jsam2_init
from circuitvision_tpu.models.yolo.model import YOLOv11 as JYOLO
from circuitvision_tpu.models.yolo.model import init_params as jyolo_init
from circuitvision_tpu.pipeline import batch as jbatch
from circuitvision_tpu.pipeline.analyzer import CircuitAnalyzerTPU
from circuitvision_tpu_torch.core import config as tconfig
from circuitvision_tpu_torch.models import bridge
from circuitvision_tpu_torch.ops.image import sam2_preprocess
from circuitvision_tpu_torch.pipeline import batch as tbatch
from circuitvision_tpu_torch.pipeline.analyzer import CircuitAnalyzerTorch

ROOT = Path(__file__).resolve().parents[1]
IMAGES = sorted(glob.glob(str(ROOT / "eval_data" / "images" / "*.png")))
TINY_SAM2 = dict(resolution=128, embed_dim=16, num_heads=1, stages=(1, 2, 3, 1),
                 global_att_blocks=(5,), window_spec=(4, 2, 6, 2),
                 backbone_channel_list=(128, 64, 32, 16), d_model=32, decoder_mlp_dim=64,
                 iou_head_hidden_dim=32, dtype="float32")
TINY_DET = dict(scale="n", img_size=128, num_classes=64, dtype="float32",
                conf_threshold=0.02)
BATCH = 4
BOX_ATOL = 1e-3  # letterbox pixels, on boxes of up to 128
SCORE_ATOL = 1e-5
MASK_BAND = 1e-3  # logits this close to the threshold may round either way


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with jax.default_matmul_precision("highest"):
        yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    jcfg = JPipe(detector=JDet(**TINY_DET), sam2=JSAM2Config(**TINY_SAM2))
    yv = jax.tree.map(np.asarray, jyolo_init(JYOLO(num_classes=64, scale="n"),
                                             jax.random.PRNGKey(0), img_size=128))
    sv = jax.tree.map(np.asarray, jsam2_init(JSAM2(cfg=jcfg.sam2), jax.random.PRNGKey(1)))
    return jcfg, yv, sv


@pytest.fixture(scope="module")
def images():
    # three of BATCH rows: the last row is computed from zero inputs
    return [cv2.cvtColor(cv2.imread(IMAGES[i]), cv2.COLOR_BGR2RGB) for i in (0, 20, 40)]


def _pair(weights, use_sam2):
    jcfg, yv, sv = weights
    ja = CircuitAnalyzerTPU(config=jcfg, yolo_variables=yv,
                            sam2_variables=sv if use_sam2 else None, use_sam2=use_sam2,
                            vlm_client=None)
    tcfg = tconfig.PipelineConfig(detector=tconfig.DetectorConfig(**TINY_DET),
                                  sam2=tconfig.SAM2Config(**TINY_SAM2))
    ta = CircuitAnalyzerTorch(tcfg, bridge.state_dict_from_variables(yv),
                              bridge.state_dict_from_variables(sv) if use_sam2 else None,
                              device="cpu")
    mesh = Mesh(np.asarray(jax.devices("cpu")[:1]).reshape(1, 1), ("data", "model"))
    return (jbatch.BatchedPipeline(ja, mesh=mesh, batch_size=BATCH),
            tbatch.BatchedPipeline(ta, batch_size=BATCH))


def _check_detections(got, ref):
    assert got.boxes.shape == ref.boxes.shape == (BATCH, 128, 4)
    for f in ("boxes", "scores", "classes", "valid", "scales", "pads", "masks"):
        assert getattr(got, f).dtype == np.asarray(getattr(ref, f)).dtype, f
        assert getattr(got, f).shape == np.asarray(getattr(ref, f)).shape, f
    np.testing.assert_array_equal(got.valid, ref.valid)
    np.testing.assert_array_equal(got.classes, ref.classes)
    np.testing.assert_allclose(got.boxes, ref.boxes, rtol=0, atol=BOX_ATOL)
    np.testing.assert_allclose(got.scores, ref.scores, rtol=0, atol=SCORE_ATOL)
    np.testing.assert_array_equal(got.scales, ref.scales)
    np.testing.assert_array_equal(got.pads, ref.pads)
    assert ref.valid[:3].any()


def test_run_batch_matches_jax_with_sam2(weights, images):
    jp, tp = _pair(weights, use_sam2=True)
    ref, got = jp.run_batch(images), tp.run_batch(images)
    _check_detections(got, ref)
    seg = torch.zeros((BATCH, 128, 128, 3))
    for i, img in enumerate(images):
        seg[i] = sam2_preprocess(torch.from_numpy(img), 128)
    with torch.no_grad():
        logits = tp.analyzer.sam2(seg)[0][..., 0].numpy()
    thr = tp.cfg.sam2.mask_threshold
    far = np.abs(logits - thr) > MASK_BAND
    assert far.mean() > 0.99
    np.testing.assert_array_equal(got.masks[far], ref.masks[far])
    assert set(np.unique(got.masks)) <= {0, 1} and got.masks[:3].any()


def test_run_batch_matches_jax_without_sam2(weights, images):
    jp, tp = _pair(weights, use_sam2=False)
    ref, got = jp.run_batch(images[:2]), tp.run_batch(images[:2])
    _check_detections(got, ref)
    assert not got.masks.any() and not ref.masks.any()
    assert got.masks.shape == (BATCH, 128, 128)


def test_run_batch_refuses_more_than_batch_size(weights, images):
    _jp, tp = _pair(weights, use_sam2=False)
    with pytest.raises(ValueError, match="at most 4"):
        tp.run_batch(images + images)
