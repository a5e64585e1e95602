"""The port's FLOP count (models/flops.py, FlopCounterMode over the module
path) against the JAX package's (a jaxpr walk of dot_general and
conv_general_dilated): integer counts equal for single contractions, for
YOLO and SAM2 at a tiny config, and at the trained product's YOLOv11-s@640
and SAM2 Hiera-t@512 (their configs from ckpt/*/meta.json)."""
import json
from pathlib import Path

import flax.linen as nn
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F

from circuitvision_tpu.core.config import DetectorConfig as JDet
from circuitvision_tpu.core.config import SAM2Config as JSAM2Config
from circuitvision_tpu.core.config import sam2_hiera_preset as jpreset
from circuitvision_tpu.models import flops as jflops
from circuitvision_tpu_torch.core import config as tconfig
from circuitvision_tpu_torch.models import bridge
from circuitvision_tpu_torch.models import flops as tflops

ROOT = Path(__file__).resolve().parents[1]
TINY_SAM2 = dict(resolution=128, embed_dim=16, num_heads=1, stages=(1, 2, 3, 1),
                 global_att_blocks=(5,), window_spec=(4, 2, 6, 2),
                 backbone_channel_list=(128, 64, 32, 16), d_model=32, decoder_mlp_dim=64,
                 iou_head_hidden_dim=32, dtype="float32")
TINY_DET = dict(scale="n", img_size=128, num_classes=64)


@pytest.fixture(autouse=True)
def _no_flops_cache(monkeypatch):
    """The JAX count memoises under .jax_cache; count afresh here."""
    monkeypatch.setattr(jflops, "cached_flops", lambda key, compute: compute())


def _jax_conv(features, kernel, strides=1, groups=1, transpose=False):
    mod = (nn.ConvTranspose(features, kernel, strides=(strides,) * 2) if transpose
           else nn.Conv(features, kernel, strides=(strides,) * 2, padding="SAME",
                        feature_group_count=groups))
    return mod


@pytest.mark.parametrize("case", ["matmul", "einsum", "conv", "grouped", "strided",
                                  "transposed", "linear"])
def test_single_contractions_equal_jax(case):
    if case == "matmul":
        got = tflops.matmul_flops(torch.matmul, torch.zeros(64, 32), torch.zeros(32, 16))
        ref = jflops.matmul_flops(lambda a, b: a @ b, jnp.zeros((64, 32)), jnp.zeros((32, 16)))
    elif case == "einsum":
        got = tflops.matmul_flops(lambda a, b: torch.einsum("bmk,bkn->bmn", a, b),
                                  torch.zeros(3, 8, 5), torch.zeros(3, 5, 7))
        ref = jflops.matmul_flops(lambda a, b: jnp.einsum("bmk,bkn->bmn", a, b),
                                  jnp.zeros((3, 8, 5)), jnp.zeros((3, 5, 7)))
    elif case == "linear":
        got = tflops.matmul_flops(F.linear, torch.zeros(2, 9, 24), torch.zeros(40, 24),
                                  torch.zeros(40))
        dense = nn.Dense(40)
        v = dense.init(jax.random.PRNGKey(0), jnp.zeros((2, 9, 24)))
        ref = jflops.matmul_flops(dense.apply, v, jnp.zeros((2, 9, 24)))
    else:
        groups = 8 if case == "grouped" else 1
        stride = 2 if case in ("strided", "transposed") else 1
        transpose = case == "transposed"
        mod = _jax_conv(16, (3, 3) if not transpose else (2, 2), stride, groups, transpose)
        v = mod.init(jax.random.PRNGKey(0), jnp.zeros((1, 10, 10, 8)))
        ref = jflops.matmul_flops(mod.apply, v, jnp.zeros((1, 10, 10, 8)))
        x = torch.zeros(1, 8, 10, 10)
        if transpose:
            got = tflops.matmul_flops(lambda a, w: F.conv_transpose2d(a, w, stride=2), x,
                                      torch.zeros(8, 16, 2, 2))
        else:
            got = tflops.matmul_flops(
                lambda a, w: F.conv2d(a, w, stride=stride, padding=1, groups=groups), x,
                torch.zeros(16, 8 // groups, 3, 3))
    assert got == int(ref) and got > 0


def test_tiny_models_equal_jax():
    assert tflops.yolo_forward_flops(tconfig.DetectorConfig(**TINY_DET)) == \
        int(jflops.yolo_forward_flops(JDet(**TINY_DET)))
    assert tflops.sam2_forward_flops(tconfig.SAM2Config(**TINY_SAM2)) == \
        int(jflops.sam2_forward_flops(JSAM2Config(**TINY_SAM2)))
    # batch 2: the batch-independent dense prompt product counts once in both
    assert tflops.sam2_forward_flops(tconfig.SAM2Config(**TINY_SAM2), batch=2) == \
        int(jflops.sam2_forward_flops(JSAM2Config(**TINY_SAM2), batch=2))


def test_trained_product_equals_jax():
    """YOLOv11-s@640 + SAM2 Hiera-t@512, the shipped checkpoints' configs."""
    ymeta = json.loads((ROOT / "ckpt" / "yolo" / "meta.json").read_text())
    smeta = json.loads((ROOT / "ckpt" / "sam2" / "meta.json").read_text())
    det = bridge.detector_config(ymeta)
    assert (det.scale, det.img_size) == ("s", 640)
    assert tflops.yolo_forward_flops(det) == int(jflops.yolo_forward_flops(
        JDet(scale="s", img_size=640, num_classes=det.num_classes, reg_max=det.reg_max)))
    scfg = bridge.sam2_config(smeta)
    jcfg = jpreset(smeta["sam2"]["preset"], **smeta["sam2"].get("overrides", {}))
    assert (scfg.embed_dim, scfg.resolution) == (jcfg.embed_dim, jcfg.resolution) == (96, 512)
    assert tflops.sam2_forward_flops(scfg) == int(jflops.sam2_forward_flops(jcfg))


def test_device_peak_flops():
    """The H100's dense peaks by name; None off a CUDA device."""
    assert tflops.device_peak_flops("cpu") is None
    assert tflops.PEAK_FLOPS["NVIDIA H100 80GB HBM3"][torch.bfloat16] == 989e12
    assert tflops.PEAK_FLOPS["NVIDIA H100 80GB HBM3"][torch.float32] == 67e12
