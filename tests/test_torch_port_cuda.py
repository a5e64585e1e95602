"""The port's CUDA kernels on the card: each against its plain version,
launch counting, operand checks, and a tiny analyze() on the card
against the CPU.

Marked `cuda`; every test skips where torch finds no CUDA device (the
check runs inside the fixture, never at import). On the card:
    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py
Tolerance on max |kernel − plain|, by the dtype the kernel returns:
1e-4 · max(1, max |plain|) for float32 (summation order only); two bf16
ulps at max |plain| for bfloat16 (the output's own rounding, plus one
stored intermediate that rounds the other way).
"""
import math

import numpy as np
import pytest
import torch

from circuitvision_tpu_torch.ops.cuda import build
from circuitvision_tpu_torch.ops.cuda import mlp_block as mb
from circuitvision_tpu_torch.ops.cuda import refinement as rf
from circuitvision_tpu_torch.ops.cuda import window_attn as wa

pytestmark = pytest.mark.cuda


@pytest.fixture()
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _rnd(gen, dt, *shape, scale=1.0):
    return (torch.randn(*shape, generator=gen, device="cuda") * scale).to(dt)


def _close(got, ref):
    """The tolerance follows the dtype the kernel returns (the refinement
    head returns float32 for any input dtype)."""
    out_dtype = got.dtype
    got, ref = got.float(), ref.float()
    assert torch.isfinite(got).all()
    ref_max = ref.abs().max().item()
    if out_dtype == torch.float32:
        tol = 1e-4 * max(1.0, ref_max)
    else:
        tol = 2.0 * 2.0 ** (math.floor(math.log2(max(ref_max, 2.0 ** -126))) - 7)
    assert (got - ref).abs().max().item() <= tol


DTYPES = [torch.float32, torch.bfloat16]


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("t,c", [(100, 96), (16, 768)])
def test_mlp_block_kernel(gen, dt, t, c):
    args = (_rnd(gen, dt, t, c), 1 + _rnd(gen, dt, c, scale=0.1), _rnd(gen, dt, c, scale=0.1),
            _rnd(gen, dt, 4 * c, c, scale=c ** -0.5), _rnd(gen, dt, 4 * c, scale=0.02),
            _rnd(gen, dt, c, 4 * c, scale=(4 * c) ** -0.5), _rnd(gen, dt, c, scale=0.02))
    before = mb.mlp_block.launches
    _close(mb.mlp_block(*args), mb.mlp_block_plain(*args))
    assert mb.mlp_block.launches == before + 1


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("t,c,heads", [(64, 96, 1), (16, 192, 2)])
def test_window_attn_kernel(gen, dt, t, c, heads):
    args = (_rnd(gen, dt, 8, t, c), 1 + _rnd(gen, dt, c, scale=0.1), _rnd(gen, dt, c, scale=0.1),
            _rnd(gen, dt, 3 * c, c, scale=c ** -0.5), _rnd(gen, dt, 3 * c, scale=0.02),
            _rnd(gen, dt, c, c, scale=c ** -0.5), _rnd(gen, dt, c, scale=0.02))
    _close(wa.window_attn_block(*args, heads=heads), wa.window_attn_block_plain(*args, heads=heads))


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("win,ci,co,heads", [(8, 96, 192, 2), (4, 192, 384, 4)])
def test_qpool_attn_kernel(gen, dt, win, ci, co, heads):
    args = (_rnd(gen, dt, 8 * win * win, ci), 1 + _rnd(gen, dt, ci, scale=0.1),
            _rnd(gen, dt, ci, scale=0.1), _rnd(gen, dt, co, ci, scale=ci ** -0.5),
            _rnd(gen, dt, co, scale=0.02), _rnd(gen, dt, 3 * co, ci, scale=ci ** -0.5),
            _rnd(gen, dt, 3 * co, scale=0.02), _rnd(gen, dt, co, co, scale=co ** -0.5),
            _rnd(gen, dt, co, scale=0.02))
    _close(wa.qpool_attn_block(*args, heads=heads, win=win),
           wa.qpool_attn_block_plain(*args, heads=heads, win=win))


@pytest.mark.parametrize("dt", DTYPES)
def test_refinement_kernel(gen, dt):
    args = (_rnd(gen, dt, 2, 70, 130, 1, scale=3.0),
            [_rnd(gen, dt, 4, 1, k, k, scale=1.0 / k) for k in rf.KERNELS],
            [_rnd(gen, dt, 4, scale=0.1) for _ in rf.KERNELS],
            _rnd(gen, dt, 1, 16, 1, 1, scale=0.25), _rnd(gen, dt, 1, scale=0.1))
    _close(rf.refinement(*args), rf.refinement_plain(*args))


def test_kernels_refuse_mixed_dtypes(gen):
    x = _rnd(gen, torch.float32, 16, 32)
    bad = [_rnd(gen, torch.bfloat16, 32)] * 2
    with pytest.raises(build.KernelError):
        mb.mlp_block(x, *bad, _rnd(gen, torch.float32, 128, 32), _rnd(gen, torch.float32, 128),
                     _rnd(gen, torch.float32, 32, 128), _rnd(gen, torch.float32, 32))


def test_tiny_analyze_on_card_matches_cpu(gen):
    from circuitvision_tpu_torch.core.config import DetectorConfig, PipelineConfig
    from circuitvision_tpu_torch.models.bridge import sam2_config, seeded_state
    from circuitvision_tpu_torch.pipeline.analyzer import CircuitAnalyzerTorch

    ymeta = {"detector": {"scale": "n", "img_size": 128, "num_classes": 64, "reg_max": 16}}
    smeta = {"sam2": {"preset": "t", "overrides": {"resolution": 128}}}
    cfg = PipelineConfig(detector=DetectorConfig(scale="n", img_size=128, num_classes=64,
                                                 dtype="float32"),
                         sam2=sam2_config(smeta, dtype="float32"))
    ys, ss = seeded_state("yolo", ymeta, 0), seeded_state("sam2", smeta, 1)
    img = np.full((150, 200, 3), 255, np.uint8)
    img[50:53, 10:190] = 0
    img[100:103, 10:190] = 0
    card = CircuitAnalyzerTorch(cfg, ys, ss, device="cuda").analyze(img)
    cpu = CircuitAnalyzerTorch(cfg, ys, ss, device="cpu").analyze(img)
    key = lambda r: [(b.class_name, b.xmin, b.ymin, b.xmax, b.ymax) for b in r.bboxes_orig_nms]  # noqa: E731
    assert key(card) == key(cpu)
    assert card.netlist_text == cpu.netlist_text
    assert np.mean(card.sam_mask == cpu.sam_mask) > 0.999
