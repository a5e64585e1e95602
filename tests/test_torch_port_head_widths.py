"""SAM 2.1 Hiera blocks and trunks at head widths off the presets, in the
port against the JAX package (split from tests/test_torch_port_large.py,
whose subject is the L@1024 kernels and forward): trunks at head widths
the block kernels have no instance for, both dtypes, against the JAX
trunk; the card's padded route at width 60; the per-block kernel gate;
the analyzer's refusals by head width.

Tolerances are stated in each test.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from circuitvision_tpu.models.initialization import cast_float_params
from circuitvision_tpu.models.sam2 import hiera as jhiera
from circuitvision_tpu_torch.core import config as tconfig
from circuitvision_tpu_torch.models import bridge
from circuitvision_tpu_torch.models.layers import place
from circuitvision_tpu_torch.models.sam2 import hiera as thiera
from circuitvision_tpu_torch.ops.cuda import flash_attn as tflash
from circuitvision_tpu_torch.ops.cuda import window_attn as twin


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the module's tests, restored after: the
    suite runs six workers on eight cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _exact_matmuls():
    with jax.default_matmul_precision("highest"):
        yield


def _arr(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


# ------------------------------------- (e) head widths off the presets
#: a tiny Hiera with every path of t@512 (partitioned windows, q-pool
#: blocks, a global block on the module path), two heads a stage
def _tiny_hiera(hd, heads=2):
    return dict(embed_dim=heads * hd, num_heads=heads, stages=(1, 2, 3, 1),
                global_att_blocks=(4,), window_spec=(4, 2, 4, 2))


def _recording_paths(trunk):
    paths = []
    for i in range(trunk.depth):
        blk = getattr(trunk, f"blocks_{i}")
        blk.attention_path = (lambda x, w, p, _f=blk.attention_path:
                              paths.append(_f(x, w, p)) or paths[-1])
    return paths


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd,heads", [(32, 2), (64, 2), (60, 2), (60, 1), (136, 1)])
def test_hiera_at_off_preset_head_widths_matches_jax(hd, heads, dtype):
    """The port's Hiera at head widths the block kernels have no instance
    for, against the JAX trunk (its module path on the CPU) on the same
    variables and input, both in `dtype`. The blocks take the kernels'
    paths at every width (on the card in bf16: the tiled route and flash
    attention, at 60 with the heads padded to 64, at 136 on flash_attn's
    136 instance); here the kernels' plain versions run. With one head
    the first stage's width, 60, is off a multiple of 8 too (on the card
    those blocks run on rows padded to 64, `hiera.pad_block`). Tolerance:
    float32 1e-4 of max |jax| (summation order through seven blocks,
    ≈ 1e-6 measured); bfloat16 four bf16 ulps at max |jax| — the port
    rounds where the Pallas kernels do, the JAX module path where XLA
    does, and each block's output rounds once (≤ 2 ulps measured)."""
    got, ref, paths = _port_and_jax_trunks(hd, heads, dtype)
    kernels = ["window", "qpool", "window", "qpool", "module", "window", "qpool"]
    assert paths == kernels
    _assert_trunk_close(got, ref, dtype)


@functools.lru_cache(maxsize=None)
def _jax_variables(hd, heads):
    """The JAX trunk's variables at head width hd: a jitted init (bit-equal
    to the eager init's, in a fifth of its time), shared by both dtypes —
    the parameters are float32 whatever the compute dtype, and equal."""
    jm = jhiera.Hiera(**_tiny_hiera(hd, heads), dtype=jnp.float32)
    x = np.random.default_rng(3).standard_normal((1, 128, 128, 3)).astype(np.float32)
    return jax.tree.map(np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x)))


def _port_and_jax_trunks(hd, heads, dtype):
    """The port's and the JAX Hiera's outputs (float32 numpy) at head
    width hd on the same variables and input, both in `dtype`, and the
    attention paths the port's blocks took."""
    kw = _tiny_hiera(hd, heads)
    jdt = getattr(jnp, dtype)
    jm = jhiera.Hiera(**kw, dtype=jdt)
    x = np.random.default_rng(3).standard_normal((1, 128, 128, 3)).astype(np.float32)
    v = _jax_variables(hd, heads)
    ref = [np.asarray(a, np.float32)
           for a in jm.apply(cast_float_params(v, jdt) if dtype == "bfloat16" else v,
                             jnp.asarray(x))]
    tm = thiera.Hiera(**kw)
    tm.load_state_dict(bridge.state_dict_from_variables(v), strict=True)
    place(tm, "cpu", getattr(torch, dtype)).eval()
    paths = _recording_paths(tm)
    with torch.no_grad():
        got = [a.float().numpy() for a in tm(torch.from_numpy(x))]
    return got, ref, paths


def _assert_trunk_close(got, ref, dtype):
    for g, r in zip(got, ref):
        ref_max = float(np.abs(r).max())
        tol = 1e-4 * max(1.0, ref_max) if dtype == "float32" else \
            4.0 * 2.0 ** (np.floor(np.log2(ref_max)) - 7)
        assert g.shape == r.shape and np.abs(g - r).max() <= tol


def test_hiera_card_route_at_width_60_matches_jax_bf16(monkeypatch):
    """The card's route for a bf16 trunk of width 60 and one head, held
    against the JAX bf16 trunk: stage 1 and its transition (C = 60, off a
    multiple of 8) run in bf16 on rows zero-padded to 64 with each
    LayerNorm dividing by 60 (`pad_block`, forced here on the CPU tensors
    as the card takes it on CUDA ones; the plain versions stand in for
    the kernels), every later block unpadded. Held within the bf16 trunk
    tolerance of the test above, unchanged: four bf16 ulps at max |jax|
    (2.5 measured; the float32 detour this route replaced was held to the
    same)."""
    padded = []

    def card_gate(x, dim, dim_out):
        off = x.dtype == torch.bfloat16 and bool(dim % 8 or dim_out % 8)
        padded.append((dim, dim_out)) if off else None
        return off
    monkeypatch.setattr(thiera, "pad_block", card_gate)
    got, ref, _paths = _port_and_jax_trunks(60, 1, "bfloat16")
    assert padded == [(60, 60), (60, 120)]
    _assert_trunk_close(got, ref, "bfloat16")


@pytest.mark.parametrize("hd", [32, 64, 80, 128, 60, 136])
def test_hiera_head_width_gate(hd):
    """Which blocks of a Hiera-L@1024-shaped trunk (cut to one block a
    stage, head width hd in every stage) take a kernel path: the window
    and q-pool blocks at every width in both dtypes (a CUDA tensor at a
    width the kernels refuse raises in the wrapper), the global block up
    to MAX_HEAD_DIM, as before any width was routed. In bfloat16 the
    analyzer refuses, on the card, only a trunk whose heads, padded to a
    multiple of 8, are wider than flash_attn's widest instance (256);
    float32 refuses none."""
    for dtype in (torch.float32, torch.bfloat16):
        q = thiera.MultiScaleBlock(2 * hd, 4 * hd, 4, q_stride=True)
        g = thiera.MultiScaleBlock(8 * hd, 8 * hd, 8, q_stride=False)
        w = thiera.MultiScaleBlock(2 * hd, 2 * hd, 2, q_stride=False)
        x_q = torch.zeros(1, 16, 16, 2 * hd, dtype=dtype)
        x_g = torch.zeros(1, 64, 64, 8 * hd, dtype=dtype)
        x_w = torch.zeros(16, 8, 8, 2 * hd, dtype=dtype)
        assert q.attention_path(x_q, 8, False) == "qpool"
        assert g.attention_path(x_g, 0, False) == \
            ("global" if hd <= tflash.MAX_HEAD_DIM else "module")
        assert w.attention_path(x_w, 0, True) == "window"
    assert thiera.refused_head_width(2 * hd, 2) is None
    assert twin.padded_head_width(hd, torch.bfloat16) == -(-hd // 8) * 8
    assert twin.padded_head_width(hd, torch.float32) == hd


@pytest.mark.parametrize("dim,dim_out,q_stride", [(60, 60, False), (60, 120, True)])
def test_blocks_off_8_bytes_wide_run_float32_kernels(monkeypatch, dim, dim_out, q_stride):
    """A bf16 block whose width is off a multiple of 8 (embed 60, one
    head: stage 1 and its transition) no longer detours through float32
    on the card: it runs the bf16 kernels on rows zero-padded to 64
    (`pad_block`), forced here on the CPU. Its output is the unpadded
    bf16 block's within two bf16 ulps at max |ref| (the padded heads'
    zero columns change only the order of the products' sums); the padded
    parameters are zero past the true widths, padded once and again only
    after one is written; the gate itself is by dtype, device and
    width."""
    rng = np.random.default_rng(9)
    blk = thiera.MultiScaleBlock(dim, dim_out, dim_out // 60, q_stride=q_stride)
    with torch.no_grad():
        for p_ in blk.parameters():
            p_.copy_(torch.from_numpy(_arr(rng, *p_.shape, scale=0.1)))
    x = torch.from_numpy(_arr(rng, 2, 8, 8, dim)).to(torch.bfloat16)
    place(blk, "cpu", torch.bfloat16)
    with torch.no_grad():
        want = blk(x, 8, False)
        monkeypatch.setattr(thiera, "pad_block", lambda x, d, do: x.dtype == torch.bfloat16)
        got = blk(x, 8, False)
        pads = blk.padded_params()
        assert blk(x, 8, False).equal(got) and blk.padded_params() is pads  # padded once
        for name, t in pads.items():
            assert t.shape[-1] % 8 == 0 or name.startswith("attn.")
            own = blk.get_parameter(name)
            cut = t[tuple(slice(0, n) for n in own.shape)]
            assert cut.equal(own.float() if name.startswith("norm") else own)
            assert t.abs().sum().item() == cut.abs().sum().item()  # zero past the true widths
        blk.mlp_layers_1.bias.add_(1.0)  # a written parameter is padded again
        assert blk.padded_params() is not pads
        assert blk.padded_params()["mlp_layers_1.bias"][:dim_out].equal(blk.mlp_layers_1.bias)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    ulp = 2.0 ** (np.floor(np.log2(want.float().abs().max().item())) - 7)
    assert (got.float() - want.float()).abs().max().item() <= 2 * ulp
    monkeypatch.undo()
    assert not thiera.pad_block(x, dim, dim_out)  # a CPU tensor: the plain versions
    assert not thiera.pad_block(x.float(), dim, dim_out)


@pytest.mark.parametrize("hd,heads", [(60, 2), (136, 1), (60, 1)])
def test_analyzer_refuses_bf16_head_widths_on_the_card(monkeypatch, hd, heads):
    """These bf16 head widths were refused on the card until the tiled
    route padded heads to a multiple of 8 and flash_attn gained a 136
    instance; now the analyzer builds its SAM2 (the card is only
    pretended here: the models are placed on the CPU)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    from circuitvision_tpu_torch.pipeline import analyzer as tanalyzer

    sam2 = dataclasses.replace(tconfig.SAM2Config(), embed_dim=heads * hd, num_heads=heads,
                               dtype="bfloat16", resolution=64, stages=(1, 1, 1, 1),
                               global_att_blocks=(2,),
                               backbone_channel_list=tuple(heads * hd * 2 ** i
                                                           for i in (3, 2, 1, 0)))
    cfg = dataclasses.replace(tconfig.PipelineConfig(), sam2=sam2,
                              detector=tconfig.DetectorConfig(scale="n", num_classes=64))
    assert thiera.refused_head_width(heads * hd, heads) is None
    ys = tanalyzer.YOLOv11(64, "n").state_dict()
    ss = tanalyzer.SAM2ImageSegmenter(sam2).state_dict()
    monkeypatch.setattr(tanalyzer, "place", lambda m, device, dtype: m)
    a = tanalyzer.CircuitAnalyzerTorch(cfg, ys, ss, device="cuda")
    assert a.sam2 is not None


@pytest.mark.parametrize("hd,heads", [(264, 1), (132, 1)])
def test_analyzer_refuses_bf16_heads_wider_than_the_kernels(monkeypatch, hd, heads):
    """Heads wider than flash_attn's widest bf16 instance (256) are
    refused before any model is built, naming the width. A trunk of width
    132, off a multiple of 8, was refused too while such blocks ran the
    float32 kernels (heads up to 128); it now runs the bf16 kernels on
    rows padded to 136 (`hiera.pad_block`), its heads on flash_attn's 136
    instance, and is not refused."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    from circuitvision_tpu_torch.pipeline.analyzer import CircuitAnalyzerTorch
    from circuitvision_tpu_torch.ops.cuda.build import KernelError

    sam2 = dataclasses.replace(tconfig.SAM2Config(), embed_dim=heads * hd, num_heads=heads,
                               dtype="bfloat16")
    cfg = dataclasses.replace(tconfig.PipelineConfig(), sam2=sam2)
    if hd > tflash.TC_WIDTHS[-1]:
        assert thiera.refused_head_width(heads * hd, heads) == hd
        with pytest.raises(KernelError, match=f"is {hd}$"):
            CircuitAnalyzerTorch(cfg, {}, {}, device="cuda")
    else:
        assert thiera.refused_head_width(heads * hd, heads) is None
        # past the refusal the analyzer loads the (here empty) weights
        with pytest.raises(RuntimeError, match="Missing key"):
            CircuitAnalyzerTorch(cfg, {}, {}, device="cuda")
