"""The plain versions of the port's last three kernels — the fused line
enhancement and the two trunk LayerNorms — against the JAX package's
Pallas kernels in interpret mode, on the same seeded numpy inputs; the
port's TrunkLayerNorm(fused=True) against the JAX module; and the
fused-morphology switch of topology stage A.

Tolerances: the line enhancement's plain version repeats the Pallas
kernel's taps, summation order and rounding; it is held to Queue C item
4's slack (one grey level on under 0.1 % of pixels, the binarised raster
identical), since XLA may fuse a multiply-add of the interpret-mode blur
(one pixel in ten thousand on the noise rasters; none on the line
raster). On the card, kernel and plain version agree bit for bit
(tests/test_torch_port_cuda.py, chip_smoke.py). The LayerNorms, on
max |port − jax|: float32 within 2e-6 × max |jax| (f32 statistics summed
in another order), bfloat16 within one bf16 ulp at max |jax| (the output
rounds to bf16 once), and the residual sum bit-equal.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from circuitvision_tpu.models.sam2.hiera import TrunkLayerNorm as JTrunkLayerNorm
from circuitvision_tpu.ops.morphology import gaussian_kernel_1d as jgaussian
from circuitvision_tpu.ops.pallas.fused_ln import fused_add_layernorm as pallas_add_ln
from circuitvision_tpu.ops.pallas.fused_ln import fused_layernorm as pallas_ln
from circuitvision_tpu.ops.pallas.fused_morphology import enhance_lines_fused as pallas_enhance
from circuitvision_tpu_torch.core.config import TopologyConfig
from circuitvision_tpu_torch.models.sam2.hiera import TrunkLayerNorm
from circuitvision_tpu_torch.ops.cuda import fused_ln as tln
from circuitvision_tpu_torch.ops.cuda import morphology as tmorph
from circuitvision_tpu_torch.ops.morphology import enhance_lines, gaussian_kernel_1d
from circuitvision_tpu_torch.topology import nodes as tnodes


def _line_raster(seed: int, h: int, w: int) -> np.ndarray:
    """0/255 strokes drawn at 1.25× and brought to (h, w) by the port's
    cv2-exact uint8 resize, so stroke edges carry grey levels."""
    rng = np.random.default_rng(seed)
    big = np.zeros((h * 5 // 4, w * 5 // 4), np.float32)
    for _ in range(24):
        t = int(rng.integers(2, 6))
        if rng.random() < 0.5:
            y, x0, x1 = rng.integers(0, big.shape[0] - t), *sorted(rng.integers(0, big.shape[1], 2))
            big[y:y + t, x0:x1] = 255
        else:
            x, y0, y1 = rng.integers(0, big.shape[1] - t), *sorted(rng.integers(0, big.shape[0], 2))
            big[y0:y1, x:x + t] = 255
    return tnodes._cv2_resize_u8(torch.from_numpy(big), (h, w)).numpy()


@pytest.mark.parametrize("h,w,tile_h,kind", [(300, 400, 64, "noise"), (97, 130, 32, "noise"),
                                             (600, 803, 152, "lines")])
def test_enhance_lines_fused_plain_equals_pallas(h, w, tile_h, kind):
    if kind == "lines":
        mask = _line_raster(0, h, w)
    else:
        rng = np.random.default_rng(h)
        mask = np.round(rng.random((h, w)) * 1.2).clip(0, 1).astype(np.float32) * 255
    ref = np.asarray(pallas_enhance(jnp.asarray(mask), tile_h=tile_h, interpret=True))
    got = tmorph.enhance_lines_fused_plain(torch.from_numpy(mask)).numpy()
    # Queue C item 4's slack: XLA may fuse a multiply-add of the
    # interpret-mode blur, so a sum on a .5 boundary may round one grey
    # level away; the binarised raster is identical
    np.testing.assert_array_equal(got > 0, ref > 0)
    assert np.abs(got - ref).max() <= 1
    assert np.mean(got != ref) < 1e-3
    # the CPU wrapper takes the plain version and launches nothing
    before = tmorph.enhance_lines_fused.launches
    np.testing.assert_array_equal(tmorph.enhance_lines_fused(torch.from_numpy(mask)).numpy(), got)
    assert tmorph.enhance_lines_fused.launches == before


def test_fused_taps_are_the_pallas_kernels_not_the_references():
    """The Pallas kernel builds its taps in float64 and rounds them
    (fused_morphology.py:131-135); ops/morphology.py builds them in
    float32. Four of the five differ by one float32 ulp."""
    xs = np.arange(5, dtype=np.float64) - 2.0
    k = np.exp(-(xs**2) / 2.0)
    pallas_bits = (k / k.sum()).astype(np.float32).view(np.uint32)
    port_bits = np.asarray(tmorph.TAPS, np.float32).view(np.uint32)
    ref_bits = np.asarray(gaussian_kernel_1d(5, 1.0), np.float32).view(np.uint32)
    np.testing.assert_array_equal(port_bits, pallas_bits)
    np.testing.assert_array_equal(port_bits, [1029648263, 1048186859, 1053697076, 1048186859,
                                              1029648263])
    np.testing.assert_array_equal(ref_bits, np.asarray(jgaussian(5, 1.0), np.float32).view(np.uint32))
    assert (np.abs(port_bits.astype(np.int64) - ref_bits.astype(np.int64)) == 1).sum() == 4


def test_fused_enhancement_binarises_as_the_reference():
    """On a line raster the fused chain and round(enhance_lines) agree on
    the binarised raster the node stage reads (the taps' last-bit
    difference moves at most a grey level)."""
    mask = torch.from_numpy(_line_raster(1, 600, 803))
    fused = tmorph.enhance_lines_fused_plain(mask)
    ref = torch.round(enhance_lines(mask))
    assert torch.equal(fused > 0, ref > 0)
    assert (fused - ref).abs().max() <= 1


def test_switch_gates_as_jax_on_the_cpu():
    """With use_fused_morphology on, a CPU raster still takes the reference
    enhance_lines, as the JAX gate never runs the kernel on the CPU
    backend."""
    resized = torch.from_numpy(_line_raster(2, 120, 150))
    off = tnodes.enhance_chain(resized, TopologyConfig())
    before = tmorph.enhance_lines_fused.launches
    on = tnodes.enhance_chain(resized, TopologyConfig(use_fused_morphology=True))
    assert torch.equal(on, off) and tmorph.enhance_lines_fused.launches == before
    assert not tnodes._fused_morphology(TopologyConfig(use_fused_morphology=True), resized)


def _bf16_ulp(x: float) -> float:
    return 2.0 ** (math.floor(math.log2(max(x, 2.0 ** -126))) - 7)


def _close(got: torch.Tensor, ref, dtype):
    got, ref = got.float().numpy(), np.asarray(ref, np.float32)
    ref_max = float(np.abs(ref).max())
    tol = 2e-6 * ref_max if dtype == torch.float32 else _bf16_ulp(ref_max)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= tol, (np.abs(got - ref).max(), tol)


def _ln_inputs(dtype, t=101, c=144):
    """Row count 101: not a multiple of the Pallas row tile (the kernel
    pads to 104). Values are of `dtype`; scale and bias float32."""
    rng = np.random.default_rng(7)
    a = torch.from_numpy(rng.standard_normal((t, c)).astype(np.float32) * 2 + 0.5).to(dtype)
    b = torch.from_numpy(rng.standard_normal((t, c)).astype(np.float32)).to(dtype)
    s = torch.from_numpy(1 + 0.1 * rng.standard_normal(c).astype(np.float32))
    bias = torch.from_numpy(0.1 * rng.standard_normal(c).astype(np.float32))
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    j = lambda t_: jnp.asarray(t_.float().numpy(), jdt)  # noqa: E731
    return (a, b, s, bias), (j(a), j(b), jnp.asarray(s.numpy()), jnp.asarray(bias.numpy()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_layernorm_plain_equals_pallas(dtype):
    (a, _b, s, bias), (ja, _jb, js, jbias) = _ln_inputs(dtype)
    ref = pallas_ln(ja, js, jbias, interpret=True)
    got = tln.fused_layernorm_plain(a, s, bias)
    assert got.dtype == dtype
    _close(got, ref, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_add_layernorm_plain_equals_pallas(dtype):
    (a, b, s, bias), (ja, jb, js, jbias) = _ln_inputs(dtype)
    ref_resid, ref = pallas_add_ln(ja, jb, js, jbias, interpret=True)
    resid, got = tln.fused_add_layernorm_plain(a, b, s, bias)
    np.testing.assert_array_equal(resid.float().numpy(), np.asarray(ref_resid, np.float32))
    _close(got, ref, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_trunk_layernorm_fused_equals_jax_module(dtype):
    """TrunkLayerNorm(fused=True) on the CPU runs the module math; with and
    without residual= it meets the JAX module with the same float32
    parameters (the JAX module fuses only on a TPU)."""
    (a, b, s, bias), (ja, jb, js, jbias) = _ln_inputs(dtype, t=37, c=96)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jm = JTrunkLayerNorm(dtype=jdt, fused=True)
    variables = {"params": {"scale": js, "bias": jbias}}
    tm = TrunkLayerNorm(96, fused=True)
    with torch.no_grad():
        tm.weight.copy_(s)
        tm.bias.copy_(bias)
        _close(tm(a), jm.apply(variables, ja), dtype)
        resid, y = tm(a, residual=b)
    jr, jy = jm.apply(variables, ja, residual=jb)
    np.testing.assert_array_equal(resid.float().numpy(), np.asarray(jr, np.float32))
    _close(y, jy, dtype)


def test_layernorm_wrappers_take_the_plain_version_on_the_cpu():
    (a, b, s, bias), _ = _ln_inputs(torch.float32)
    before = (tln.fused_layernorm.launches, tln.fused_add_layernorm.launches)
    assert torch.equal(tln.fused_layernorm(a, s, bias), tln.fused_layernorm_plain(a, s, bias))
    r1, y1 = tln.fused_add_layernorm(a, b, s, bias)
    r2, y2 = tln.fused_add_layernorm_plain(a, b, s, bias)
    assert torch.equal(r1, r2) and torch.equal(y1, y2)
    assert (tln.fused_layernorm.launches, tln.fused_add_layernorm.launches) == before
