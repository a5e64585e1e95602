"""FlashAttention — attention with a gradient, the port's counterpart of
jax's TPU flash attention with its custom VJP — on the CPU, where its
forward and backward take their plain versions (flash_attn_lse_plain,
flash_attn_bwd_plain): against `jax.vjp` of jax's `mha_reference`
(flash_attention.py:1530, the reference its TPU kernels are tested
against), against jax's TPU kernels themselves (forward and both
backward kernels, run in Pallas's TPU interpret mode) in bfloat16 and
float32, in float64 against finite differences, and inside a whole
Hiera block on the module path with FLASH_MIN_SEQ lowered, against the
JAX block's module path.

Tolerance: max |port − jax| ≤ 1e-4 · max(1, max |jax|) per output, in
float32, JAX under jax.default_matmul_precision("highest"); bfloat16 as
the test against jax's kernels says.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from jax.experimental.pallas.ops.tpu.flash_attention import (
    BlockSizes, flash_attention, mha_reference,
)

from circuitvision_tpu.models.sam2 import hiera as jhiera
from circuitvision_tpu_torch.models.sam2 import hiera as thiera
from circuitvision_tpu_torch.ops.cuda import flash_attn as fa

RTOL = 1e-4


@pytest.fixture(autouse=True)
def _exact_matmuls():
    with jax.default_matmul_precision("highest"):
        yield


def _close(got, ref, rtol=RTOL):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= rtol * max(1.0, np.abs(ref).max())


@pytest.mark.parametrize("b,h,nq,nk,d,scale_width", [
    (1, 8, 256, 256, 72, None),   # SAM2.1-L's global heads, fewer tokens
    (2, 2, 100, 70, 72, 60),      # Nq ≠ Nk, a true width below the head's
    (1, 3, 17, 130, 16, None),
])
def test_flash_attention_matches_jax_vjp_of_mha_reference(b, h, nq, nk, d, scale_width):
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal((b, h, n, d)).astype(np.float32) for n in (nq, nk, nk))
    do = rng.standard_normal((b, h, nq, d)).astype(np.float32)
    scale = (scale_width or d) ** -0.5

    def ref(q, k, v):
        # mha_reference's own VJP takes sm_scale 1 only: scale q through jax
        return mha_reference(q * scale, k, v, None)

    o_ref, vjp = jax.vjp(ref, *map(jnp.asarray, (q, k, v)))
    grads_ref = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    o = fa.flash_attention(tq, tk, tv, scale_width)
    grads = torch.autograd.grad(o, (tq, tk, tv), torch.from_numpy(do))
    _close(o.detach(), o_ref)
    for got, want in zip(grads, grads_ref):
        _close(got, want)
    # the residual: each row's log-sum-exp of the scaled scores
    _, lse = fa.flash_attn_lse(tq.detach(), tk.detach(), tv.detach(), scale_width)
    s = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64), k.astype(np.float64)) * scale
    m = s.max(-1)
    _close(lse, m + np.log(np.exp(s - m[..., None]).sum(-1)))


#: jax's TPU kernels at 128-row blocks everywhere: two q and two key
#: blocks at N = 256, so each kernel carries its sums across grid steps
_BLOCKS_128 = BlockSizes(block_q=128, block_k_major=128, block_k=128, block_b=1,
                         block_q_major_dkv=128, block_k_major_dkv=128, block_k_dkv=128,
                         block_q_dkv=128, block_k_major_dq=128, block_k_dq=128, block_q_dq=128)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("d", [72, 96])
def test_flash_attention_matches_jax_tpu_kernels(dtype, d):
    """FlashAttention on the CPU (its plain versions) against jax's TPU
    flash_attention — its forward and its _flash_attention_bwd_dq and
    _bwd_dkv kernels through its custom VJP — run in Pallas's TPU
    interpret mode, at 1 × 2 × 256 × d (SAM2.1-L's and Hiera-t/s's global
    head widths), softmax scale d^-0.5, the same inputs in the same dtype.

    bfloat16: o, dq, dk and dv within two bf16 ulps at max |jax| each. The
    plain backward rounds P and dS to bf16 where jax's kernels do
    (flash_attention.py :900, :918, :1251-1258), and keeps the scores, dP
    and the sums in float32, as they do; what is left is the order of the
    float32 sums, jax's P normalised as exp(s − m)/l against the port's
    exp(s − lse), and each output's own rounding — one ulp, and a second
    for a value near a rounding boundary. Measured at this seed: half an
    ulp at max |jax| for o, dq and dk, a quarter or less for dv (both
    widths), about 4 s a case. float32: the 1e-4 · max(1, max |jax|)
    bound of the other tests here (measured ≤ 4.8e-7)."""
    rng = np.random.default_rng(4)
    q, k, v, do = (rng.standard_normal((1, 2, 256, d)).astype(np.float32) for _ in range(4))
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)

    def tpu_flash(q, k, v):
        return flash_attention(q, k, v, sm_scale=d ** -0.5, block_sizes=_BLOCKS_128)

    with pltpu.force_tpu_interpret_mode():
        o_ref, vjp = jax.vjp(tpu_flash, *(jnp.asarray(a, jdt) for a in (q, k, v)))
        refs = [o_ref, *vjp(jnp.asarray(do, jdt))]
    refs = [np.asarray(r.astype(jnp.float32)) for r in refs]
    tq, tk, tv = (torch.from_numpy(a).to(tdt).requires_grad_() for a in (q, k, v))
    o = fa.flash_attention(tq, tk, tv)
    grads = torch.autograd.grad(o, (tq, tk, tv), torch.from_numpy(do).to(tdt))
    for got, want in zip((o.detach(), *grads), refs):
        assert got.dtype == tdt
        if dtype == "float32":
            _close(got, want)
            continue
        ulp = 2.0 ** (math.floor(math.log2(np.abs(want).max())) - 7)
        assert np.abs(got.float().numpy() - want).max() <= 2 * ulp


def test_flash_attention_gradcheck_float64():
    """The plain path in float64 against finite differences."""
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 2, n, 8, generator=gen, dtype=torch.float64, requires_grad=True)
               for n in (9, 13, 13))
    assert torch.autograd.gradcheck(lambda q, k, v: fa.flash_attention(q, k, v, 6), (q, k, v))


def test_flash_attn_bwd_kernel_wrappers_take_the_plain_version_on_cpu():
    """The dq and dkv wrappers, given CPU tensors, return what the plain
    backward returns, delta = rowsum(do∘o) among them."""
    gen = torch.Generator().manual_seed(1)
    q, k, v, do = (torch.randn(2, 2, n, 24, generator=gen) for n in (33, 65, 65, 33))
    o, lse = fa.flash_attn_lse(q, k, v)
    dq_ref, dk_ref, dv_ref = fa.flash_attn_bwd_plain(q, k, v, o, lse, do)
    dq, delta = fa.flash_attn_bwd_dq(q, k, v, o, lse, do)
    dk, dv = fa.flash_attn_bwd_dkv(q, k, v, lse, delta, do)
    torch.testing.assert_close(delta, (do * o).sum(-1), rtol=0, atol=0)
    for got, ref in ((dq, dq_ref), (dk, dk_ref), (dv, dv_ref)):
        _close(got, ref, 1e-6)


@pytest.mark.parametrize("q_stride", [False, True])
def test_flash_attention_inside_a_block_matches_jax_module_path(monkeypatch, q_stride):
    """A global block (and a q-pool block) of 16 × 16 tokens on the module
    path (force_fused(False)) with the port's FLASH_MIN_SEQ lowered to
    64: its attention goes through FlashAttention. Output and the
    gradients of the input and every parameter against the JAX block's
    module path (einsum attention on the CPU)."""
    from flax.core import unfreeze

    from circuitvision_tpu_torch.models import bridge

    monkeypatch.setattr(thiera, "FLASH_MIN_SEQ", 64)
    dim, heads = 32, 2
    dim_out = 2 * dim if q_stride else dim
    jb = jhiera.MultiScaleBlock(dim=dim, dim_out=dim_out, num_heads=heads, q_stride=q_stride,
                                window_size=0)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 16, 16, dim)).astype(np.float32)
    variables = jax.tree.map(np.asarray, unfreeze(jb.init(jax.random.PRNGKey(3), x)))
    # non-trivial LayerNorm parameters
    for ln in ("norm1", "norm2"):
        for leaf in ("scale", "bias"):
            shape = variables["params"][ln][leaf].shape
            variables["params"][ln][leaf] = (rng.standard_normal(shape) * 0.2
                                             + (leaf == "scale")).astype(np.float32)
    dy = rng.standard_normal((2, 8, 8, dim_out) if q_stride else x.shape).astype(np.float32)

    def jloss(params, x):
        with jhiera.force_fused(False), jhiera.force_flash(False):
            return jnp.sum(jb.apply({"params": params}, x) * dy)

    (jl, (jg, jgx)) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1)))(
        variables["params"], jnp.asarray(x))
    tb = thiera.MultiScaleBlock(dim, dim_out, heads, q_stride)
    tb.load_state_dict(bridge.state_dict_from_variables(variables), strict=True)
    tx = torch.from_numpy(x).requires_grad_()
    before = fa.flash_attn_lse.launches
    calls = []
    monkeypatch.setattr(thiera, "flash_attention",
                        lambda *a: calls.append(a[0].shape) or fa.flash_attention(*a))
    with thiera.force_fused(False), thiera.force_flash(False):
        tb(tx, 0, False)
    assert not calls  # force_flash(False): einsum attention
    with thiera.force_fused(False):
        y = tb(tx, 0, False)
    assert calls and calls[0][2] == (64 if q_stride else 256)  # pooled q rows or all
    assert fa.flash_attn_lse.launches == before  # the CPU takes the plain version
    loss = (y * torch.from_numpy(dy)).sum()
    names = [n for n, _ in tb.named_parameters()]
    got = torch.autograd.grad(loss, [tx, *tb.parameters()])
    _close(loss.detach(), jl)
    _close(got[0], jgx)
    ref = bridge.state_dict_from_variables({"params": jax.tree.map(np.asarray, jg)})
    for name, g in zip(names, got[1:]):
        _close(g, ref[name])
