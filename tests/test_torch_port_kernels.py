"""The plain PyTorch versions of the port's four kernels against the JAX
package's Pallas kernels (interpret mode, called as
tests/test_pallas_kernels.py calls them) and against the JAX module
math, on the same numpy inputs; and the wrappers' dispatch on the CPU.

Tolerances are float32: 1e-4 absolute for the MLP and refinement halves
(sums of up to a few hundred products in another order), 1e-5 of the
output's scale for the attention halves, as the Pallas tests use.
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from circuitvision_tpu.models.sam2 import hiera as jhiera
from circuitvision_tpu.ops.pallas.mlp_block import mlp_block as pallas_mlp
from circuitvision_tpu.ops.pallas.refinement_fused import refinement_fused as pallas_refine
from circuitvision_tpu.ops.pallas.window_attn import (
    qpool_attn_block as pallas_qpool,
    window_attn_block as pallas_window,
)
from circuitvision_tpu_torch.ops.cuda import build
from circuitvision_tpu_torch.ops.cuda import mlp_block as tmlp
from circuitvision_tpu_torch.ops.cuda import refinement as trefine
from circuitvision_tpu_torch.ops.cuda import window_attn as twin

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _exact_matmuls():
    with jax.default_matmul_precision("highest"):
        yield


def _arr(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _ln(x, s, b):
    mean = x.mean(-1, keepdims=True)
    var = np.maximum((x * x).mean(-1, keepdims=True) - mean * mean, 0.0)
    return (x - mean) / np.sqrt(var + 1e-6) * s + b


# ---------------------------------------------------------------- mlp_block
@pytest.mark.parametrize("t,c", [(100, 48), (64, 96)])
def test_mlp_block_plain_matches_pallas(t, c):
    rng = np.random.default_rng(0)
    h = 4 * c
    x, lns, lnb = _arr(rng, t, c), _arr(rng, c), _arr(rng, c)
    w0, b0 = _arr(rng, c, h, scale=0.1), _arr(rng, h, scale=0.05)
    w1, b1 = _arr(rng, h, c, scale=0.1), _arr(rng, c, scale=0.05)
    ref = np.asarray(pallas_mlp(*map(jnp.asarray, (x, lns, lnb, w0, b0, w1, b1)),
                                row_tile=32, hidden_chunk=h // 2, interpret=True))
    # torch Linear layout: (out, in)
    got = tmlp.mlp_block_plain(*_t(x, lns, lnb, w0.T.copy(), b0, w1.T.copy(), b1)).numpy()
    assert np.abs(got - ref).max() < 1e-4
    # and the module math (LN2 → Dense → exact GELU → Dense → residual)
    mod = x + np.asarray(jax.nn.gelu(jnp.asarray(_ln(x, lns, lnb) @ w0 + b0),
                                     approximate=False)) @ w1 + b1
    assert np.abs(got - mod).max() < 1e-4


def test_mlp_block_wrapper_takes_plain_on_cpu():
    rng = np.random.default_rng(1)
    args = _t(_arr(rng, 8, 16), _arr(rng, 16), _arr(rng, 16), _arr(rng, 64, 16),
              _arr(rng, 64), _arr(rng, 16, 64), _arr(rng, 16))
    before = tmlp.mlp_block.launches
    torch.testing.assert_close(tmlp.mlp_block(*args), tmlp.mlp_block_plain(*args),
                               rtol=0, atol=0)
    assert tmlp.mlp_block.launches == before  # no kernel launched on the CPU


# ---------------------------------------------------------- window attention
def _window_args(rng, c):
    return (_arr(rng, c), _arr(rng, c), _arr(rng, c, 3 * c, scale=0.1),
            _arr(rng, 3 * c, scale=0.05), _arr(rng, c, c, scale=0.1), _arr(rng, c, scale=0.05))


@pytest.mark.parametrize("wt,t,c,heads", [(8, 16, 48, 2), (4, 64, 32, 1), (6, 4, 32, 4)])
def test_window_attn_plain_matches_pallas(wt, t, c, heads):
    rng = np.random.default_rng(2)
    x = _arr(rng, wt, t, c)
    lns, lnb, wqkv, bqkv, wproj, bproj = _window_args(rng, c)
    ref = np.asarray(pallas_window(*map(jnp.asarray, (x, lns, lnb, wqkv, bqkv, wproj, bproj)),
                                   heads=heads, gw=wt // 2, interpret=True))
    got = twin.window_attn_block_plain(
        *_t(x, lns, lnb, wqkv.T.copy(), bqkv, wproj.T.copy(), bproj), heads=heads).numpy()
    assert np.abs(got - ref).max() / np.abs(ref).max() < 1e-5


def test_window_attn_plain_matches_module_block():
    """A partitioned Hiera block's attention half on the JAX module path
    (CPU: LN1 → MultiScaleAttention → residual), through the kernel's
    plain version."""
    rng = np.random.default_rng(3)
    c, heads = 32, 2
    x = _arr(rng, 4, 4, 4, c)  # 4 windows of 4×4
    blk = jhiera.MultiScaleBlock(dim=c, dim_out=c, num_heads=heads)
    v = jax.tree.map(np.asarray, blk.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    p = v["params"]
    # attention half only: zero the MLP so out = x + attn(x) + 0
    p["mlp_layers_1"]["kernel"] = np.zeros_like(p["mlp_layers_1"]["kernel"])
    ref = np.asarray(blk.apply({"params": p}, jnp.asarray(x)))
    got = twin.window_attn_block_plain(
        *_t(x.reshape(4, 16, c), p["norm1"]["scale"], p["norm1"]["bias"],
            p["attn"]["qkv"]["kernel"].T.copy(), p["attn"]["qkv"]["bias"],
            p["attn"]["proj"]["kernel"].T.copy(), p["attn"]["proj"]["bias"]),
        heads=heads).numpy().reshape(x.shape)
    assert np.abs(got - ref).max() < 1e-5


@pytest.mark.parametrize("win,s,heads", [(4, 8, 2), (8, 16, 2), (2, 8, 4)])
def test_qpool_attn_plain_matches_pallas_and_module(win, s, heads):
    rng = np.random.default_rng(4)
    b, ci, co = 2, 32, 64
    x = _arr(rng, b, s, s, ci)
    lns, lnb = _arr(rng, ci), _arr(rng, ci)
    wsk, bsk = _arr(rng, ci, co, scale=0.1), _arr(rng, co, scale=0.05)
    wqkv, bqkv = _arr(rng, ci, 3 * co, scale=0.1), _arr(rng, 3 * co, scale=0.05)
    wpr, bpr = _arr(rng, co, co, scale=0.1), _arr(rng, co, scale=0.05)
    xw, _ = jhiera.window_partition(jnp.asarray(x), win)
    nw = xw.shape[0]
    rows = np.asarray(xw).reshape(nw * win * win, ci)
    got = twin.qpool_attn_block_plain(
        *_t(rows, lns, lnb, wsk.T.copy(), bsk, wqkv.T.copy(), bqkv, wpr.T.copy(), bpr),
        heads=heads, win=win).numpy()
    scale = 1.0
    if (win * win) % 8 == 0:  # the Pallas kernel tiles rows in eights
        ref = np.asarray(pallas_qpool(*map(jnp.asarray, (rows, lns, lnb, wsk, bsk, wqkv, bqkv,
                                                         wpr, bpr)),
                                      heads=heads, win=win, interpret=True))
        scale = np.abs(ref).max()
        assert np.abs(got - ref).max() / scale < 1e-5
    # module path: a q_stride MultiScaleBlock with the MLP zeroed
    blk = jhiera.MultiScaleBlock(dim=ci, dim_out=co, num_heads=heads, q_stride=True,
                                 window_size=win)
    params = {
        "norm1": {"scale": lns, "bias": lnb}, "proj": {"kernel": wsk, "bias": bsk},
        "attn": {"qkv": {"kernel": wqkv, "bias": bqkv}, "proj": {"kernel": wpr, "bias": bpr}},
        "norm2": {"scale": np.ones(co, np.float32), "bias": np.zeros(co, np.float32)},
        "mlp_layers_0": {"kernel": np.zeros((co, 4 * co), np.float32),
                         "bias": np.zeros(4 * co, np.float32)},
        "mlp_layers_1": {"kernel": np.zeros((4 * co, co), np.float32),
                         "bias": np.zeros(co, np.float32)},
    }
    mod = np.asarray(blk.apply({"params": params}, jnp.asarray(x)))
    m = win // 2
    out = got.reshape(nw, m, m, co)
    full = np.asarray(jhiera.window_unpartition(jnp.asarray(out), m, (s // 2, s // 2),
                                                (s // 2, s // 2)))
    assert np.abs(full - mod).max() / max(scale, np.abs(mod).max()) < 1e-5


# --------------------------------------------------------------- refinement
def _refine_params(rng):
    ws = [_arr(rng, k, k, 1, 4, scale=0.2) for k in trefine.KERNELS]
    bs = [_arr(rng, 4, scale=0.1) for _ in trefine.KERNELS]
    return ws, bs, _arr(rng, 1, 1, 16, 1, scale=0.3), _arr(rng, 1)


@pytest.mark.parametrize("shape", [(2, 96, 160, 1), (1, 70, 130, 1)])
def test_refinement_plain_matches_pallas(shape):
    rng = np.random.default_rng(5)
    x = _arr(rng, *shape)
    ws, bs, wc, bc = _refine_params(rng)
    ref = np.asarray(pallas_refine(jnp.asarray(x), tuple(map(jnp.asarray, ws)),
                                   tuple(map(jnp.asarray, bs)), jnp.asarray(wc),
                                   jnp.asarray(bc), tile_h=32, interpret=True))
    got = trefine.refinement_plain(
        torch.from_numpy(x), [torch.from_numpy(w.transpose(3, 2, 0, 1).copy()) for w in ws],
        _t(*bs), torch.from_numpy(wc.transpose(3, 2, 0, 1).copy()), torch.from_numpy(bc),
    ).numpy()
    assert np.abs(got - ref).max() < 1e-4


def test_refinement_wrapper_takes_plain_on_cpu():
    rng = np.random.default_rng(6)
    x = torch.from_numpy(_arr(rng, 1, 24, 40, 1))
    ws, bs, wc, bc = _refine_params(rng)
    wst = [torch.from_numpy(w.transpose(3, 2, 0, 1).copy()) for w in ws]
    before = trefine.refinement.launches
    args = (x, wst, _t(*bs), torch.from_numpy(wc.transpose(3, 2, 0, 1).copy()),
            torch.from_numpy(bc))
    torch.testing.assert_close(trefine.refinement(*args), trefine.refinement_plain(*args),
                               rtol=0, atol=0)
    assert trefine.refinement.launches == before


# -------------------------------------------------------------- build side
def test_build_raises_kernel_error_without_nvcc(monkeypatch, tmp_path):
    """Where no nvcc exists, building raises KernelError (no silent
    fallback); a missing compiler is simulated by an empty PATH."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(build, "BUILD", tmp_path / "build")
    if Path("/usr/local/cuda/bin/nvcc").exists():
        pytest.skip("this machine has /usr/local/cuda/bin/nvcc")
    with pytest.raises(build.KernelError):
        build.build_all()


def test_launcher_signatures_match_sources():
    """Every launcher the ctypes table declares is exported by its
    source with the same number of parameters."""
    for name, fns in build.SIGNATURES.items():
        src = (build.CSRC / f"{name}.cu").read_text()
        for fn, argtypes in fns.items():
            m = re.search(r'extern "C" [\w ]+ ' + fn + r"\(([^)]*)\)", src)
            assert m, f"{fn} not exported by {name}.cu"
            assert len(m.group(1).split(",")) == len(argtypes), fn


def test_wrappers_reject_unsupported_operands():
    """Non-CPU tensors must be CUDA tensors of one float dtype: a meta
    tensor is refused before any build or launch."""
    x = torch.empty(4, 8, device="meta")
    with pytest.raises(build.KernelError):
        tmlp.mlp_block(x, *(torch.empty(8, device="meta") for _ in range(2)),
                       torch.empty(32, 8, device="meta"), torch.empty(32, device="meta"),
                       torch.empty(8, 32, device="meta"), torch.empty(8, device="meta"))
    with pytest.raises(build.KernelError):
        build.dtype_code(torch.empty(2, dtype=torch.float16))
