"""The PaliGemma VLM head of the PyTorch port against the JAX package on
the CPU, at `tiny_config()` on the weights of a seeded HF
PaliGemmaForConditionalGeneration converted by the JAX converter (the
same fixture as tests/test_paligemma.py):

  * the vision tower, prefill logits with and without an image, and
    decode-step logits along the cache (float32; the tolerances
    tests/test_paligemma.py holds the JAX package to HF with);
  * greedy_generate's tokens and lengths, an invalid row and a pad token
    emitted mid-stream among them;
  * bfloat16 prefill logits within BF16_LOGIT_BOUND, and the port's
    greedy choice along JAX's bf16 trajectory;
  * weight-only int8: the quantized trees, on-device quantization bit for
    bit, and a power-of-two checkpoint's int8 logits bitwise equal to its
    float logits;
  * convert_hf_state on both HF layouts and the converter's refusals, with
    the JAX package's messages; io/safetensors against the safetensors
    package; orbax checkpoints across the two packages;
  * the value reader (texts, prompt layout, bucket padding, direction
    parsing, noise) and the reader in the pipeline; default_client's
    `paligemma:` specs;
  * the card phase's HF-state and safetensors writers (chip_smoke.py);
  * a process that imports the head and generates loads no JAX, flax,
    safetensors or transformers.
"""
import copy
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from circuitvision_tpu.models import checkpoint as jcheckpoint
from circuitvision_tpu.models.paligemma import PaliGemma as JPaliGemma
from circuitvision_tpu.models.paligemma import convert as jconvert
from circuitvision_tpu.models.paligemma import greedy_generate as jgenerate
from circuitvision_tpu.models.paligemma import quant as jquant
from circuitvision_tpu.models.paligemma import reader as jreader
from circuitvision_tpu.models.paligemma.gemma import make_kv_cache as jcache
from circuitvision_tpu.models.paligemma.vision import SiglipVisionTower as JTower
from circuitvision_tpu_torch.models import checkpoint as tcheckpoint
from circuitvision_tpu_torch.models import paligemma as tpg
from circuitvision_tpu_torch.models.checkpoint_writer import save_variables as tsave
from circuitvision_tpu_torch.models.paligemma import convert as tconvert
from circuitvision_tpu_torch.models.paligemma import model as tmodel
from circuitvision_tpu_torch.models.paligemma import quant as tquant
from circuitvision_tpu_torch.models.paligemma import reader as treader
from circuitvision_tpu_torch.models.paligemma.gemma import make_kv_cache
from tests.test_paligemma import TINY, _hf_config, _inputs

ROOT = Path(__file__).resolve().parents[1]
#: max |port − JAX| of bf16 prefill logits, as a share of max(1, max |JAX|):
#: four bf16 ulps at the largest logit. Both round every product to bf16
#: but XLA fuses the elementwise chains in float32 where torch rounds each
#: op, so they part by a few roundings across the two layers.
BF16_LOGIT_BOUND = 2.0 ** -5
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "tensorstore", "cv2", "PIL",
             "safetensors", "transformers", "matplotlib", "circuitvision_tpu")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _exact_matmuls():
    with jax.default_matmul_precision("highest"):
        yield


@pytest.fixture(scope="module")
def hf_state():
    from transformers import PaliGemmaForConditionalGeneration

    torch.manual_seed(0)
    hf = PaliGemmaForConditionalGeneration(_hf_config()).eval()
    return {k: v.detach().clone() for k, v in hf.state_dict().items()}


@pytest.fixture(scope="module")
def variables(hf_state):
    """The JAX converter's tree (numpy), C-order copies."""
    return jax.tree.map(np.ascontiguousarray, jconvert.convert_hf_state(hf_state, TINY))


@pytest.fixture(scope="module")
def port(variables):
    return tmodel.from_variables(TINY, variables, device="cpu")


def _cfg_q(cfg=TINY):
    return dataclasses.replace(cfg, text=dataclasses.replace(cfg.text, quant_int8=True))


def _jprefill(model, variables, ids, px, extra=0):
    b, s = ids.shape
    k0, v0 = jcache(model.cfg.text, b, s + extra, dtype=model.dtype)
    logits, kc, vc = model.apply(variables, jnp.asarray(ids, jnp.int32),
                                 jnp.ones((b, s), jnp.int32), k0, v0,
                                 None if px is None else jnp.asarray(px),
                                 method=JPaliGemma.prefill)
    return np.asarray(logits.astype(jnp.float32)), kc, vc


def _tprefill(model, ids, px, extra=0):
    b, s = ids.shape
    kc, vc = make_kv_cache(model.cfg.text, b, s + extra, dtype=model.dtype, device="cpu")
    with torch.no_grad():
        logits, kc, vc = model.prefill(torch.from_numpy(ids), torch.ones((b, s), dtype=torch.int32),
                                       kc, vc, None if px is None else torch.from_numpy(px))
    return logits.float().numpy(), kc, vc


# ------------------------------------------------------------ float32
def test_vision_features(variables, port):
    _, px = _inputs()
    want = JTower(TINY.vision).apply({"params": variables["params"]["vision_tower"]},
                                     jnp.asarray(px))
    with torch.no_grad():
        got = port.vision_tower(torch.from_numpy(px))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("with_image", [True, False])
def test_prefill_logits(variables, port, with_image):
    if with_image:
        ids, px = _inputs()
    else:
        ids, px = np.random.default_rng(9).integers(10, 280, (2, 6)), None
    want, _, _ = _jprefill(JPaliGemma(TINY), variables, ids, px)
    got, _, _ = _tprefill(port, ids, px)
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-3)


def test_prefill_keeps_non_placeholder_tokens(variables, port):
    """A real token inside the image block keeps its embedding, as the
    JAX prefill's gate on the placeholder id keeps it."""
    ids, px = _inputs(batch=1)
    ids = ids.copy()
    ids[0, 1] = 42
    want, _, _ = _jprefill(JPaliGemma(TINY), variables, ids, px)
    got, _, _ = _tprefill(port, ids, px)
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-3)


def test_decode_step_logits_along_the_cache(variables, port):
    ids, px = _inputs()
    b, s = ids.shape
    forced = np.array([[30, 40, 50, 60], [35, 45, 55, 65]])
    jm = JPaliGemma(TINY)
    _, jk, jv = _jprefill(jm, variables, ids, px, extra=4)
    _, tk, tv = _tprefill(port, ids, px, extra=4)
    jmask, tmask = jnp.ones((b, s), jnp.int32), torch.ones((b, s), dtype=torch.int32)
    for i in range(4):
        want, jk, jv = jm.apply(variables, jnp.asarray(forced[:, i], jnp.int32), jnp.int32(s + i),
                                jmask, jk, jv, method=JPaliGemma.decode_step)
        with torch.no_grad():
            got, tk, tv = port.decode_step(torch.from_numpy(forced[:, i]), s + i, tmask, tk, tv)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=1e-3,
                                   err_msg=f"decode step {i}")
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-5, rtol=1e-4)


def _generate_both(variables, port, ids, px, valid, max_new, jmodel=None):
    jres = jgenerate(jmodel or JPaliGemma(TINY), variables, jnp.asarray(ids, jnp.int32),
                     jnp.asarray(px), jnp.asarray(valid), max_new)
    tres = tmodel.greedy_generate(port, torch.from_numpy(ids), torch.from_numpy(px),
                                  torch.tensor(valid), max_new)
    return (np.asarray(jres.tokens), np.asarray(jres.lengths)), (tres.tokens.numpy(),
                                                                 tres.lengths.numpy())


def test_greedy_generate_with_an_invalid_row(variables, port):
    ids, px = _inputs(batch=3)
    (jt, jl), (tt, tl) = _generate_both(variables, port, ids, px, [True, False, True], 6)
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_array_equal(tl, jl)
    assert tl[1] == 0 and (tt[1] == TINY.pad_token_id).all()


def test_greedy_generate_counts_a_pad_token_mid_stream(variables, port):
    """The pad token's embedding row is the first answer's row × 1.5, so
    its logit beats that token's: the rows emit pad_token_id while not
    done, and lengths still count every emitted step."""
    ids, px = _inputs(batch=2)
    (jt, _), _ = _generate_both(variables, port, ids, px, [True, True], 6)
    v = copy.deepcopy(variables)
    emb = v["params"]["embed_tokens"]["embedding"]
    emb[TINY.pad_token_id] = emb[jt[0, 0]] * 1.5
    (jt, jl), (tt, tl) = _generate_both(v, tmodel.from_variables(TINY, v, device="cpu"), ids, px,
                                        [True, True], 6)
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_array_equal(tl, jl)
    assert (tt[0, :tl[0]] == TINY.pad_token_id).any() and tl[0] == 6


# ------------------------------------------------------------ bfloat16
def test_bf16_logits_and_greedy_trajectory(variables):
    """bf16 prefill logits within BF16_LOGIT_BOUND of the JAX package's
    bf16 model; then JAX's greedy tokens are forced through the port's
    decode steps, and the port's argmax must be JAX's token at every step
    where JAX's top-2 margin exceeds the bound."""
    ids, px = _inputs()
    b, s = ids.shape
    jm = JPaliGemma(TINY, dtype=jnp.bfloat16)
    port = tmodel.from_variables(TINY, variables, dtype=torch.bfloat16, device="cpu")
    want, _, _ = _jprefill(jm, variables, ids, px)
    got, tk, tv = _tprefill(port, ids, px, extra=8)
    bound = BF16_LOGIT_BOUND * max(1.0, np.abs(want).max())
    assert np.abs(got - want).max() <= bound, (np.abs(got - want).max(), bound)

    res = jgenerate(jm, variables, jnp.asarray(ids, jnp.int32), jnp.asarray(px),
                    jnp.ones((b,), bool), 8)
    jtoks = np.asarray(res.tokens)
    _, jk, jv = _jprefill(jm, variables, ids, px, extra=8)
    mask = torch.ones((b, s), dtype=torch.int32)
    checked = 0
    for i in range(7):
        jl, jk, jv = jm.apply(variables, jnp.asarray(jtoks[:, i]), jnp.int32(s + i),
                              jnp.ones((b, s), jnp.int32), jk, jv,
                              method=JPaliGemma.decode_step)
        with torch.no_grad():
            tl, tk, tv = port.decode_step(torch.from_numpy(jtoks[:, i].astype(np.int64)), s + i,
                                          mask, tk, tv)
        jl = np.asarray(jl.astype(jnp.float32))
        top2 = np.sort(jl, -1)[:, -2:]
        sure = top2[:, 1] - top2[:, 0] > bound
        assert (tl.float().argmax(-1).numpy()[sure] == jtoks[sure, i + 1]).all(), i
        checked += int(sure.sum())
    assert checked >= 7  # most steps are decided


# ------------------------------------------------------------ int8
def _snap_pow2(tree):
    """Every quantization-targeted weight rounded to int8 × 2^-5 (the JAX
    test's helper, on numpy)."""
    from tests.test_paligemma import TestInt8Quant

    return jax.tree.map(np.asarray, TestInt8Quant._snap_pow2(tree))


def _same_tree(a, b):
    fa, fb = jax.tree_util.tree_leaves_with_path(a), jax.tree_util.tree_leaves_with_path(b)
    assert [jax.tree_util.keystr(k) for k, _ in fa] == [jax.tree_util.keystr(k) for k, _ in fb]
    for (k, x), (_, y) in zip(fa, fb):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and np.array_equal(x, y), jax.tree_util.keystr(k)


def test_int8_trees_bit_equal(variables):
    want = jquant.quantize_variables(variables)
    _same_tree(tquant.quantize_variables(variables), want)
    on_device = tquant.quantize_variables_on_device(copy.deepcopy(variables), "cpu")
    _same_tree(jax.tree.map(lambda t: t.numpy(), on_device), want)
    # torch leaves in, and the input tree consumed
    tree = jax.tree.map(torch.from_numpy, copy.deepcopy(variables))
    _same_tree(jax.tree.map(lambda t: t.numpy(), tquant.quantize_variables_on_device(tree)), want)
    assert tree == {}


def test_int8_pow2_checkpoint_is_bitwise_exact(variables):
    snapped = _snap_pow2(variables)
    ids, px = _inputs()
    port_f = tmodel.from_variables(TINY, snapped, device="cpu")
    port_q = tmodel.from_variables(_cfg_q(), tquant.quantize_variables(snapped),
                                   device="cpu")
    lf, _, _ = _tprefill(port_f, ids, px)
    lq, _, _ = _tprefill(port_q, ids, px)
    np.testing.assert_array_equal(lq, lf)
    (jt, _), (tt, tl) = _generate_both(tquant.quantize_variables(snapped), port_q, ids, px,
                                       [True, True], 4, jmodel=JPaliGemma(_cfg_q()))
    np.testing.assert_array_equal(tt, jt)
    tf = tmodel.greedy_generate(port_f, torch.from_numpy(ids), torch.from_numpy(px),
                                torch.tensor([True, True]), 4)
    np.testing.assert_array_equal(tt, tf.tokens.numpy())
    assert isinstance(port_q.decoder.layer_0.self_attn.q_proj, tpg.gemma.QuantDense)


def test_int8_random_checkpoint_against_jax(variables):
    """Arbitrary float weights: the port's int8 logits are the JAX
    package's int8 logits (float32), and within the JAX test's bound of
    the float model."""
    vq = tquant.quantize_variables(variables)
    ids, px = _inputs()
    got, _, _ = _tprefill(tmodel.from_variables(_cfg_q(), vq, device="cpu"), ids, px)
    want, _, _ = _jprefill(JPaliGemma(_cfg_q()), vq, ids, px)
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-3)
    lf, _, _ = _tprefill(tmodel.from_variables(TINY, variables, device="cpu"), ids, px)
    assert np.abs(lf - got).max() / np.abs(lf).mean() < 0.05


# ------------------------------------------------------------ conversion
def _old_layout(state):
    def old_name(k: str) -> str:
        k = k.removeprefix("model.")
        if k.startswith("language_model."):
            k = "language_model.model." + k[len("language_model."):]
        if k == "lm_head.weight":
            k = "language_model.lm_head.weight"
        return k

    return {old_name(k): v for k, v in state.items()}


@pytest.mark.parametrize("layout", ["nested", "flat"])
def test_convert_hf_state_equals_jax(hf_state, variables, layout):
    state = hf_state if layout == "nested" else _old_layout(hf_state)
    _same_tree(tconvert.convert_hf_state(state, TINY), variables)
    _same_tree(tconvert.convert_hf_state(tconvert.torch_state_to_numpy(state), TINY),
               variables)


def _hostile(state, case):
    state = dict(state)
    if case == "unconsumed":
        state["model.language_model.layers.0.mlp.extra.weight"] = torch.zeros(1)
    elif case == "missing":
        state.pop("model.language_model.norm.weight")
    elif case == "untied":
        state["lm_head.weight"] = state["lm_head.weight"] + 1.0
    return state


@pytest.mark.parametrize("case", ["unconsumed", "missing", "untied", "wrong config",
                                  "wrong intermediate"])
def test_converter_refusals_match_jax(hf_state, case):
    cfg = TINY
    if case == "wrong config":
        cfg = dataclasses.replace(TINY, text=dataclasses.replace(TINY.text, vocab_size=512))
    elif case == "wrong intermediate":
        cfg = dataclasses.replace(TINY, vision=dataclasses.replace(TINY.vision,
                                                                   intermediate_size=80))
    state = _hostile(hf_state, case)
    with pytest.raises(Exception) as want:
        jconvert.convert_hf_state(state, cfg)
    with pytest.raises(type(want.value)) as got:
        tconvert.convert_hf_state(state, cfg)
    assert str(got.value) == str(want.value)


def test_validate_shapes_reports_extra_and_missing_leaves(variables):
    v = copy.deepcopy(variables)
    v["params"]["decoder"]["layer_9"] = {"norm": {"weight": np.zeros(3, np.float32)}}
    del v["params"]["vision_tower"]["layer_1"]["fc2"]
    for mod in (jconvert, tconvert):
        with pytest.raises(ValueError) as err:
            mod._validate_shapes(v, TINY)
        if mod is jconvert:
            want = str(err.value)
    assert str(err.value) == want and "extra leaf" in want and "missing parameter" in want


def test_constructors_default_to_cuda(variables, monkeypatch):
    """The head's constructors run on CUDA unless the caller passes device="cpu":
    with no card each raises instead of building on the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = [lambda: tmodel.from_variables(TINY, variables),
             lambda: tmodel.seeded_model(TINY, 0),
             lambda: treader.preprocess_images([np.zeros((4, 4, 3), np.uint8)], 28),
             lambda: make_kv_cache(TINY.text, 1, 4),
             lambda: tquant.quantize_variables_on_device(copy.deepcopy(variables)),
             lambda: treader.PaliGemmaValueReader(cfg=TINY, variables=variables)]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_safetensors_reader_against_the_package(tmp_path):
    from safetensors.numpy import load_file as load_np
    from safetensors.numpy import save_file
    from safetensors.torch import save_file as save_torch

    from circuitvision_tpu_torch.io import safetensors as tst

    rng = np.random.default_rng(0)
    tensors = {"a": rng.standard_normal((3, 5)).astype(np.float32),
               "b.half": rng.standard_normal((7,)).astype(np.float16),
               "c.int8": rng.integers(-128, 127, (2, 3, 4), dtype=np.int8),
               "d.empty": np.zeros((0, 4), np.float32), "e.scalar": np.full((), 3.5, np.float64)}
    save_file(tensors, tmp_path / "x.safetensors", metadata={"format": "np"})
    got = tst.load_file(str(tmp_path / "x.safetensors"))
    assert sorted(got) == sorted(tensors)
    for k, v in tensors.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape
        np.testing.assert_array_equal(got[k], v)
    # BF16 is widened to float32 exactly: the package's own reading (bf16
    # through torch, and through numpy with ml_dtypes' bfloat16), upcast
    bf = {"w": torch.from_numpy(rng.standard_normal((4, 6)).astype(np.float32)).bfloat16(),
          "inf": torch.tensor([float("inf"), -float("inf"), float("nan"), -0.0, 1e-40],
                              dtype=torch.bfloat16)}
    save_torch(bf, tmp_path / "bf.safetensors")
    got = tst.load_file(str(tmp_path / "bf.safetensors"))
    via_np = load_np(tmp_path / "bf.safetensors")
    for k, v in bf.items():
        assert got[k].dtype == np.float32 and got[k].shape == tuple(v.shape)
        np.testing.assert_array_equal(got[k], v.float().numpy())
        np.testing.assert_array_equal(got[k], via_np[k].astype(np.float32))
    save_torch({"w": torch.ones(2, dtype=torch.float8_e4m3fn)}, tmp_path / "f8.safetensors")
    with pytest.raises(tst.SafetensorsFormatError, match=r"F8_E4M3") as err:
        tst.load_file(str(tmp_path / "f8.safetensors"))
    assert "f8.safetensors" in str(err.value)
    raw = (tmp_path / "x.safetensors").read_bytes()
    (tmp_path / "cut.safetensors").write_bytes(raw[:-4])
    with pytest.raises(tst.SafetensorsFormatError, match="'e.scalar'|'d.empty'|'c.int8'"):
        tst.load_file(str(tmp_path / "cut.safetensors"))


def test_convert_checkpoint_sources(hf_state, variables, tmp_path):
    """convert_paligemma_checkpoint from two safetensors shards, .bin shards
    beside a training_args.bin, and one torch file: each written orbax
    tree is the JAX converter's, read back by both packages; the CLI
    prints its seconds; a BF16 shard gives float32 leaves holding the JAX
    converter's bfloat16 values; a directory with no tensors raises."""
    from safetensors.numpy import save_file
    from safetensors.torch import save_file as save_torch

    np_state = {k: v.numpy() for k, v in hf_state.items()}
    keys = sorted(np_state)
    st = tmp_path / "st"
    st.mkdir()
    save_file({k: np_state[k] for k in keys[::2]}, st / "model-00001-of-00002.safetensors")
    save_file({k: np_state[k] for k in keys[1::2]}, st / "model-00002-of-00002.safetensors")
    bins = tmp_path / "bins"
    bins.mkdir()
    torch.save({k: hf_state[k] for k in keys[::2]}, bins / "pytorch_model-00001.bin")
    torch.save({k: hf_state[k] for k in keys[1::2]}, bins / "pytorch_model-00002.bin")
    torch.save({"lr": 1.0}, bins / "training_args.bin")
    one = tmp_path / "model.pt"
    torch.save(hf_state, one)
    for src in (st, bins, one):
        out = tmp_path / f"out_{src.name}"
        tcheckpoint.convert_paligemma_checkpoint(str(src), str(out), cfg=TINY)
        _same_tree(tcheckpoint.load_variables(str(out)), variables)
        _same_tree(jcheckpoint.load_variables(str(out)), variables)
    jcheckpoint.convert_paligemma_checkpoint(str(st), str(tmp_path / "jax_st"), cfg=TINY)
    _same_tree(tcheckpoint.load_variables(str(tmp_path / "jax_st")), variables)

    bf = tmp_path / "bf"
    bf.mkdir()
    save_torch({k: v.to(torch.bfloat16) for k, v in hf_state.items()}, bf / "model.safetensors")
    # the JAX converter keeps BF16 leaves (jax's ml_dtypes gives numpy the
    # type); the port widens them to float32 with the same values
    jcheckpoint.convert_paligemma_checkpoint(str(bf), str(tmp_path / "jbf"), cfg=TINY)
    jbf = jcheckpoint.load_variables(str(tmp_path / "jbf"))
    assert jbf["params"]["projector"]["kernel"].dtype.name == "bfloat16"
    tcheckpoint.convert_paligemma_checkpoint(str(bf), str(tmp_path / "tbf"), cfg=TINY)
    want = jax.tree.map(lambda x: np.asarray(x).astype(np.float32), jbf)
    _same_tree(tcheckpoint.load_variables(str(tmp_path / "tbf")), want)
    _same_tree(jcheckpoint.load_variables(str(tmp_path / "tbf")), want)
    empty = tmp_path / "empty"
    empty.mkdir()
    for mod in (jcheckpoint, tcheckpoint):
        with pytest.raises(FileNotFoundError, match="no checkpoint tensors found at"):
            mod.convert_paligemma_checkpoint(str(empty), str(tmp_path / "none"), cfg=TINY)


def test_cli_converts(tmp_path, capsys):
    """`convert-paligemma` converts at the full PaliGemmaConfig(): a tiny
    file fails its shape check with the JAX message, after reading."""
    torch.save({"model.language_model.norm.weight": torch.zeros(3)}, tmp_path / "m.pt")
    with pytest.raises(KeyError, match="checkpoint is missing"):
        tcheckpoint.main(["convert-paligemma", str(tmp_path / "m.pt"), str(tmp_path / "o")])
    assert "convert-paligemma" in tcheckpoint.USAGE
    assert tcheckpoint.main(["convert-paligemma", "x", "y", "--scale", "n"]) == 1


def test_cli_converts_tiny(hf_state, variables, tmp_path, monkeypatch, capsys):
    import circuitvision_tpu_torch.models.paligemma.config as tcfg

    monkeypatch.setattr(tcfg, "PaliGemmaConfig", lambda: TINY)
    torch.save(hf_state, tmp_path / "m.pt")
    assert tcheckpoint.main(["convert-paligemma", str(tmp_path / "m.pt"),
                             str(tmp_path / "o")]) == 0
    assert "s to read and convert" in capsys.readouterr().out
    _same_tree(jcheckpoint.load_variables(str(tmp_path / "o")), variables)


@pytest.mark.parametrize("quant", [False, True])
def test_orbax_across_packages(variables, port, tmp_path, quant):
    """A tree written by either package and read by the other gives the
    same logits: the port's writer → JAX's reader → JAX logits bitwise
    those of the tree in memory, and JAX's writer → the port's reader →
    the port's logits bitwise its own."""
    cfg = _cfg_q() if quant else TINY
    tree = tquant.quantize_variables(variables) if quant else variables
    model = tmodel.from_variables(cfg, tree, device="cpu")
    ids, px = _inputs()
    tsave(str(tmp_path / "port"), tmodel.variables_from_state_dict(model.state_dict()))
    jcheckpoint.save_variables(str(tmp_path / "jax"), tree)
    jm = JPaliGemma(cfg)
    want, _, _ = _jprefill(jm, tree, ids, px)
    got, _, _ = _jprefill(jm, jcheckpoint.load_variables(str(tmp_path / "port")), ids, px)
    np.testing.assert_array_equal(got, want)
    mine, _, _ = _tprefill(model, ids, px)
    again, _, _ = _tprefill(tmodel.from_variables(
        cfg, tcheckpoint.load_variables(str(tmp_path / "jax")), device="cpu"), ids, px)
    np.testing.assert_array_equal(again, mine)
    np.testing.assert_allclose(mine, want, atol=2e-4, rtol=1e-3)


def test_variables_round_trip(variables, port):
    _same_tree(tmodel.variables_from_state_dict(port.state_dict()), variables)
    got = jax.tree.map(lambda t: t.numpy(), tmodel.variables_of(port))
    _same_tree(got, variables)


# ------------------------------------------------------------ reader
def _readers(variables, **kw):
    j = jreader.PaliGemmaValueReader(cfg=TINY, variables=variables, max_new_tokens=6, **kw)
    t = treader.PaliGemmaValueReader(cfg=TINY, variables=variables, max_new_tokens=6,
                                     device="cpu", **kw)
    return j, t


def test_reader_texts_prompt_and_bucket(variables, monkeypatch):
    """Random weights: the texts equal JAX's for three images of two sizes
    (one resized), through a bucket of 4 whose fourth row is zero pixels
    and not valid; the prompt layout is JAX's."""
    j, t = _readers(variables)
    assert t.build_prompt_ids(treader.LABELS_TASK) == j.build_prompt_ids(jreader.LABELS_TASK)
    assert (treader.LABELS_TASK, treader.DIRECTION_TASK) == (jreader.LABELS_TASK,
                                                             jreader.DIRECTION_TASK)
    ids = t.build_prompt_ids("task")
    n = TINY.num_image_tokens
    assert ids[:n] == [TINY.image_token_id] * n and ids[n] == TINY.bos_token_id
    assert t.decode_fn(ids[n + 1:]) == "task\n"
    rng = np.random.default_rng(0)
    imgs = [rng.integers(0, 255, (40, 52, 3), np.uint8),
            rng.integers(0, 255, (28, 28, 3), np.uint8),
            rng.integers(0, 255, (19, 33, 3), np.uint8)]
    seen = []
    real = treader.greedy_generate

    def spy(model, input_ids, pixels, valid, max_new):
        seen.append((tuple(input_ids.shape), valid.tolist(), float(pixels[3:].abs().max())))
        return real(model, input_ids, pixels, valid, max_new)

    monkeypatch.setattr(treader, "greedy_generate", spy)
    assert t.generate(imgs, "read") == j.generate(imgs, "read")
    assert seen == [((4, len(ids) - len("task\n") + len("read\n")),
                     [True, True, True, False], 0.0)]
    px = treader.preprocess_images(imgs, 28, device="cpu")
    np.testing.assert_allclose(px.numpy(), np.asarray(jreader.preprocess_images(imgs, 28)),
                               atol=1e-5)


@pytest.mark.parametrize("text", [
    "the arrow points DOWN (ARROW)", "THE SUPPLY POINTS DOWN (ARROW)", "CUPBOARD UPWARD",
    "left, sign", "RIGHT? no: UP SIGN ARROW", "", "downward arrows"])
def test_direction_parsing(text):
    want = jreader.PaliGemmaValueReader._parse_direction(text)
    assert treader.PaliGemmaValueReader._parse_direction(text) == want


def test_reader_hooks_and_noise(variables):
    """The labels hooks on canned and on noise text (the noise raises the
    shared parser's ValueError in both packages, or both parse it alike);
    the direction hooks at their own budget."""
    canned = "[{'id': '1', 'class': 'resistor', 'value': '10k'}]"
    j, t = _readers(variables, decode_fn=lambda ids: canned)
    img = np.zeros((32, 32, 3), np.uint8)
    assert t.get_labels(img) == j.get_labels(img)
    assert t.get_labels_batch([img, img]) == j.get_labels_batch([img, img])
    seen = []

    def capture(ids):
        seen.append(len(list(ids)))
        return "DOWN ARROW"

    j, t = _readers(variables, decode_fn=capture, direction_max_new_tokens=3)
    assert t.get_direction(img, "diode") == ("DOWN", "ARROW")
    assert t.get_directions_batch([img, img], ["diode", "diode"]) == [("DOWN", "ARROW")] * 2
    assert seen and max(seen) <= 3
    j, t = _readers(variables)
    outs = []
    for r in (j, t):
        try:
            outs.append(("ok", r.get_labels(img)))
        except ValueError as exc:
            outs.append(("ValueError", str(exc)))
    assert outs[0] == outs[1]
    assert t.get_labels_batch([img]) == j.get_labels_batch([img])
    assert t.get_directions_batch([img, img[:20]], ["diode"] * 2) == \
        j.get_directions_batch([img, img[:20]], ["diode"] * 2)


def test_reader_in_the_pipeline(variables):
    """The reader (canned decode) as CircuitAnalyzerTorch(device="cpu")'s
    client with oracle boxes: analyze() + generate_final_netlist gives the
    JAX package's final netlist and stage-2 rows; finalize_netlists in
    chunks of 2 equals the per-image path, one labels generate a chunk."""
    from circuitvision_tpu.core.config import DetectorConfig, PipelineConfig
    from circuitvision_tpu.eval.synth import make_circuits
    from circuitvision_tpu.pipeline.analyzer import CircuitAnalyzerTPU
    from circuitvision_tpu_torch.core import config as tconfig
    from circuitvision_tpu_torch.core.types import BBox
    from circuitvision_tpu_torch.models import bridge
    from circuitvision_tpu_torch.pipeline.analyzer import CircuitAnalyzerTorch

    canned = ("[{'id': '1', 'class': 'voltage.dc', 'value': '10'},"
              " {'id': '2', 'class': 'resistor', 'value': '1k'}]")
    j, t = _readers(variables, decode_fn=lambda _ids: canned)
    circuit = make_circuits()[0]
    det = dict(scale="n", img_size=64, num_classes=62, dtype="float32")
    ja = CircuitAnalyzerTPU(config=PipelineConfig(detector=DetectorConfig(**det), use_sam2=False),
                            use_sam2=False, vlm_client=j)
    ja.bboxes = lambda img: copy.deepcopy(circuit.boxes)
    meta = {"detector": {"scale": "n", "img_size": 64, "num_classes": 62, "reg_max": 16}}
    ta = CircuitAnalyzerTorch(tconfig.PipelineConfig(detector=tconfig.DetectorConfig(**det),
                                                     use_sam2=False),
                              bridge.seeded_state("yolo", meta, 0), None, device="cpu",
                              vlm_client=t)
    fields = ("class_name", "confidence", "xmin", "ymin", "xmax", "ymax")
    ta.bboxes = lambda img: [BBox(**{f: getattr(b, f) for f in fields}) for b in circuit.boxes]
    want = ja.generate_final_netlist(ja.analyze(circuit.image))
    base = ta.analyze(circuit.image)
    assert base.enum_image is not None
    got = ta.generate_final_netlist(copy.deepcopy(base))
    assert got.netlist_text == want.netlist_text and " 10" in got.netlist_text
    assert got.vlm_stage2_output == want.vlm_stage2_output
    calls = []
    real = t.generate
    t.generate = lambda images, task, **kw: calls.append(len(images)) or real(images, task, **kw)
    batched = ta.finalize_netlists([copy.deepcopy(base) for _ in range(3)], chunk_size=2)
    assert [r.netlist_text for r in batched] == [got.netlist_text] * 3
    assert calls == [2, 1]


def test_default_client_paligemma(variables, tmp_path, monkeypatch):
    """CIRCUITVISION_VLM=paligemma:<dir> and paligemma:<dir>:int8 on the
    config monkeypatched as JAX's TestDefaultClientSelection does: the
    reader on the asked device, int8 quantized at load; JAX's reader at
    int8 generates the same text."""
    from circuitvision_tpu.enrich import client as jclient
    from circuitvision_tpu_torch.enrich import client as tclient

    ckpt = tmp_path / "pg"
    tsave(str(ckpt), variables)
    monkeypatch.setattr(tpg, "PaliGemmaConfig", lambda: TINY)
    monkeypatch.setenv("CIRCUITVISION_VLM", f"paligemma:{ckpt}")
    got = tclient.default_client(device="cpu")
    assert isinstance(got, treader.PaliGemmaValueReader) and got.cfg == TINY
    assert got.device == torch.device("cpu") and got.dtype == torch.float32
    monkeypatch.setenv("CIRCUITVISION_VLM", f"paligemma:{ckpt}:int8")
    got = tclient.default_client(device="cpu")
    assert got.cfg.text.quant_int8
    q = got.model.decoder.layer_0.self_attn.q_proj
    assert q.kernel_q.dtype == torch.int8 and q.scale.dtype == torch.float32
    import circuitvision_tpu.models.paligemma as jpg

    monkeypatch.setattr(jpg, "PaliGemmaConfig", lambda: TINY)
    want = jclient.default_client()
    img = np.zeros((16, 16, 3), np.uint8)
    assert got.generate([img], "task", max_new_tokens=6) == \
        want.generate([img], "task", max_new_tokens=6)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tclient.default_client()


# ------------------------------------------------------------ the card phase's helpers
def test_card_phase_writes_the_hf_state(hf_state, variables, tmp_path):
    """chip_smoke.py phase 15 (d) builds the HF-layout state from the
    variables and writes it as safetensors shards with its own writer:
    the safetensors package reads the shards, and the converter gives the
    variables back."""
    import chip_smoke
    from safetensors.numpy import load_file

    state = chip_smoke.hf_state_from_variables(variables)
    assert sorted(state) == sorted(hf_state)
    for k, v in state.items():
        np.testing.assert_array_equal(v, hf_state[k].numpy(), err_msg=k)
    paths = chip_smoke.write_safetensors_shards(state, tmp_path, 2)
    assert len(paths) == 2
    read = {}
    for p in paths:
        read.update(load_file(str(p)))
    assert sorted(read) == sorted(state)
    assert all(np.array_equal(read[k], v) for k, v in state.items())
    _same_tree(tcheckpoint.paligemma_variables_from_checkpoint(str(tmp_path), TINY), variables)


def test_head_loads_no_jax(tmp_path):
    """Importing the head, the converter's reader and the leftovers, and
    generating, loads none of FORBIDDEN."""
    code = f"""
import json, sys
startup = set(sys.modules)
sys.path.insert(0, {str(ROOT)!r})
import numpy as np, torch
from circuitvision_tpu_torch.models import paligemma as pg
from circuitvision_tpu_torch.models.paligemma import model, quant
from circuitvision_tpu_torch.models.checkpoint import paligemma_variables_from_checkpoint
from circuitvision_tpu_torch.io import safetensors as st
from circuitvision_tpu_torch.ops.skeleton import skeletonize
from circuitvision_tpu_torch.core import logging_util
cfg = pg.tiny_config()
m = model.seeded_model(cfg, 0, device="cpu")
v = model.variables_from_state_dict(m.state_dict())
r = pg.PaliGemmaValueReader(cfg=cfg, variables=v, device="cpu", max_new_tokens=3)
r.generate([np.zeros((9, 9, 3), np.uint8)], "t")
quant.quantize_variables_on_device(v, "cpu")
skeletonize(np.ones((5, 5), np.uint8), device="cpu")
print(json.dumps(sorted(set(sys.modules) - startup)))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=tmp_path, env={**os.environ, "PYTHONPATH": ""}, timeout=300)
    assert out.returncode == 0, out.stderr
    mods = json.loads(out.stdout.strip().splitlines()[-1])
    for m in ("models.paligemma.reader", "models.paligemma.convert", "io.safetensors",
              "ops.skeleton", "core.logging_util"):
        assert "circuitvision_tpu_torch." + m in mods
    bad = [m for m in mods if m in FORBIDDEN or m.startswith(tuple(f + "." for f in FORBIDDEN))]
    assert not bad, bad
