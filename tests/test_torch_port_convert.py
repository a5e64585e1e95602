"""The port's checkpoint converters (models/yolo/convert.py,
models/sam2/convert.py) and the variable map back to the JAX tree
(models/bridge.variables_from_state_dict, variables_template) against
the JAX package's converters and flax init, on the CPU.

Tiny shapes: YOLOv11-n and the TINY_SAM / TINY_TARGETS layout of
tests/test_checkpoint_conversion.py (the reference's 36 LoRA targets
with Hiera-L's trunk blocks 44 and 47 mapped onto blocks of the tiny
trunk), seeded numpy inputs. YOLO converts exactly as JAX does; SAM2
with LoRA folded is held to 1e-6 × max |jax| per leaf, and measured
bit-equal (both fold in numpy float32 with the same operations). The
frozen YOLO-l and SAM2-L inventories are built from port modules on the
meta device, with no JAX.
"""
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from circuitvision_tpu.core.config import SAM2Config as JSAM2Config
from circuitvision_tpu.models.sam2 import convert as jsam2_convert
from circuitvision_tpu.models.sam2.wrapper import SAM2ImageSegmenter as JSAM2
from circuitvision_tpu.models.sam2.wrapper import init_params as jsam2_init
from circuitvision_tpu.models.yolo import convert as jyolo_convert
from circuitvision_tpu.models.yolo.model import YOLOv11 as JYOLO
from circuitvision_tpu.models.yolo.model import init_params as jyolo_init
from circuitvision_tpu.train.reader import ReaderConfig as JReaderConfig
from circuitvision_tpu.train.reader import init_reader as jreader_init
from circuitvision_tpu_torch.core.config import DetectorConfig, SAM2Config
from circuitvision_tpu_torch.models import bridge
from circuitvision_tpu_torch.models.reader import CropReader
from circuitvision_tpu_torch.models.sam2 import convert as sam2_convert
from circuitvision_tpu_torch.models.sam2.wrapper import SAM2ImageSegmenter
from circuitvision_tpu_torch.models.yolo import convert as yolo_convert
from circuitvision_tpu_torch.models.yolo.model import YOLOv11

FIXTURES = Path(__file__).resolve().parent / "fixtures"
TINY_SAM = dict(resolution=128, embed_dim=32, num_heads=1, stages=(1, 1, 2, 1),
                global_att_blocks=(3,), window_spec=(4, 2, 4, 2),
                backbone_channel_list=(256, 128, 64, 32), decoder_mlp_dim=64,
                dtype="float32")
TINY_TARGETS = tuple(t.replace("blocks.44", "blocks.4").replace("blocks.47", "blocks.3")
                     for t in jsam2_convert.REFERENCE_LORA_TARGETS)
SAM2_MODEL_ROOTS = ("image_encoder.", "sam_mask_decoder.", "sam_prompt_encoder.")
RANK, ALPHA = 4, 16.0
#: the converted SAM2 leaves against JAX's: max |port − jax| ≤ this ×
#: max |jax| (0 measured)
SAM2_FOLD_RTOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the module's tests, restored after: the
    suite runs six workers on eight cores, where torch's oversubscribed
    thread pools make these tests several times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _leaves(tree):
    return dict(bridge.flatten(tree))


def _meta_model(kind):
    with torch.device("meta"):
        if kind == "yolo":
            return YOLOv11(62, "n")
        if kind == "sam2":
            return SAM2ImageSegmenter(SAM2Config(**TINY_SAM))
        return CropReader()


@pytest.fixture(scope="module")
def jax_vars():
    """JAX-initialised variable trees (numpy) at the tiny shapes: a
    checkpoint's values, and the tree JAX's converters fill (their own
    template: a converter that left it as it was would give the
    unfolded SAM2 weights, which the fold tests tell apart)."""
    return {
        "yolo": _np(jyolo_init(JYOLO(num_classes=62, scale="n"), jax.random.PRNGKey(3),
                               img_size=64)),
        "sam2": _np(jsam2_init(JSAM2(cfg=JSAM2Config(**TINY_SAM)), jax.random.PRNGKey(7))),
        "reader": _np(jreader_init(JReaderConfig(), jax.random.PRNGKey(1))),
    }


def ultralytics_checkpoint(torch_state, reg_max=16):
    """An exported YOLO state dict as ultralytics saves it: nested once
    under `model.`, with the DFL arange and a BatchNorm counter."""
    ckpt = {f"model.{k}": v for k, v in torch_state.items()}
    ckpt["model.model.23.dfl.conv.weight"] = np.arange(reg_max, dtype=np.float32).reshape(
        1, reg_max, 1, 1)
    ckpt["model.model.0.bn.num_batches_tracked"] = np.zeros((), np.int64)
    return ckpt


def peft_checkpoint(torch_state, targets, rng):
    """A SAM2 state dict as the reference fine-tune saves it: PEFT's
    `base_layer` and rank-RANK `lora_A/lora_B.default` on `targets`,
    wrapper parameters bare, and video-memory entries the image path
    never reads. Returns (checkpoint, {target: (A, B)})."""
    peft, loras = {}, {}
    for key, val in torch_state.items():
        if not key.startswith(SAM2_MODEL_ROOTS):
            peft[key] = val
            continue
        mod = key.rsplit(".", 1)[0]
        base = f"sam2_model.base_model.model.{mod}"
        if key.endswith(".weight") and mod in targets:
            if val.ndim == 2:
                a = rng.standard_normal((RANK, val.shape[1])).astype(np.float32)
                b = rng.standard_normal((val.shape[0], RANK)).astype(np.float32)
            else:  # Conv2d: PEFT's A is a conv, B a 1×1 conv
                a = rng.standard_normal((RANK, *val.shape[1:])).astype(np.float32)
                b = rng.standard_normal((val.shape[0], RANK, 1, 1)).astype(np.float32)
            peft[f"{base}.base_layer.weight"] = val
            peft[f"{base}.lora_A.default.weight"] = a
            peft[f"{base}.lora_B.default.weight"] = b
            loras[mod] = (a, b)
        elif mod in targets:
            peft[f"{base}.base_layer.bias"] = val
        else:
            peft[f"sam2_model.base_model.model.{key}"] = val
    peft["sam2_model.base_model.model.memory_attention.layers.0.self_attn.q_proj.weight"] = \
        np.zeros((4, 4), np.float32)
    peft["sam2_model.base_model.model.memory_encoder.fuser.layers.0.norm.num_batches_tracked"] \
        = np.zeros((), np.int64)
    peft["sam2_model.base_model.model.no_mem_embed"] = np.zeros((1, 1, 8), np.float32)
    return peft, loras


# ------------------------------------------------------------ the map back
@pytest.mark.parametrize("kind", ["yolo", "sam2", "reader"])
def test_variables_from_state_dict_round_trips_exactly(jax_vars, kind):
    """JAX variables → port state dict → JAX variables, every leaf's
    bytes (SAM2's ConvTranspose flip and the BatchNorm statistics
    included); the template has the same paths and shapes."""
    ref = jax_vars[kind]
    model = _meta_model(kind)
    back = bridge.variables_from_state_dict(bridge.state_dict_from_variables(ref), model)
    got, want = _leaves(back), _leaves(ref)
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert got[k].dtype == np.float32 and got[k].shape == w.shape, k
        assert got[k].tobytes() == np.asarray(w, np.float32).tobytes(), k
    template = _leaves(bridge.variables_template(model))
    assert {k: v.shape for k, v in template.items()} == {k: v.shape for k, v in want.items()}


@pytest.mark.parametrize("kind", ["yolo", "sam2"])
def test_template_has_jax_init_paths_and_shapes(jax_vars, kind):
    """The meta-device template against flax init at the same config: no
    leaf holds memory."""
    template = _leaves(bridge.variables_template(_meta_model(kind)))
    want = _leaves(jax_vars[kind])
    assert {k: v.shape for k, v in template.items()} == \
        {k: np.shape(v) for k, v in want.items()}
    assert all(v.strides == (0,) * v.ndim for v in template.values())


@pytest.mark.parametrize("kind", ["yolo", "sam2"])
def test_export_torch_state_equals_jax(jax_vars, kind):
    port, jaxc = (yolo_convert, jyolo_convert) if kind == "yolo" else (sam2_convert,
                                                                       jsam2_convert)
    got, want = port.export_torch_state(jax_vars[kind]), jaxc.export_torch_state(jax_vars[kind])
    assert list(got) == list(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype and got[k].tobytes() == w.tobytes(), k
    assert port.expected_torch_keys(jax_vars[kind]) == jaxc.expected_torch_keys(jax_vars[kind])


# ------------------------------------------------------------ the converters
def test_yolo_convert_equals_jax(jax_vars):
    """An ultralytics-nested checkpoint (`model.model.`, DFL arange,
    num_batches_tracked, torch tensors) into the port's template and into
    JAX's: the same tree, exactly, and the checkpoint's values."""
    src = jax_vars["yolo"]
    ckpt = ultralytics_checkpoint(jyolo_convert.export_torch_state(src))
    ckpt = {k: torch.from_numpy(np.array(v)) for k, v in ckpt.items()}
    got = _leaves(yolo_convert.convert_state_dict(
        ckpt, bridge.variables_template(_meta_model("yolo"))))
    want = _leaves(_np(jyolo_convert.convert_state_dict(ckpt, src)))
    assert got.keys() == want.keys() == _leaves(src).keys()
    for k, w in want.items():
        assert got[k].dtype == np.float32 and got[k].tobytes() == w.tobytes(), k
        assert got[k].tobytes() == np.asarray(_leaves(src)[k], np.float32).tobytes(), k


def test_sam2_convert_with_lora_equals_jax(jax_vars):
    """A PEFT checkpoint with all 36 (tiny-mapped) LoRA targets and
    video-memory entries: the port's tree is JAX's within SAM2_FOLD_RTOL
    per leaf, and exactly the 36 target weights moved."""
    src = jax_vars["sam2"]
    torch_state = jsam2_convert.export_torch_state(src)
    assert all(f"{t}.weight" in torch_state for t in TINY_TARGETS)
    peft, loras = peft_checkpoint(torch_state, TINY_TARGETS, np.random.default_rng(0))
    assert len(loras) == len(TINY_TARGETS) == 36
    got = _leaves(sam2_convert.convert_state_dict(
        peft, bridge.variables_template(_meta_model("sam2")), lora_alpha=ALPHA))
    want = _leaves(_np(jsam2_convert.convert_state_dict(peft, src, lora_alpha=ALPHA)))
    orig = _leaves(src)
    assert got.keys() == want.keys() == orig.keys()
    worst, moved = 0.0, 0
    for k, w in want.items():
        assert got[k].dtype == np.float32 and got[k].shape == w.shape, k
        err = float(np.abs(got[k] - w).max()) / max(float(np.abs(w).max()), 1e-30)
        worst = max(worst, err)
        moved += not np.array_equal(got[k], np.asarray(orig[k]))
    assert worst <= SAM2_FOLD_RTOL, worst
    assert moved == len(TINY_TARGETS)


def _raises_alike(port_call, jax_call, exc):
    with pytest.raises(exc) as got:
        port_call()
    with pytest.raises(exc) as want:
        jax_call()
    assert str(got.value) == str(want.value)
    return str(got.value)


@pytest.mark.parametrize("case", ["missing", "stray", "shape"])
def test_yolo_faults_raise_as_jax(jax_vars, case):
    src = jax_vars["yolo"]
    ckpt = ultralytics_checkpoint(jyolo_convert.export_torch_state(src))
    if case == "missing":
        del ckpt["model.model.0.conv.weight"]
    elif case == "stray":
        ckpt["model.model.99.conv.weight"] = np.zeros((2, 2, 1, 1), np.float32)
    else:
        ckpt["model.model.0.bn.weight"] = np.zeros(3, np.float32)
    template = bridge.variables_template(_meta_model("yolo"))
    msg = _raises_alike(lambda: yolo_convert.convert_state_dict(ckpt, template),
                        lambda: jyolo_convert.convert_state_dict(ckpt, src),
                        ValueError if case == "shape" else KeyError)
    assert {"missing": "Missing", "stray": "silently dropped",
            "shape": "Shape mismatch"}[case] in msg


@pytest.mark.parametrize("case", ["missing", "stray", "dangling", "shape"])
def test_sam2_faults_raise_as_jax(jax_vars, case):
    src = jax_vars["sam2"]
    state = jsam2_convert.export_torch_state(src)
    if case == "missing":
        del state["sam_mask_decoder.conv_s0.weight"]
    elif case == "stray":
        state["sam_mask_decoder.mystery_head.weight"] = np.zeros((2, 2), np.float32)
    elif case == "dangling":
        state["sam_mask_decoder.conv_s0.lora_A.default.weight"] = np.zeros((4, 8), np.float32)
    else:
        state["sam_mask_decoder.conv_s0.weight"] = np.zeros((3, 3), np.float32)
    template = bridge.variables_template(_meta_model("sam2"))
    msg = _raises_alike(lambda: sam2_convert.convert_state_dict(state, template),
                        lambda: jsam2_convert.convert_state_dict(state, src),
                        ValueError if case == "shape" else KeyError)
    assert {"missing": "Missing", "stray": "silently dropped", "dangling": "LoRA",
            "shape": "Shape mismatch"}[case] in msg


# ------------------------------------------------------ frozen inventories
def _fixture(name):
    with open(FIXTURES / f"{name}_reference_checkpoint_keys.json") as f:
        return {k: tuple(v) for k, v in json.load(f).items()}


def _l_template(kind):
    with torch.device("meta"):
        model = YOLOv11(DetectorConfig().num_classes, "l") if kind == "yolo" \
            else SAM2ImageSegmenter(SAM2Config())
    return bridge.variables_template(model)


@pytest.mark.parametrize("kind", ["yolo", "sam2"])
def test_l_inventories_equal_the_frozen_fixtures(kind):
    """YOLOv11-l (62 classes) and PEFT SAM2.1-L@1024 from meta-device
    templates: every key and shape of tests/fixtures."""
    conv = yolo_convert if kind == "yolo" else sam2_convert
    got = conv.reference_checkpoint_inventory(_l_template(kind))
    assert got == _fixture(f"{kind}_l")


def test_yolo_l_every_fixture_key_consumed():
    """A checkpoint of exactly the frozen YOLO-l keys (zeros, 97 MiB)
    converts; a dropped key and a stray key fail."""
    fixture = _fixture("yolo_l")
    ckpt = {k: np.zeros(s, np.float32) for k, s in fixture.items()}
    template = _l_template("yolo")
    out = _leaves(yolo_convert.convert_state_dict(ckpt, template))
    assert len(out) == len(_leaves(template)) == len(
        [k for k in fixture if not k.endswith(yolo_convert.KNOWN_UNUSED_SUFFIXES)
         and k not in yolo_convert.KNOWN_UNUSED_KEYS])
    stray = {**ckpt, "model.24.conv.weight": np.zeros((2, 2, 1, 1), np.float32)}
    with pytest.raises(KeyError, match="silently dropped"):
        yolo_convert.convert_state_dict(stray, template)
    del ckpt["model.10.m.0.attn.qkv.conv.weight"]
    with pytest.raises(KeyError, match="Missing"):
        yolo_convert.convert_state_dict(ckpt, template)
