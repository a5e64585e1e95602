"""The port's orbax writer (models/checkpoint_writer.py, io/zstd.compress),
and its converter command line (models/checkpoint.main), on the CPU
(the trainers' saved models: tests/test_torch_port_trainer_save.py).

What the port writes is read back equal — values, dtypes, shapes — by
orbax (the JAX package's `load_variables`, `load_model_checkpoint`), by
tensorstore and by the port's own reader. The converters' command line
gives the tree the JAX package's `convert_*_checkpoint` gives (through
orbax) on tiny reference-shaped checkpoints, and that checkpoint, read
by each package, gives byte-equal netlists in JAX's CircuitAnalyzerTPU
and the port's CircuitAnalyzerTorch (float32, JAX at the highest matmul
precision). A bare converted SAM2 directory loads at the default
SAM2Config(), as in the JAX CLI.
"""

import jax
import ml_dtypes
import numpy as np
import pytest
import tensorstore as ts
import torch

import circuitvision_tpu.core.config as jconfig
from circuitvision_tpu.core.config import DetectorConfig as JDet
from circuitvision_tpu.core.config import PipelineConfig as JPipe
from circuitvision_tpu.models import checkpoint as jckpt
from circuitvision_tpu.models.sam2 import convert as jsam2_convert
from circuitvision_tpu.models.sam2.wrapper import SAM2ImageSegmenter as JSAM2
from circuitvision_tpu.models.sam2.wrapper import init_params as jsam2_init
from circuitvision_tpu.models.yolo import convert as jyolo_convert
from circuitvision_tpu.models.yolo.model import YOLOv11 as JYOLO
from circuitvision_tpu.models.yolo.model import init_params as jyolo_init
from circuitvision_tpu.pipeline.analyzer import CircuitAnalyzerTPU
from circuitvision_tpu_torch import cli
from circuitvision_tpu_torch.core import config as tconfig
from circuitvision_tpu_torch.io import zstd
from circuitvision_tpu_torch.models import bridge
from circuitvision_tpu_torch.models import checkpoint as pc
from circuitvision_tpu_torch.models import checkpoint_writer as pw
from circuitvision_tpu_torch.pipeline.analyzer import CircuitAnalyzerTorch

from .test_torch_port_batch import CIRCUITS
from .test_torch_port_convert import (TINY_SAM, TINY_TARGETS, one_torch_thread,  # noqa: F401
                                      peft_checkpoint, ultralytics_checkpoint)

TINY_DET = dict(scale="n", img_size=128, num_classes=62)
#: the config classes, before a test points a converter's SAM2Config()
#: at TINY_SAM
_PORT_SAM2, _JAX_SAM2 = tconfig.SAM2Config, jconfig.SAM2Config


def _leaves(tree):
    return dict(bridge.flatten(tree))


def _same_trees(got, want):
    got, want = _leaves(got), _leaves(want)
    assert got.keys() == want.keys()
    for k, w in want.items():
        g, w = np.asarray(got[k]), np.asarray(w)
        assert (g.dtype, g.shape) == (w.dtype, w.shape), k
        assert g.tobytes() == w.tobytes(), k


def _tree():
    """Every dtype the reader takes, 0-d leaves, nesting, an array of
    several chunks with a partial edge chunk, and one of a zero extent."""
    rng = np.random.default_rng(0)
    big_rows = pw.CHUNK_BYTES // (4 * 1000) + 37
    return {
        "params": {"conv": {"kernel": rng.standard_normal((3, 3, 4, 8)).astype(np.float32),
                            "bias": rng.standard_normal(8).astype(np.float64)},
                   "big": rng.standard_normal((big_rows, 1000)).astype(np.float32)},
        "stats": {"count": np.int32(7), "steps": np.arange(5, dtype=np.int64),
                  "scale": np.float64(2.5), "empty": np.zeros((0, 3), np.float32)},
        "misc": {"u8": rng.integers(0, 255, (4, 5), dtype=np.uint8),
                 "flags": np.array([True, False, True]),
                 "i32": np.arange(-6, 6, dtype=np.int32).reshape(3, 4)},
    }


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    path = tmp_path_factory.mktemp("w") / "ckpt"
    tree = _tree()
    pw.save_model_checkpoint(str(path), tree, {"kind": "test", "n": [1, 2]})
    return path, tree


# ------------------------------------------------------------------ writer
def test_big_array_spans_several_chunks(written):
    path, tree = written
    store = pc.OcdbtStore(str(path / "variables"))
    chunks = [k for k in store.keys() if k.startswith(b"params.big/") and b".zarray" not in k]
    assert len(chunks) == 2, chunks
    assert pw.chunk_shape(tree["params"]["big"].shape, 4)[0] < tree["params"]["big"].shape[0]


@pytest.mark.parametrize("reader", ["port", "orbax", "orbax_model", "tensorstore"])
def test_written_tree_reads_back_equal(written, reader):
    path, tree = written
    if reader == "port":
        got, meta = pc.load_model_checkpoint(str(path))
        assert meta == {"kind": "test", "n": [1, 2]}
    elif reader == "orbax":
        got = jckpt.load_variables(str(path / "variables"))
    elif reader == "orbax_model":
        got, meta = jckpt.load_model_checkpoint(str(path))
        assert meta == {"kind": "test", "n": [1, 2]}
    else:
        base = {"driver": "ocdbt", "base": f"file://{path / 'variables'}/"}
        got = bridge.nest(
            (p, ts.open({"driver": "zarr", "kvstore": base, "path": ".".join(p)}).result()
             .read().result()) for p, _ in bridge.flatten(tree))
        kv = ts.KvStore.open(base).result()
        store = pc.OcdbtStore(str(path / "variables"))
        keys = sorted(kv.list().result())
        assert store.keys() == keys
        assert all(store.get(k) == kv.read(k).result().value for k in keys)
    _same_trees(jax.tree.map(np.asarray, got), tree)


@pytest.mark.parametrize("leaf", ["bfloat16", "object", "structured", "tensor"])
def test_unreadable_leaves_are_refused_by_name(tmp_path, leaf):
    value = {"bfloat16": np.ones(3, ml_dtypes.bfloat16),
             "object": np.array([None, 1], object),
             "structured": np.zeros(2, [("a", "<f4"), ("b", "<i4")]),
             "tensor": torch.ones(3)}[leaf]
    with pytest.raises(pc.CheckpointFormatError, match="params/odd"):
        pw.save_variables(str(tmp_path / "c"), {"params": {"ok": np.ones(2), "odd": value}})
    assert not any(tmp_path.iterdir())


def test_replaces_a_checkpoint_and_refuses_other_directories(tmp_path):
    pw.save_variables(str(tmp_path / "c"), {"a": np.ones(2, np.float32)})
    pw.save_variables(str(tmp_path / "c"), {"b": np.zeros(3, np.int64)})
    _same_trees(pc.load_variables(str(tmp_path / "c")), {"b": np.zeros(3, np.int64)})
    (tmp_path / "other").mkdir()
    (tmp_path / "other" / "notes.txt").write_text("keep")
    with pytest.raises(FileExistsError):
        pw.save_variables(str(tmp_path / "other"), {"a": np.ones(2)})
    assert (tmp_path / "other" / "notes.txt").read_text() == "keep"


def test_zstd_compress_round_trips():
    data = np.random.default_rng(1).standard_normal(100_000).astype(np.float32).tobytes()
    for blob in (b"", b"x" * 5000, data):
        frame = zstd.compress(blob)
        assert frame[:4] == b"\x28\xb5\x2f\xfd" and zstd.decompress(frame) == blob


# --------------------------------------------------------- the converters
@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    """Tiny reference-shaped checkpoints (an ultralytics YOLOv11-n, 62
    classes; a PEFT SAM2 at TINY_SAM with the 36 tiny-mapped LoRA
    targets) as torch files, converted by the port's command line and
    by the JAX package's converters. SAM2's converters
    take SAM2Config() (SAM2.1-L); both packages' are pointed at TINY_SAM
    here."""
    d = tmp_path_factory.mktemp("conv")
    yv = jax.tree.map(np.asarray, jyolo_init(JYOLO(num_classes=62, scale="n"),
                                             jax.random.PRNGKey(5), img_size=128))
    sv = jax.tree.map(np.asarray, jsam2_init(JSAM2(cfg=jconfig.SAM2Config(**TINY_SAM)),
                                             jax.random.PRNGKey(6)))
    yck = ultralytics_checkpoint(jyolo_convert.export_torch_state(yv))
    sck, loras = peft_checkpoint(jsam2_convert.export_torch_state(sv), TINY_TARGETS,
                                 np.random.default_rng(3))
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in yck.items()}, d / "best.pt")
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in sck.items()}, d / "sam.pth")
    assert pc.main(["convert-yolo", str(d / "best.pt"), str(d / "yolo"), "--scale", "n",
                    "--num-classes", "62", "--img-size", "128"]) == 0
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tconfig, "SAM2Config", lambda: _PORT_SAM2(**TINY_SAM))
        mp.setattr(jconfig, "SAM2Config", lambda: _JAX_SAM2(**TINY_SAM))
        assert pc.main(["convert-sam2", str(d / "sam.pth"), str(d / "sam2"),
                        "--lora-alpha", "16"]) == 0
        jckpt.convert_sam2_checkpoint(str(d / "sam.pth"), str(d / "jsam2"), lora_alpha=16.0)
    jckpt.convert_yolo_checkpoint(str(d / "best.pt"), str(d / "jyolo"), scale="n",
                                  num_classes=62, img_size=128)
    return d, len(loras)


@pytest.mark.parametrize("kind", ["yolo", "sam2"])
def test_cli_converts_as_jax(converted, kind):
    """The port's conversion, read by the port, equals the JAX package's
    conversion written by orbax, read by the port: bare directories of
    float32 leaves."""
    d, n_loras = converted
    assert n_loras == 36
    assert not (d / kind / "meta.json").exists()
    _same_trees(pc.load_variables(str(d / kind)), pc.load_variables(str(d / f"j{kind}")))


class _DetectionModel(torch.nn.Module):
    """A stand-in for the model object an ultralytics best.pt pickles
    under 'model': a module tree whose state dict has the given keys."""

    def __init__(self, state):
        super().__init__()
        for key, val in state.items():
            *path, leaf = key.split(".")
            mod = self
            for name in path:
                if name not in mod._modules:
                    mod.add_module(name, torch.nn.Module())
                mod = mod._modules[name]
            mod.register_buffer(leaf, val)


def test_cli_converts_a_pickled_half_precision_model(converted, tmp_path, capsys):
    """An ultralytics best.pt holds the detection model object, in half
    precision, under 'model' (unpickling a real one needs the
    `ultralytics` package importable). The port converts its state dict
    to the tree JAX's converter gives, float32."""
    d, _ = converted
    flat = torch.load(d / "best.pt")
    state = {k.removeprefix("model."): v.half() if v.is_floating_point() else v
             for k, v in flat.items()}
    torch.save({"model": _DetectionModel(state), "epoch": 3}, tmp_path / "best.pt")
    assert pc.main(["convert-yolo", str(tmp_path / "best.pt"), str(tmp_path / "yolo"),
                    "--scale", "n", "--num-classes", "62", "--img-size", "128"]) == 0
    assert "s to write" in capsys.readouterr().out
    jckpt.convert_yolo_checkpoint(str(tmp_path / "best.pt"), str(tmp_path / "jyolo"),
                                  scale="n", num_classes=62, img_size=128)
    got = pc.load_variables(str(tmp_path / "yolo"))
    _same_trees(got, pc.load_variables(str(tmp_path / "jyolo")))
    kernel = got["params"]["b0"]["conv"]["kernel"]
    assert kernel.dtype == np.float32
    np.testing.assert_array_equal(
        kernel, state["model.0.conv.weight"].float().numpy().transpose(2, 3, 1, 0))


def test_cli_refusals(converted, capsys):
    d, _ = converted
    assert pc.main(["convert-yolo", str(d / "best.pt"), str(d / "x"), "--depth", "2"]) == 1
    assert "unknown argument '--depth'" in capsys.readouterr().out
    assert pc.main(["convert-sam2", "only-one"]) == 1
    assert "convert-yolo" in capsys.readouterr().out
    with pytest.raises(FileNotFoundError, match="no checkpoint tensors found at"):
        pc.main(["convert-paligemma", str(d), str(d / "p")])
    assert "converted" not in capsys.readouterr().out
    assert not (d / "x").exists() and not (d / "p").exists()


def test_bare_sam2_directory_takes_the_default_config():
    """A bare orbax directory has meta {}: the JAX CLI builds SAM2Config()
    for it, and so does the port (bridge.sam2_config raised KeyError)."""
    assert bridge.sam2_config({}) == tconfig.SAM2Config()
    assert bridge.sam2_config({}, "float32") == tconfig.SAM2Config(dtype="float32")


def _summary(r):
    boxes = [(b.class_name, b.class_id, b.xmin, b.ymin, b.xmax, b.ymax) for b in r.bboxes_orig_nms]
    nodes = [(n.id, n.centroid, [c.persistent_uid for c in n.components]) for n in r.nodes]
    return boxes, nodes, r.netlist_text


def test_converted_checkpoint_gives_equal_netlists(converted):
    """The port-converted checkpoints, read by orbax into JAX's analyzer
    and by the port's reader into the port's, float32: the same boxes,
    nodes and netlist text on the drawn schematics."""
    d, _ = converted
    yv, sv = jckpt.load_variables(str(d / "yolo")), jckpt.load_variables(str(d / "sam2"))
    jcfg = JPipe(detector=JDet(**TINY_DET, dtype="float32"),
                 sam2=jconfig.SAM2Config(**TINY_SAM))
    tcfg = tconfig.PipelineConfig(detector=tconfig.DetectorConfig(**TINY_DET, dtype="float32"),
                                  sam2=tconfig.SAM2Config(**TINY_SAM))
    with jax.default_matmul_precision("highest"):
        ja = CircuitAnalyzerTPU(config=jcfg, yolo_variables=yv, sam2_variables=sv,
                                vlm_client=None)
        ja.vlm_client = None
        ta = CircuitAnalyzerTorch(
            tcfg, bridge.state_dict_from_variables(pc.load_variables(str(d / "yolo"))),
            bridge.state_dict_from_variables(pc.load_variables(str(d / "sam2"))), device="cpu")
        got = [_summary(ta.analyze(img)) for img, _boxes in CIRCUITS]
        assert got == [_summary(ja.analyze(img)) for img, _boxes in CIRCUITS]
    assert all(boxes for boxes, _nodes, _text in got) and any(text for *_, text in got)


def test_cli_loads_bare_converted_directories(converted, tmp_path, monkeypatch, capsys):
    """`cli analyze-batch --yolo-checkpoint D/yolo --sam2-checkpoint D/sam2`
    on bare converted directories: the detector from the flags (n@128),
    SAM2 at the default config (pointed at TINY_SAM here); the netlists
    are those of the same analyzer built in process."""
    import cv2

    d, _ = converted
    monkeypatch.setenv("CIRCUITVISION_VLM", "")
    monkeypatch.setattr(bridge, "SAM2Config", lambda **kw: _PORT_SAM2(**{**TINY_SAM, **kw}))
    (tmp_path / "imgs").mkdir()
    for i, (img, _boxes) in enumerate(CIRCUITS):
        cv2.imwrite(str(tmp_path / "imgs" / f"c{i}.png"), cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
    assert cli.main(["analyze-batch", str(tmp_path / "imgs"), "--device", "cpu", "--scale", "n",
                     "--det-size", "128", "--yolo-checkpoint", str(d / "yolo"),
                     "--sam2-checkpoint", str(d / "sam2"), "--out-dir",
                     str(tmp_path / "out")]) == 0
    capsys.readouterr()
    cfg = tconfig.PipelineConfig(detector=tconfig.DetectorConfig(scale="n", img_size=128),
                                 sam2=_PORT_SAM2(**TINY_SAM))
    ta = CircuitAnalyzerTorch(
        cfg, bridge.state_dict_from_variables(pc.load_variables(str(d / "yolo"))),
        bridge.state_dict_from_variables(pc.load_variables(str(d / "sam2"))), device="cpu")
    from circuitvision_tpu_torch.io.image_io import load_image

    images = [load_image(str(tmp_path / "imgs" / f"c{i}.png")) for i in range(len(CIRCUITS))]
    for i, want in enumerate(ta.analyze_batch(images)):
        assert (tmp_path / "out" / f"c{i}.cir").read_text() == want.netlist_text + "\n"
