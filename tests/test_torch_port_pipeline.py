"""The port's analyze() against CircuitAnalyzerTPU.analyze(), and the
port's import and failure guarantees.

Both sides run float32 (JAX at "highest" matmul precision) on the same
decoded eval images with the same weights carried through
models/bridge.py. What analyze() returns for the host — boxes after NMS,
crop, node graphs, netlist text — must be identical; the SAM2 mask is
compared pixel for pixel too.
"""
import dataclasses
import glob
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import cv2
import jax
import numpy as np
import pytest
import torch

from circuitvision_tpu.core.config import DetectorConfig as JDet
from circuitvision_tpu.core.config import PipelineConfig as JPipe
from circuitvision_tpu.core.config import SAM2Config as JSAM2Config
from circuitvision_tpu.models.sam2.wrapper import SAM2ImageSegmenter as JSAM2
from circuitvision_tpu.models.sam2.wrapper import init_params as jsam2_init
from circuitvision_tpu.models.yolo.model import YOLOv11 as JYOLO
from circuitvision_tpu.models.yolo.model import init_params as jyolo_init
from circuitvision_tpu.pipeline.analyzer import CircuitAnalyzerTPU
from circuitvision_tpu_torch.core import config as tconfig
from circuitvision_tpu_torch.models import bridge
from circuitvision_tpu_torch.ops.cuda.build import KernelError
from circuitvision_tpu_torch.pipeline import analyzer as tanalyzer
from circuitvision_tpu_torch.pipeline.analyzer import CircuitAnalyzerTorch

ROOT = Path(__file__).resolve().parents[1]
IMAGES = sorted(glob.glob(str(ROOT / "eval_data" / "images" / "*.png")))
PICK = [IMAGES[i] for i in (0, 20, 40)]
TINY_SAM2 = dict(resolution=128, embed_dim=16, num_heads=1, stages=(1, 2, 3, 1),
                 global_att_blocks=(5,), window_spec=(4, 2, 6, 2),
                 backbone_channel_list=(128, 64, 32, 16), d_model=32, decoder_mlp_dim=64,
                 iou_head_hidden_dim=32, dtype="float32")
TINY_DET = dict(scale="n", img_size=128, num_classes=64, dtype="float32")
#: |logit − threshold| below which a float32 SAM2 mask pixel may differ
#: between the packages (15× the largest logit difference seen)
LOGIT_FLIP_BOUND = 1e-3
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "tensorstore", "cv2", "PIL",
             "safetensors", "transformers", "matplotlib", "circuitvision_tpu")


@pytest.fixture(autouse=True)
def _exact_matmuls():
    with jax.default_matmul_precision("highest"):
        yield


def _rgb(path):
    return cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)


def _summary(r):
    boxes = [(b.class_name, b.class_id, b.xmin, b.ymin, b.xmax, b.ymax) for b in r.bboxes_orig_nms]
    nodes = [(n.id, n.centroid, [c.persistent_uid for c in n.components]) for n in r.nodes]
    return boxes, nodes, r.netlist_text, r.valueless_netlist_text_no_vlm_dir


def _compare(ja, ta, paths):
    for path in paths:
        img = _rgb(path)
        ref, got = ja.analyze(img), ta.analyze(img)
        assert dataclasses.asdict(got.crop_info) == dataclasses.asdict(ref.crop_info), path
        assert _summary(got) == _summary(ref), path
        assert [b.visual_id for b in got.enum_bboxes] == [b.visual_id for b in ref.enum_bboxes]
        if ref.sam_mask is not None:
            np.testing.assert_array_equal(got.sam_mask, ref.sam_mask)


@pytest.fixture(scope="module")
def tiny_pair():
    jcfg = JPipe(detector=JDet(**TINY_DET), sam2=JSAM2Config(**TINY_SAM2))
    tcfg = tconfig.PipelineConfig(detector=tconfig.DetectorConfig(**TINY_DET),
                                  sam2=tconfig.SAM2Config(**TINY_SAM2))
    yv = jax.tree.map(np.asarray, jyolo_init(JYOLO(num_classes=64, scale="n"),
                                             jax.random.PRNGKey(0), img_size=128))
    sv = jax.tree.map(np.asarray, jsam2_init(JSAM2(cfg=jcfg.sam2), jax.random.PRNGKey(1)))
    return jcfg, tcfg, yv, sv


def test_whole_slice_tiny_config(tiny_pair):
    jcfg, tcfg, yv, sv = tiny_pair
    ja = CircuitAnalyzerTPU(config=jcfg, yolo_variables=yv, sam2_variables=sv, vlm_client=None)
    ja.vlm_client = None
    ta = CircuitAnalyzerTorch(tcfg, bridge.state_dict_from_variables(yv),
                              bridge.state_dict_from_variables(sv), device="cpu")
    _compare(ja, ta, PICK)


def test_whole_slice_tiny_config_classical_mask(tiny_pair):
    """Without SAM2 weights both packages take the classical mask."""
    jcfg, tcfg, yv, _sv = tiny_pair
    ja = CircuitAnalyzerTPU(config=jcfg, yolo_variables=yv, use_sam2=False, vlm_client=None)
    ja.vlm_client = None
    ta = CircuitAnalyzerTorch(tcfg, bridge.state_dict_from_variables(yv), None, device="cpu")
    _compare(ja, ta, PICK[:2])


def test_whole_slice_shipped_checkpoints():
    """ckpt/yolo (YOLOv11-s@640) and ckpt/sam2 (Hiera-t@512), loaded by
    the JAX package's orbax reader here only, carried through the
    bridge; float32 on both sides (about 35 s on the CPU, JAX compiles
    included). A SAM2 mask pixel may differ between the packages only
    where the logit lies within LOGIT_FLIP_BOUND of the threshold: the
    two logit maps differ by at most 6.5e-5 on these images (none of
    their pixels differed when this was written)."""
    from circuitvision_tpu.core.config import sam2_hiera_preset
    from circuitvision_tpu.models.checkpoint import load_model_checkpoint

    yv, ymeta = load_model_checkpoint(str(ROOT / "ckpt" / "yolo"))
    sv, smeta = load_model_checkpoint(str(ROOT / "ckpt" / "sam2"))
    yv, sv = jax.tree.map(np.asarray, yv), jax.tree.map(np.asarray, sv)
    d, s = ymeta["detector"], smeta["sam2"]
    jcfg = JPipe(detector=JDet(scale=d["scale"], img_size=d["img_size"], num_classes=d["num_classes"],
                               reg_max=d["reg_max"], dtype="float32"),
                 sam2=sam2_hiera_preset(s["preset"], dtype="float32", **s["overrides"]))
    tcfg = tconfig.PipelineConfig(
        detector=dataclasses.replace(bridge.detector_config(ymeta), dtype="float32"),
        sam2=bridge.sam2_config(smeta, dtype="float32"))
    ja = CircuitAnalyzerTPU(config=jcfg, yolo_variables=yv, sam2_variables=sv, vlm_client=None)
    ja.vlm_client = None
    ta = CircuitAnalyzerTorch(tcfg, bridge.state_dict_from_variables(yv),
                              bridge.state_dict_from_variables(sv), device="cpu")
    paths = [str(ROOT / "eval_data" / "images" / f"{n}.png") for n in ("golden", "loop", "ac_rc")]
    for path in paths:
        ref, got = ja.analyze(_rgb(path)), ta.analyze(_rgb(path))
        assert _summary(got) == _summary(ref), path
        assert ref.nodes and ref.netlist_text, path
        assert np.mean(got.sam_mask == ref.sam_mask) > 0.999, path
        flipped = got.sam_mask != ref.sam_mask
        if flipped.any():
            logits = ta.segment_logits(got.image_for_analysis).numpy()
            margin = np.abs(logits[flipped] - tcfg.sam2.mask_threshold).max()
            assert margin < LOGIT_FLIP_BOUND, (path, int(flipped.sum()), margin)


# ------------------------------------------------------------------ guards
def test_tiny_analyze_imports_no_jax_cv2_or_reference_package(tmp_path):
    """In a fresh interpreter: import the port, read ckpt/reader and an
    eval PNG with the port's own readers, run a tiny CPU analyze() with
    the trained reader as its client and the final netlist, and
    analyze_batch() (BatchedPipeline.analyze_many, with the
    fused-morphology switch on, finalize=True), simulate(), the serving
    executor and HTTP server, the CLI's simulate, a selective and a LoRA
    fine-tune step on a batch of the folder dataset and a train
    checkpoint, and find no module named
    exactly jax, flax, optax, orbax, tensorstore, cv2, PIL, matplotlib, ... or the JAX
    package, nor any submodule of them (names compared exactly, since
    circuitvision_tpu is a prefix of circuitvision_tpu_torch)."""
    code = f"""
import sys, json
sys.path.insert(0, {str(ROOT)!r})
import numpy as np
import circuitvision_tpu_torch
from circuitvision_tpu_torch.core.config import PipelineConfig, DetectorConfig, SAM2Config
from circuitvision_tpu_torch.models.sam2.wrapper import SAM2ImageSegmenter
from circuitvision_tpu_torch.models.yolo.model import YOLOv11
from circuitvision_tpu_torch.pipeline.analyzer import CircuitAnalyzerTorch
from circuitvision_tpu_torch.core.config import TopologyConfig
from circuitvision_tpu_torch.enrich.trained_reader import load_trained_reader
from circuitvision_tpu_torch.eval.metrics import netlist_exact_match
from circuitvision_tpu_torch.io.image_io import load_image
cfg = PipelineConfig(detector=DetectorConfig(**{TINY_DET!r}), sam2=SAM2Config(**{TINY_SAM2!r}),
                     topology=TopologyConfig(use_fused_morphology=True))
ys = YOLOv11(64, "n").state_dict()
ss = SAM2ImageSegmenter(cfg.sam2).state_dict()
img = load_image({str(ROOT / "eval_data" / "images" / "ac_rc.png")!r})
reader = load_trained_reader({str(ROOT / "ckpt" / "reader")!r}, device="cpu")
a = CircuitAnalyzerTorch(cfg, ys, ss, device="cpu", vlm_client=reader)
r = a.generate_final_netlist(a.analyze(img))
rs = a.analyze_batch([img, img[:100]], batch_size=1, finalize=True)
assert len(rs) == 2
netlist_exact_match([x.netlist_text for x in rs], [r.netlist_text] * 2)
# simulation (the native solver, g++ at first use), the server, the CLI
from circuitvision_tpu_torch import cli
from circuitvision_tpu_torch.pipeline.batch import BatchedPipeline
from circuitvision_tpu_torch.pipeline.server import BatchingExecutor, make_server
a.simulate(r)
with BatchingExecutor(BatchedPipeline(a, batch_size=2), final=True) as ex:
    server = make_server(ex, port=0)
    assert ex.map([img])[0].netlist_text == r.netlist_text
    server.server_close()
assert cli.main(["simulate", {str(ROOT / "eval_data" / "netlists" / "golden.cir")!r}]) == 0
# the web UI with its drawings, JPEG input, the FLOP count
from circuitvision_tpu_torch import webapp
from circuitvision_tpu_torch.models import flops
webapp.make_server(a, port=0, host="127.0.0.1").server_close()
json.dumps(webapp.analysis_json(r, img))
load_image({str(ROOT / "eval_data" / "image_fixtures" / "progressive.jpg")!r})
assert flops.sam2_forward_flops(cfg.sam2) > 0
# the fine-tune: dataset, a selective and a LoRA step, a checkpoint
import torch
from circuitvision_tpu_torch.core.config import TrainConfig
from circuitvision_tpu_torch.train import checkpoint, lora, train_step
from circuitvision_tpu_torch.train.data import SegmentationFolderDataset
ds = SegmentationFolderDataset({str(ROOT / "eval_data")!r}, resolution=128, device="cpu")
images, masks = next(ds.batches(1, seed=0))
model = SAM2ImageSegmenter(cfg.sam2)
params = {{n: p.detach() for n, p in model.named_parameters()}}
tcfg = TrainConfig(grad_accum_steps=2, schedule="cosine", total_steps=3)
opt, mask = train_step.make_optimizer(model, tcfg)
state = opt.init(params)
params, state, metrics = train_step.make_train_step(model, opt, tcfg, mask)(params, state,
                                                                           images, masks)
tstate = lora.init_train_state(model, torch.Generator().manual_seed(0), tcfg, 7)
lopt = lora.make_lora_optimizer(tcfg)
lora.make_lora_train_step(model, lopt, tcfg)(params, tstate, lopt.init(lora.flat_names(tstate)),
                                             images, masks)
checkpoint.save_train_state({str(tmp_path / "ckpt")!r}, 1, params, state)
print(json.dumps(sorted(sys.modules)))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=tmp_path, env={**os.environ, "PYTHONPATH": ""}, timeout=300)
    assert out.returncode == 0, out.stderr
    mods = json.loads(out.stdout.strip().splitlines()[-1])
    for m in ("pipeline.analyzer", "pipeline.batch", "ops.cuda.morphology", "ops.cuda.fused_ln",
              "io.zstd", "io.image_io", "models.checkpoint", "models.reader",
              "enrich.trained_reader", "enrich.directions", "enrich.client", "netlist.fix",
              "eval.metrics", "train.losses", "train.train_step", "train.lora",
              "train.checkpoint", "train.data", "cli", "pipeline.server", "netlist.values",
              "sim.engine", "sim.mna", "sim.netlist_parse", "sim.native_backend",
              "webapp", "models.flops", "core.draw", "core.hershey", "core.viz"):
        assert "circuitvision_tpu_torch." + m in mods
    bad = [m for m in mods if m in FORBIDDEN or m.startswith(tuple(f + "." for f in FORBIDDEN))]
    assert not bad, bad


def test_port_sources_name_no_jax_or_reference_import():
    pat = re.compile(r"import jax|from circuitvision_tpu\.|import circuitvision_tpu\b|cpp_extension"
                     r"|import (flax|optax|orbax|tensorstore|cv2|PIL|safetensors|transformers"
                     r"|matplotlib)\b"
                     r"|from (jax|flax|optax|orbax|tensorstore|cv2|PIL|safetensors|transformers"
                     r"|matplotlib)\b")
    files = list((ROOT / "circuitvision_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    hits = [f"{f}:{i}" for f in files for i, line in enumerate(f.read_text().splitlines(), 1)
            if pat.search(line)]
    assert not hits, hits


# ------------------------------------------------------- device and ladders
def test_cuda_requested_without_cuda_raises(tiny_pair):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    _jcfg, tcfg, yv, _sv = tiny_pair
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        CircuitAnalyzerTorch(tcfg, bridge.state_dict_from_variables(yv), None)


@pytest.fixture()
def tiny_port(tiny_pair):
    _jcfg, tcfg, yv, sv = tiny_pair
    return CircuitAnalyzerTorch(tcfg, bridge.state_dict_from_variables(yv),
                                bridge.state_dict_from_variables(sv), device="cpu")


def test_node_ladder_reraises_kernel_and_cuda_faults(tiny_port, monkeypatch):
    img = _rgb(PICK[0])
    for exc in (KernelError("launch failed"), RuntimeError("CUDA error: an illegal memory access")):
        def boom(*a, _exc=exc, **k):
            raise _exc
        monkeypatch.setattr(tanalyzer, "extract_nodes", boom)
        with pytest.raises(type(exc)):
            tiny_port.analyze(img)


def test_node_ladder_keeps_going_on_data_errors(tiny_port, monkeypatch):
    def boom(*a, **k):
        raise ValueError("degenerate raster")
    monkeypatch.setattr(tanalyzer, "extract_nodes", boom)
    r = tiny_port.analyze(_rgb(PICK[0]))
    assert r.nodes == [] and r.node_mask is None
    assert r.netlist_text == r.valueless_netlist_text  # components-only fallback


def test_sam2_failure_is_an_error_not_a_classical_mask(tiny_port, monkeypatch):
    def boom(*a, **k):
        raise ValueError("segmenter failed")
    monkeypatch.setattr(tiny_port, "segment_logits", boom)
    with pytest.raises(ValueError, match="segmenter failed"):
        tiny_port.analyze(_rgb(PICK[0]))
