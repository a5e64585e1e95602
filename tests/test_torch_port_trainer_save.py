"""The port's trainers write what both packages load, on the CPU:
scripts/torch_train_detector.py --save and torch_train_segmenter.py
--save write the JAX trainers' model checkpoints (orbax variables +
meta.json, the meta their JAX scripts write), torch_train_reader.py
--out a bare orbax directory; JAX's orbax loader reads each at flax
init's paths and shapes, equal to the port's reader.
"""
import dataclasses
import importlib.util
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import circuitvision_tpu.core.config as jconfig
from circuitvision_tpu.models import checkpoint as jckpt
from circuitvision_tpu.models.sam2.wrapper import SAM2ImageSegmenter as JSAM2
from circuitvision_tpu.train.reader import ReaderConfig as JReaderConfig
from circuitvision_tpu.train.reader import init_reader as jreader_init
from circuitvision_tpu_torch.core import config as tconfig
from circuitvision_tpu_torch.models import bridge
from circuitvision_tpu_torch.models import checkpoint as pc
from circuitvision_tpu_torch.models.yolo.model import YOLOv11

from .test_torch_port_ckpt_write import _leaves, _same_trees
from .test_torch_port_convert import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]


def _script(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    """A 4-item pool written by scripts/torch_gen_pool.py."""
    d = tmp_path_factory.mktemp("pool")
    assert _script("torch_gen_pool").main(["--out", str(d / "pool"), "--n", "4"]) == 0
    return d / "pool"


def _shapes(tree):
    return {k: tuple(np.shape(v)) for k, v in _leaves(tree).items()}


def test_detector_trainer_writes_what_jax_loads(pool, tmp_path):
    """scripts/torch_train_detector.py --save, 2 steps of YOLOv11-n@64:
    JAX's load_model_checkpoint reads the meta scripts/train_detector.py
    writes and the variables the port's reader gives, at the variable
    tree's paths and shapes (`bridge.variables_template`, held to flax
    init in tests/test_torch_port_convert.py)."""
    assert _script("torch_train_detector").main(
        ["--pool", str(pool), "--steps", "2", "--batch", "2", "--img-size", "64", "--scale", "n",
         "--warmup-steps", "1", "--val-n", "1", "--log-every", "1", "--eval-every", "0",
         "--save", str(tmp_path / "det"), "--ckpt-dir", "", "--device", "cpu"]) == 0
    variables, meta = jckpt.load_model_checkpoint(str(tmp_path / "det"))
    map50 = meta["train"].pop("map50_holdout")
    assert isinstance(map50, float) and 0.0 <= map50 <= 1.0
    assert meta == {"kind": "yolo",
                    "detector": {"scale": "n", "img_size": 64, "num_classes": 64, "reg_max": 16},
                    "train": {"steps": 2, "batch": 2, "pool": "pool"}}
    port_vars, port_meta = pc.load_model_checkpoint(str(tmp_path / "det"))
    assert port_meta["train"]["map50_holdout"] == map50
    _same_trees(jax.tree.map(np.asarray, variables), port_vars)
    with torch.device("meta"):
        template = bridge.variables_template(YOLOv11(64, "n"))
    assert _shapes(port_vars) == _shapes(template)


def test_reader_trainer_writes_what_jax_loads(tmp_path):
    """scripts/torch_train_reader.py --out, 2 steps: a bare orbax
    directory that JAX's load_variables reads at flax init's paths and
    shapes, equal to the port's reading."""
    assert _script("torch_train_reader").main(
        ["--steps", "2", "--batch", "8", "--train-circuits", "1", "--val-circuits", "1",
         "--log-every", "1", "--out", str(tmp_path / "reader"), "--device", "cpu"]) == 0
    reader = jax.tree.map(np.asarray, jckpt.load_variables(str(tmp_path / "reader")))
    _same_trees(reader, pc.load_variables(str(tmp_path / "reader")))
    assert _shapes(reader) == _shapes(
        jax.eval_shape(lambda: jreader_init(JReaderConfig(), jax.random.PRNGKey(0))))


def test_segmenter_trainer_writes_what_jax_loads(pool, tmp_path):
    """scripts/torch_train_segmenter.py --save, 2 steps of Hiera-t@64,
    then a run that resumes from its train state: ckpt/sam2's layout, which JAX's load_model_checkpoint
    reads, the "sam2" preset giving flax init's paths and shapes; the
    resized pool cache is the one the JAX script reads."""
    seg = _script("torch_train_segmenter")
    args = ["--pool", str(pool), "--batch", "2", "--res", "64", "--arch", "t",
            "--warmup-steps", "1", "--val-n", "1", "--log-every", "1", "--eval-every", "0",
            "--save", str(tmp_path / "sam2"), "--ckpt-dir", str(tmp_path / "run"),
            "--save-every", "1", "--device", "cpu"]
    assert seg.main(["--steps", "2", *args]) == 0
    assert seg.main(["--steps", "2", *args]) == 0  # resumes at step 2, saves again
    variables, meta = jckpt.load_model_checkpoint(str(tmp_path / "sam2"))
    iou_holdout = meta["train"].pop("iou_holdout")
    assert isinstance(iou_holdout, float) and 0.0 <= iou_holdout <= 1.0
    want_cfg = tconfig.sam2_hiera_preset("t", resolution=64, dtype="float32")
    assert meta == {"kind": "sam2", "sam2": {"preset": "t", "overrides": {"resolution": 64}},
                    "sam2_config": json.loads(json.dumps(dataclasses.asdict(want_cfg))),
                    "train": {"steps": 2, "batch": 2, "pool": "pool"}}
    port_vars, port_meta = pc.load_model_checkpoint(str(tmp_path / "sam2"))
    assert bridge.sam2_config(port_meta) == want_cfg
    _same_trees(jax.tree.map(np.asarray, variables), port_vars)
    jcfg = jconfig.sam2_hiera_preset(meta["sam2"]["preset"], **meta["sam2"]["overrides"])
    x = jax.numpy.zeros((1, 64, 64, 3), jax.numpy.float32)
    assert _shapes(port_vars) == _shapes(
        jax.eval_shape(JSAM2(cfg=jcfg).init, jax.random.PRNGKey(0), x))
    with np.load(pool / "_seg_64_4.npz") as z:
        assert z["imgs"].shape == (4, 64, 64, 3) and z["masks"].dtype == bool
