"""The port's eval scripts against the JAX package's on the CPU:

  * scripts/torch_eval_pipeline.py's report against scripts/
    eval_pipeline.py's run_eval on the first four eval images with
    --oracle-boxes --classical-mask, clean and at one --degrade tier (the
    geometric one, which warps the boxes and masks), and both scripts'
    printed JSON with --degrade all on one image;
  * scripts/torch_eval_detector.py's AP@50 table against scripts/
    eval_detector.py's for a seeded YOLOv11-n@64 checkpoint (written by
    the port's orbax writer, read by each package's own reader) on a
    tiny seeded pool (written by the port's eval/pool.py, letterboxed
    by each script's own loader).
"""
import argparse
import importlib.util
import json
import shutil
import sys
from pathlib import Path

import jax
import pytest
import torch

from circuitvision_tpu_torch.eval import pool
from circuitvision_tpu_torch.models import bridge
from circuitvision_tpu_torch.models.checkpoint_writer import save_model_checkpoint
from circuitvision_tpu_torch.models.yolo.model import YOLOv11

ROOT = Path(__file__).resolve().parents[1]
DATA = str(ROOT / "eval_data")


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


def _script(name):
    spec = importlib.util.spec_from_file_location(f"_script_{name}",
                                                  ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def scripts():
    return {n: _script(n) for n in ("eval_pipeline", "torch_eval_pipeline")}


def _args(**kw):
    base = dict(data=DATA, yolo_checkpoint=None, sam2_checkpoint=None, scale="n", det_size=64,
                limit=4, oracle_boxes=True, classical_mask=True, vlm=None, degrade=None,
                out=None)
    return argparse.Namespace(**{**base, **kw})


@pytest.mark.parametrize("tier", [None, "perspective"])
def test_eval_pipeline_report_equals_jax(scripts, tier):
    want = scripts["eval_pipeline"].run_eval(_args(), degrade_tier=tier)
    got = scripts["torch_eval_pipeline"].run_eval(_args(device="cpu"), degrade_tier=tier)
    assert got == want
    assert got["images"] == 4 and got["segmentation"] and "netlist_exact_match" in got


def test_eval_pipeline_degrade_all_prints_jax_json(scripts, capsys, tmp_path):
    argv = ["--data", DATA, "--oracle-boxes", "--classical-mask", "--scale", "n",
            "--det-size", "64", "--limit", "1", "--degrade", "all"]
    assert scripts["eval_pipeline"].main(argv) == 0
    want = capsys.readouterr().out
    out = tmp_path / "report.json"
    assert scripts["torch_eval_pipeline"].main(argv + ["--device", "cpu", "--out", str(out)]) == 0
    got = capsys.readouterr().out
    assert got == want
    report = json.loads(out.read_text())
    assert set(report["degraded"]) == {"blur", "jpeg", "perspective", "shadow", "wobble"}


def test_grey_mask_is_pils_luma(scripts):
    import numpy as np
    from PIL import Image

    rgb = np.random.default_rng(0).integers(0, 256, (17, 23, 4), dtype=np.uint8)
    for arr, mode in ((rgb[..., :3], "RGB"), (rgb, "RGBA"), (rgb[..., 0], "L")):
        want = np.asarray(Image.fromarray(arr, mode).convert("L"))
        assert (scripts["torch_eval_pipeline"].grey_mask(arr) == want).all(), mode


def test_eval_detector_table_equals_jax(tmp_path, monkeypatch, capsys):
    pool.write_pool(str(tmp_path / "pool"), 6, log_every=0)
    shutil.copytree(tmp_path / "pool", tmp_path / "pool_jax")
    meta = {"kind": "yolo", "detector": {"scale": "n", "img_size": 64, "num_classes": 64,
                                         "reg_max": 16}}
    state = bridge.seeded_state("yolo", meta, 5)
    with torch.device("meta"):
        model = YOLOv11(64, "n", 16)
    save_model_checkpoint(str(tmp_path / "det"), bridge.variables_from_state_dict(state, model),
                          meta=meta)
    monkeypatch.syspath_prepend(str(ROOT / "scripts"))  # it imports its sibling scripts
    jax_script = _script("eval_detector")
    monkeypatch.setattr(sys, "argv", ["eval_detector.py", "--ckpt", str(tmp_path / "det"),
                                      "--pool", str(tmp_path / "pool_jax"), "--val-n", "4"])
    jax_script.main()
    want = capsys.readouterr().out
    assert _script("torch_eval_detector").main(
        ["--ckpt", str(tmp_path / "det"), "--pool", str(tmp_path / "pool"), "--val-n", "4",
         "--batch", "3", "--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert got == want[want.index("val images:"):]
    assert "mAP@50 all:" in got and len(got.splitlines()) > 4
