"""The port's command line (`python -m circuitvision_tpu_torch.cli`) on the
CPU: the cases of tests/test_cli.py (`simulate`, `analyze-batch`), plus
`analyze` with checkpoint flags and the trained reader's value pass,
each against the same call made in process, JPEG input beside a BMP
that `analyze-batch` skips and names, and the refusals of what is not
ported (a BMP, `analyze-batch --distributed`, a PaliGemma
CIRCUITVISION_VLM). The web UI's `serve` is tested in
tests/test_torch_port_webapp.py.
"""
import cv2
import jax
import numpy as np
import pytest

from circuitvision_tpu.models.checkpoint import save_model_checkpoint
from circuitvision_tpu.models.yolo.model import YOLOv11 as JYOLO
from circuitvision_tpu.models.yolo.model import init_params as jyolo_init
from circuitvision_tpu_torch import cli
from circuitvision_tpu_torch.core import config as tconfig
from circuitvision_tpu_torch.enrich.trained_reader import load_trained_reader
from circuitvision_tpu_torch.io.image_io import load_image
from circuitvision_tpu_torch.models import bridge
from circuitvision_tpu_torch.models.checkpoint import load_model_checkpoint
from circuitvision_tpu_torch.pipeline.analyzer import CircuitAnalyzerTorch

from .test_torch_port_batch import CIRCUITS, ROOT

TINY_META = {"kind": "yolo", "detector": {"scale": "n", "img_size": 128, "num_classes": 64,
                                          "reg_max": 16}}


@pytest.fixture(autouse=True)
def _no_vlm(monkeypatch):
    monkeypatch.setenv("CIRCUITVISION_VLM", "")


@pytest.fixture(scope="module")
def drawings(tmp_path_factory):
    """The golden and loop drawings as PNG files."""
    d = tmp_path_factory.mktemp("imgs")
    for name, (img, _boxes) in zip(("golden", "loop"), CIRCUITS):
        cv2.imwrite(str(d / f"{name}.png"), cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
    return d


@pytest.fixture(scope="module")
def tiny_checkpoint(tmp_path_factory):
    """A YOLOv11-n@128 checkpoint in the JAX package's layout (orbax
    variables + meta.json), read by the port's own reader in the CLI."""
    yv = jax.tree.map(np.asarray, jyolo_init(JYOLO(num_classes=64, scale="n"),
                                             jax.random.PRNGKey(0), img_size=128))
    path = tmp_path_factory.mktemp("ckpt") / "yolo"
    save_model_checkpoint(str(path), yv, TINY_META)
    return path, yv


class TestSimulateCommand:
    def test_dc_simulate_netlist_file(self, tmp_path, capsys):
        p = tmp_path / "net.cir"
        p.write_text("V1 1 0 5\nR1 1 2 1k\nR2 2 0 1k\n")
        assert cli.main(["simulate", str(p)]) == 0
        out = capsys.readouterr().out
        assert "node voltages" in out and "2.500V" in out

    def test_ac_mode_autodetect(self, tmp_path, capsys):
        p = tmp_path / "net.cir"
        p.write_text("V1 1 0 AC 5 0\nR1 1 2 100\nC1 2 0 -j100\n")
        assert cli.main(["simulate", str(p)]) == 0
        assert "∠" in capsys.readouterr().out

    def test_bad_netlist_nonzero_exit(self, tmp_path, capsys):
        p = tmp_path / "net.cir"
        p.write_text("garbage line\n")
        assert cli.main(["simulate", str(p)]) == 1
        assert "simulation failed" in capsys.readouterr().out


class TestAnalyzeCommands:
    def test_analyze_batch_directory_to_netlists(self, drawings, tmp_path, capsys):
        """Seeded random YOLO-n@64 (no checkpoint), classical mask: the
        written netlists are analyze_batch's on the same weights."""
        out_dir = tmp_path / "netlists"
        assert cli.main(["analyze-batch", str(drawings), "--device", "cpu", "--scale", "n",
                         "--det-size", "64", "--batch-size", "8", "--out-dir",
                         str(out_dir)]) == 0
        assert sorted(p.name for p in out_dir.iterdir()) == ["golden.cir", "loop.cir"]
        assert "2 images in" in capsys.readouterr().out
        cfg = tconfig.PipelineConfig(detector=tconfig.DetectorConfig(scale="n", img_size=64),
                                     use_sam2=False)
        state = bridge.seeded_state("yolo", {"detector": {
            "scale": "n", "img_size": 64, "num_classes": 62, "reg_max": 16}}, cli.SEED)
        analyzer = CircuitAnalyzerTorch(cfg, state, None, device="cpu")
        images = [load_image(str(drawings / f"{n}.png")) for n in ("golden", "loop")]
        for name, res in zip(("golden", "loop"), analyzer.analyze_batch(images)):
            assert (out_dir / f"{name}.cir").read_text() == res.netlist_text + "\n"

    def test_no_images_errors(self, tmp_path):
        empty = tmp_path / "none"
        empty.mkdir()
        assert cli.main(["analyze-batch", str(empty), "--device", "cpu"]) == 1

    def test_analyze_with_checkpoint(self, drawings, tiny_checkpoint, tmp_path, capsys):
        """analyze --yolo-checkpoint (the meta gives n@128) --netlist
        --simulate dc: the netlist and the simulation are those of the
        same analyzer built in process."""
        path, yv = tiny_checkpoint
        image = drawings / "golden.png"
        cfg = tconfig.PipelineConfig(detector=bridge.detector_config(TINY_META),
                                     use_sam2=False)
        analyzer = CircuitAnalyzerTorch(cfg, bridge.state_dict_from_variables(yv), None,
                                        device="cpu")
        self._check(["--yolo-checkpoint", str(path)], image, analyzer, tmp_path, capsys)

    def test_analyze_final_with_the_trained_reader(self, tmp_path, capsys, monkeypatch):
        """analyze --final with CIRCUITVISION_VLM=reader:ckpt/reader and
        ckpt/yolo on an eval image (classical mask): the reader's values
        are merged as in process."""
        reader_dir = str(ROOT / "ckpt" / "reader")
        monkeypatch.setenv("CIRCUITVISION_VLM", f"reader:{reader_dir}")
        yv, ymeta = load_model_checkpoint(str(ROOT / "ckpt" / "yolo"))
        cfg = tconfig.PipelineConfig(detector=bridge.detector_config(ymeta), use_sam2=False)
        analyzer = CircuitAnalyzerTorch(cfg, bridge.state_dict_from_variables(yv), None,
                                        device="cpu",
                                        vlm_client=load_trained_reader(reader_dir, device="cpu"))
        want = self._check(["--yolo-checkpoint", str(ROOT / "ckpt" / "yolo"), "--final"],
                           ROOT / "eval_data" / "images" / "ac_rc.png", analyzer, tmp_path,
                           capsys)
        assert want.vlm_stage2_output

    @staticmethod
    def _check(flags, image, analyzer, tmp_path, capsys):
        out_file = tmp_path / "out.cir"
        assert cli.main(["analyze", str(image), "--device", "cpu", "--netlist", str(out_file),
                         "--simulate", "dc", *flags]) == 0
        out = capsys.readouterr().out
        want = analyzer.analyze(load_image(str(image)))
        if "--final" in flags:
            want = analyzer.generate_final_netlist(want)
        assert out_file.read_text() == want.netlist_text + "\n"
        sim = analyzer.simulate(want)
        assert (f"simulation failed: {sim.error}" if not sim.ok else "node voltages") in out
        return want

    def test_checkpoint_contradicted_by_a_flag(self, drawings, tiny_checkpoint):
        with pytest.raises(SystemExit, match="--scale s contradicts"):
            cli.main(["analyze", str(drawings / "golden.png"), "--device", "cpu",
                      "--yolo-checkpoint", str(tiny_checkpoint[0]), "--scale", "s"])


class TestRefusals:
    @pytest.mark.parametrize("argv,words", [
        (["analyze", "{bmp}", "--device", "cpu", "--scale", "n"], "BMP.*Queue A 9"),
        (["analyze-batch", "x.png", "--distributed"], "Queue A 13"),
    ])
    def test_not_ported_commands(self, tmp_path, capsys, argv, words):
        """A BMP (the web UI, once refused here, is ported now)."""
        import re

        bmp = tmp_path / "c.bmp"
        cv2.imwrite(str(bmp), CIRCUITS[1][0])
        assert cli.main([a.format(bmp=bmp) for a in argv]) != 0
        assert re.search(words, capsys.readouterr().err)

    def test_paligemma_client(self, drawings, capsys, monkeypatch):
        monkeypatch.setenv("CIRCUITVISION_VLM", "paligemma:/nowhere")
        assert cli.main(["analyze", str(drawings / "loop.png"), "--device", "cpu",
                         "--scale", "n"]) != 0
        assert "Queue A 12" in capsys.readouterr().err

    def test_jpeg_input(self, tmp_path, capsys):
        """analyze-batch over a directory of a JPEG and a BMP: the JPEG's
        netlist is analyze_batch's on the decoded pixels, the BMP is
        skipped and named."""
        d = tmp_path / "imgs"
        d.mkdir()
        cv2.imwrite(str(d / "c.jpg"), CIRCUITS[1][0])
        cv2.imwrite(str(d / "d.bmp"), CIRCUITS[1][0])
        out_dir = tmp_path / "netlists"
        assert cli.main(["analyze-batch", str(d), "--device", "cpu", "--scale", "n",
                         "--det-size", "64", "--out-dir", str(out_dir)]) == 0
        err = capsys.readouterr().err
        assert "skipped" in err and "d.bmp" in err and "Queue A 9" in err
        cfg = tconfig.PipelineConfig(detector=tconfig.DetectorConfig(scale="n", img_size=64),
                                     use_sam2=False)
        state = bridge.seeded_state("yolo", {"detector": {
            "scale": "n", "img_size": 64, "num_classes": 62, "reg_max": 16}}, cli.SEED)
        analyzer = CircuitAnalyzerTorch(cfg, state, None, device="cpu")
        (want,) = analyzer.analyze_batch([load_image(str(d / "c.jpg"))])
        assert (out_dir / "c.cir").read_text() == want.netlist_text + "\n"
        assert sorted(p.name for p in out_dir.iterdir()) == ["c.cir"]

    def test_cuda_without_a_card(self, drawings):
        import torch

        if torch.cuda.is_available():
            pytest.skip("this machine has a CUDA device")
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main(["analyze", str(drawings / "loop.png"), "--scale", "n"])
