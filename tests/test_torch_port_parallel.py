"""The port's data and model parallelism (`parallel/`, `train/distributed.py`,
`analyze-batch --distributed`, scripts/torch_train_demo.py) on the CPU with
the gloo backend, against the JAX package's `parallel/` and its
single-process results.

Single process (no process group): every multihost helper degrades to the
JAX package's single-process answer (tests/test_multihost.py's list), the
mesh shape rule and its errors equal JAX's `make_mesh` at every device
count 1-8, and the shard rule splits and keeps whole the same leaves as
`fsdp_param_shardings` on tests/multihost_common.tiny_sam2.

Two ranks: one pair of worker processes (tests/torch_port_parallel_worker.py)
runs the data axis (2 × 1) — mesh rules, collectives, spans, the byte
gather, distributed analysis of the five images of
tests/multihost_common.inference_images, one distributed train step and
two planted faults — and one pair the model axis (1 × 2). The parent
computes the JAX side in-process. The train steps run tiny_sam2's config
and weights in float32 on both sides (the JAX fixture computes in bf16,
whose roundings the packages do not share), at a global batch of 4 (2 a
rank on the data axis). Then the entry points as processes: two ranks of
`cli analyze-batch --distributed` and of the fine-tune demo.
"""
import copy
import dataclasses
import json
import os
import re
import socket
import subprocess
import sys
from pathlib import Path

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from circuitvision_tpu.core.config import MeshConfig as JMeshConfig
from circuitvision_tpu.parallel import mesh as jmesh
from circuitvision_tpu.parallel import multihost as jmultihost
from circuitvision_tpu.train.losses import combined_loss as jcombined_loss
from circuitvision_tpu_torch import cli
from circuitvision_tpu_torch.core import config as tconfig
from circuitvision_tpu_torch.models import bridge
from circuitvision_tpu_torch.models.sam2.wrapper import SAM2ImageSegmenter as TSAM2
from circuitvision_tpu_torch.parallel import mesh as tmesh
from circuitvision_tpu_torch.parallel import multihost as tmultihost
from circuitvision_tpu_torch.train import train_step as tts

ROOT = Path(__file__).resolve().parents[1]
WORKER = ROOT / "tests" / "torch_port_parallel_worker.py"
DEMO = ROOT / "scripts" / "torch_train_demo.py"
#: seconds a rank process may take, rendezvous included
RANK_TIMEOUT_S = 300
#: the fine-tune step's learning rate (TrainConfig's default) and the
#: tests/test_torch_port_train.py:_check_moves tolerances: each element's
#: change within STEP_TOL · lr of the reference's, elements whose √ν is
#: under ROUNDOFF of the leaf set's largest dropped (at most MAX_DROPPED)
STEP_LR, STEP_TOL, ROUNDOFF, MAX_DROPPED = 1e-3, 1e-2, 1e-6, 0.1
#: the loss against JAX's single-process step (tests/test_multihost.py's)
LOSS_RTOL = 2e-5
TORCHRUN_ENV = tmultihost.ENV


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


@pytest.fixture
def no_launcher_env(monkeypatch):
    for k in TORCHRUN_ENV + ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)


# ------------------------------------------------------------ processes
def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_env(rank: int, world: int, port: int) -> dict:
    env = dict(os.environ)
    env.update(PYTHONPATH=str(ROOT) + os.pathsep + env.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1", CIRCUITVISION_VLM="", MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(port), WORLD_SIZE=str(world), RANK=str(rank),
               LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    return env


def _run_ranks(argv, world: int = 2, expect_ok: bool = True, retries: int = 1):
    """Start `world` ranks of argv(rank, port) with torchrun's environment
    and wait for all of them; returns [(returncode, output)]. A rank that
    exceeds RANK_TIMEOUT_S fails the test; only a port taken between
    choosing it and binding it is retried, once."""
    port = _free_port()
    procs = [subprocess.Popen(argv(r, port), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True, env=_rank_env(r, world, port), cwd=ROOT)
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=RANK_TIMEOUT_S)[0])
    except subprocess.TimeoutExpired:
        pytest.fail(f"a rank ran past {RANK_TIMEOUT_S} s: {argv(0, port)}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    res = [(p.returncode, out) for p, out in zip(procs, outs)]
    if retries and any(rc and "address already in use" in out.lower() for rc, out in res):
        return _run_ranks(argv, world, expect_ok, retries - 1)
    if expect_ok:
        for r, (rc, out) in enumerate(res):
            assert rc == 0, f"rank {r} exited {rc}:\n{out}"
    return res


def _results(out: str) -> dict:
    return dict(m.groups() for m in re.finditer(r"^RESULT (\w+)=(.*)$", out, re.MULTILINE))


# ------------------------------------------------------------- the JAX side
def _jax_tiny_sam2():
    """tests/multihost_common.tiny_sam2 computed in float32 on the same
    variables, and the JAX loss of a global batch."""
    from circuitvision_tpu.models.sam2.wrapper import SAM2ImageSegmenter as JSAM2
    from tests.multihost_common import tiny_sam2

    cfg, _model, variables = tiny_sam2()
    cfg = dataclasses.replace(cfg, dtype="float32")
    return cfg, JSAM2(cfg=cfg), jax.tree.map(np.asarray, variables)


def _port_config(jcfg) -> dict:
    fields = ("resolution", "embed_dim", "num_heads", "stages", "global_att_blocks",
              "window_spec", "backbone_channel_list", "decoder_mlp_dim", "dtype")
    return {f: list(v) if isinstance(v, tuple) else v
            for f in fields for v in [getattr(jcfg, f)]}


@pytest.fixture(scope="module")
def step_inputs(tmp_path_factory):
    """The worker directory (tiny_sam2's port state and config, the global
    batch, the inference images and their boxes), the JAX loss of the
    global batch, and the port's single-process step on it."""
    from tests.multihost_common import inference_images, make_global_train_batch

    d = tmp_path_factory.mktemp("ranks")
    jcfg, jm, v = _jax_tiny_sam2()
    images, masks = make_global_train_batch(jcfg, batch=4)
    np.savez(d / "batch.npz", images=images, masks=masks)
    state = bridge.state_dict_from_variables(v)
    torch.save(state, d / "sam2_state.pt")
    pcfg = _port_config(jcfg)
    (d / "sam2_config.json").write_text(json.dumps(pcfg))
    imgs, gt = inference_images()
    np.savez(d / "images.npz", **{f"i{k}": im for k, im in enumerate(imgs)})
    (d / "boxes.json").write_text(json.dumps({
        json.dumps(list(shape)): [{f: getattr(b, f) for f in
                                   ("class_name", "confidence", "xmin", "ymin", "xmax", "ymax")}
                                  for b in boxes] for shape, boxes in gt.items()}))

    def loss_fn(variables, x, m):
        high, _low, iou = jm.apply(variables, x)
        return jcombined_loss(high[..., 0], iou, m)[0]

    jloss = float(jax.jit(loss_fn)(v, jnp.asarray(images), jnp.asarray(masks)))

    tm = TSAM2(tconfig.SAM2Config(**pcfg))
    tm.load_state_dict(state, strict=True)
    params = {n: p.detach().clone() for n, p in tm.named_parameters()}
    tx, mask = tts.make_optimizer(tm, tconfig.TrainConfig())
    opt = tx.init(params)
    step = tts.make_train_step(tm, tx, tconfig.TrainConfig(), mask=mask)
    after, opt_after, metrics = step(params, opt, torch.from_numpy(images),
                                     torch.from_numpy(masks))
    return {"dir": d, "jax_loss": jloss, "before": params, "after": after, "mask": mask,
            "nu": {n: t.numpy() for n, t in opt_after["nu"].items()},
            "loss": float(metrics["loss"])}


def _check_moves(before, after, ref_after, nu, lr, what):
    """tests/test_torch_port_train.py:_check_moves with the port's
    single-process step as the reference: each trainable leaf's change
    within STEP_TOL · lr of the reference's on every element not at
    round-off."""
    rms = {n: np.sqrt(np.asarray(x, np.float64)) for n, x in nu.items()}
    top = max(r.max(initial=0.0) for r in rms.values())
    dropped = total = 0
    for n, r in rms.items():
        ref = ref_after[n].double().numpy() - before[n].double().numpy()
        got = after[n].double().numpy() - before[n].double().numpy()
        live = r > ROUNDOFF * top if r.any() else np.ones(r.shape, bool)
        err = np.abs(got - ref)[live].max(initial=0.0)
        assert err <= STEP_TOL * lr, f"{what} {n}: |Δ − Δref| {err:.3e} > {STEP_TOL * lr:.3e}"
        dropped, total = dropped + int((~live).sum()), total + live.size
    assert dropped <= MAX_DROPPED * total, f"{what}: {dropped} of {total} elements at round-off"


def _check_step(got: dict, ref: dict, what: str) -> None:
    """A distributed step's whole parameters against the single-process
    step: the loss within LOSS_RTOL of JAX's and of the port's, every
    trainable leaf's change by _check_moves, every frozen leaf unchanged."""
    np.testing.assert_allclose(got["loss"], ref["jax_loss"], rtol=LOSS_RTOL, err_msg=what)
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=LOSS_RTOL, err_msg=what)
    _check_moves(ref["before"], got["params"], ref["after"], ref["nu"], STEP_LR, what)
    for n, m in ref["mask"].items():
        if not m:
            assert torch.equal(got["params"][n], ref["before"][n]), f"{what}: frozen {n} moved"


@pytest.fixture(scope="module")
def data_ranks(step_inputs):
    d = step_inputs["dir"]
    res = _run_ranks(lambda r, port: [sys.executable, str(WORKER), str(r), "2", str(port),
                                      "data", str(d)])
    return [_results(out) for _rc, out in res]


@pytest.fixture(scope="module")
def model_ranks(step_inputs):
    d = step_inputs["dir"]
    res = _run_ranks(lambda r, port: [sys.executable, str(WORKER), str(r), "2", str(port),
                                      "model", str(d)])
    return [_results(out) for _rc, out in res]


def _saved(d, tag):
    return [torch.load(d / f"{tag}_rank{r}.pt", weights_only=True) for r in (0, 1)]


# ---------------------------------------------------- single process
def test_initialize_without_env_is_noop(no_launcher_env):
    assert tmultihost.initialize() is False and jmultihost.initialize() is False
    assert tmultihost.is_distributed() is False and jmultihost.is_distributed() is False
    assert tmultihost.device() is None and tmultihost.process_count() == 1


@pytest.mark.parametrize("env", [{"WORLD_SIZE": "2"},
                                 {k: "0" for k in TORCHRUN_ENV if k != "MASTER_PORT"}])
def test_half_configured_env_refused(no_launcher_env, monkeypatch, env):
    """As JAX refuses JAX_NUM_PROCESSES without a coordinator: never fall
    back to single-process, which would make every rank do all the work."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(ValueError, match="refusing to fall back to single-process"):
        tmultihost.initialize()
    monkeypatch.setenv("JAX_NUM_PROCESSES", "2")
    with pytest.raises(ValueError, match="refusing to fall back to single-process"):
        jmultihost.initialize()


@pytest.mark.parametrize("kw,error,words", [
    (dict(device="cuda"), RuntimeError, "CUDA is not available"),
    (dict(device="cpu", backend="nccl"), ValueError, "nccl backend needs a CUDA device"),
    (dict(device="cpu", backend="mpi"), ValueError, "expected one of nccl, gloo"),
    (dict(cards=1), ValueError, r"LOCAL_RANK gives cuda:1, but this host has 1 CUDA device"),
    (dict(cards=2, device="cuda:2"), ValueError, "the device named gives cuda:2, but this host"),
])
def test_initialize_refuses_before_joining(no_launcher_env, monkeypatch, kw, error, words):
    """A rank's device and backend are checked before the rendezvous: no
    card, NCCL on the CPU, an unknown backend, and (with `cards` CUDA
    devices stood in) a LOCAL_RANK or a named index past the host's
    cards — never wrapped to another card or moved to the CPU."""
    for k, v in zip(TORCHRUN_ENV, ("127.0.0.1", "1", "2", "1", "1", "2")):
        monkeypatch.setenv(k, v)
    kw = dict(kw)
    if "cards" in kw:
        n = kw.pop("cards")
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: n)
    with pytest.raises(error, match=words):
        tmultihost.initialize(**kw)
    assert not tmultihost.is_distributed()


def test_spans_gather_sync_single_process(no_launcher_env):
    for n in (0, 5, 24):
        assert tmultihost.local_span(n) == jmultihost.local_span(n) == range(0, n)
        assert tmultihost.balanced_span(n) == jmultihost.balanced_span(n) == range(0, n)
    for payload in (b"abc", b""):
        assert tmultihost.gather_bytes(payload) == jmultihost.gather_bytes(payload) == [payload]
    tmultihost.sync()
    jmultihost.sync()


MESH_CONFIGS = [dict(), dict(model_parallel=2), dict(model_parallel=3),
                dict(data_parallel=2), dict(data_parallel=3, model_parallel=2),
                dict(data_parallel=5), dict(model_parallel=9), dict(model_parallel=0)]


@pytest.mark.parametrize("kw", MESH_CONFIGS, ids=[json.dumps(k) for k in MESH_CONFIGS])
def test_mesh_shape_rule_matches_jax(kw):
    """The port's shape rule over n ranks against JAX's make_mesh over the
    first n of the 8 virtual CPU devices: the same grid or the same
    error, at every n."""
    devices = jax.devices("cpu")
    for n in range(1, len(devices) + 1):
        try:
            want = tuple(jmesh.make_mesh(JMeshConfig(**kw), devices=devices[:n]).devices.shape)
        except ValueError as e:
            with pytest.raises(ValueError, match=re.escape(str(e))):
                tmesh.mesh_shape(n, tconfig.MeshConfig(**kw))
            continue
        assert tmesh.mesh_shape(n, tconfig.MeshConfig(**kw)) == want, n


def test_global_mesh_reduces_to_make_mesh(no_launcher_env):
    """Single-process, global_mesh is make_mesh over the process's one
    rank (JAX: over its local devices), subset meshes included, and the
    config's axis names."""
    for kw in (dict(), dict(data_parallel=1, model_parallel=1)):
        g = tmultihost.global_mesh(tconfig.MeshConfig(**kw))
        assert g == tmesh.make_mesh(tconfig.MeshConfig(**kw))
        assert g.shape == (1, 1) and g.coords == (0, 0) and g.axis_names == ("data", "model")
        assert g.data_group is None and g.model_group is None
    with pytest.raises(ValueError, match="mesh 0x2 exceeds 1 devices"):
        tmultihost.global_mesh(tconfig.MeshConfig(model_parallel=2))
    assert tconfig.BATCH_PER_DEVICE == tconfig.MeshConfig().batch_per_device == \
        JMeshConfig().batch_per_device
    assert dataclasses.asdict(tconfig.MeshConfig()) == dataclasses.asdict(JMeshConfig())
    assert tconfig.PipelineConfig().mesh == tconfig.MeshConfig()


@pytest.mark.parametrize("model,min_size", [(2, 1024), (4, 1024), (2, 2 ** 16), (8, 1024)])
def test_shard_rule_matches_jax_on_tiny_sam2(model, min_size):
    """fsdp_shard_dims over the port's parameters splits exactly the
    leaves JAX's fsdp_param_shardings splits on tiny_sam2 (by the flax
    path, bridge.flax_names), and keeps the others whole. The dim differs
    where the layouts do: the rule prefers the last divisible dim, and a
    torch kernel is (out, in[, kh, kw]) where flax's is ([kh, kw,] in,
    out)."""
    jcfg, _jm, v = _jax_tiny_sam2()
    mesh = jmesh.make_mesh(JMeshConfig(model_parallel=model))
    shardings = jmesh.fsdp_param_shardings(v, mesh, axis="model", min_size=min_size)
    want = {}
    for path, sh in jax.tree_util.tree_flatten_with_path(shardings)[0]:
        key = "/".join(str(getattr(p, "key", p)) for p in path)
        want[key] = "model" in list(sh.spec)
    tm = TSAM2(tconfig.SAM2Config(**_port_config(jcfg)))
    params = dict(tm.named_parameters())
    tgrid = tmesh.Mesh((8 // model, model), ("data", "model"), 0, (0, 0))
    dims = tmesh.fsdp_shard_dims(params, tgrid, min_size=min_size)
    names = bridge.flax_names(tm)
    got = {names[n]: d is not None for n, d in dims.items()}
    assert got == want
    assert any(got.values()) and not all(got.values())
    for n, d in dims.items():
        if d is not None:
            assert params[n].shape[d] % model == 0 and all(
                params[n].shape[k] % model for k in range(d + 1, params[n].dim())), n


def test_analyze_distributed_final_single_process(no_launcher_env, monkeypatch):
    """tests/test_multihost.py's final=True case on both packages, one
    process: the gathered netlists carry the VLM's value, and equal JAX's."""
    from circuitvision_tpu.core.config import DetectorConfig, PipelineConfig
    from circuitvision_tpu.enrich.client import FakeVLMClient
    from circuitvision_tpu.eval.synth import make_circuits
    from circuitvision_tpu.pipeline import batch as jbatch
    from circuitvision_tpu.pipeline.analyzer import CircuitAnalyzerTPU
    from circuitvision_tpu_torch.core.types import BBox
    from circuitvision_tpu_torch.enrich.client import FakeVLMClient as TFake
    from circuitvision_tpu_torch.pipeline import batch as tbatch
    from circuitvision_tpu_torch.pipeline.analyzer import CircuitAnalyzerTorch

    labels = [{"id": "1", "class": "voltage.dc", "value": "9"}]
    c = make_circuits()[0]
    det = dict(scale="n", img_size=64, dtype="float32")
    jclient = FakeVLMClient(labels=labels)
    ja = CircuitAnalyzerTPU(config=PipelineConfig(detector=DetectorConfig(**det),
                                                  use_sam2=False),
                            use_sam2=False, vlm_client=jclient)
    monkeypatch.setattr(jbatch.BatchedPipeline, "_detect_bboxes",
                        lambda self, chunk: [copy.deepcopy(c.boxes) for _ in chunk])
    _jl, want = jmultihost.analyze_many_distributed(ja, [c.image, c.image], batch_size=8,
                                                    final=True)
    tclient = TFake(labels=labels)
    meta = {"detector": {"scale": "n", "img_size": 64, "num_classes": 62, "reg_max": 16}}
    ta = CircuitAnalyzerTorch(tconfig.PipelineConfig(detector=tconfig.DetectorConfig(**det),
                                                     use_sam2=False),
                              bridge.seeded_state("yolo", meta, 0), None, device="cpu",
                              vlm_client=tclient)
    fields = ("class_name", "confidence", "xmin", "ymin", "xmax", "ymax")
    monkeypatch.setattr(tbatch.BatchedPipeline, "_detect_bboxes", lambda self, chunk, devs: [
        [BBox(**{f: getattr(b, f) for f in fields}) for b in c.boxes] for _ in chunk])
    local, got = tmultihost.analyze_many_distributed(ta, [c.image, c.image], batch_size=8,
                                                     final=True)
    assert len(local) == len(got) == 2
    assert got == want
    for net in got:
        assert " 9" in net["netlist"] and net["netlist"] != net["valueless"]
    assert tclient.label_batch_calls >= 1


# ----------------------------------------------------------- two ranks
def test_mesh_collectives_span_gather(data_ranks):
    """tests/test_multihost.py's worker results, one device a rank: the
    sum over both ranks' shards, the spans, the gathered strings."""
    for r in data_ranks:
        assert r["mesh_shape"] == "(2, 1)"
        assert float(r["global_sum"]) == 856.0  # 0..7 on rank 0 (28) + 100-offset (828)
        assert r["gathered"] == "netlist-from-0,netlist-from-1"
    assert [r["span"] for r in data_ranks] == ["0:8", "8:16"]
    assert [r["balanced"] for r in data_ranks] == ["0:3", "3:5"]


def test_inference_netlists_match_jax_single_process(data_ranks, no_launcher_env):
    """Five images over two ranks (3/2): the gathered netlists, the same
    on both ranks, byte-equal to the JAX package's single-process
    analyze() on tests/multihost_common.tiny_analyzer."""
    from tests.multihost_common import inference_images, tiny_analyzer

    assert [r["local"] for r in data_ranks] == ["3", "2"]
    assert data_ranks[0]["netlists"] == data_ranks[1]["netlists"]
    analyzer = tiny_analyzer()
    images, gt = inference_images()
    analyzer.bboxes = lambda img: copy.deepcopy(gt[img.shape])
    want = [analyzer.analyze(img).valueless_netlist_text for img in images]
    assert json.loads(data_ranks[0]["netlists"]) == want
    assert all(want)


def test_data_parallel_step_matches_single_process(data_ranks, step_inputs):
    """One step over 2 × 1 at 2 images a rank: the loss within 2e-5 of
    JAX's single-process step on the global batch of 4, both ranks'
    parameters equal, each leaf's change the port's single-process step's."""
    got = _saved(step_inputs["dir"], "data_ok")
    assert [g["batch"] for g in got] == [2, 2]
    assert got[0]["loss"] == got[1]["loss"]
    assert got[0]["sharded"] == []
    for n, t in got[0]["params"].items():
        assert torch.equal(t, got[1]["params"][n]), n
    _check_step(got[0], step_inputs, "data axis")


@pytest.mark.parametrize("fault", ["no_average", "one_shard"])
def test_planted_faults_fail(data_ranks, step_inputs, fault):
    """Gradients left unaveraged, or a rank fed the other rank's shard,
    must fail the parameters' check on every rank."""
    ref = step_inputs
    for g in _saved(ref["dir"], f"data_{fault}"):
        with pytest.raises(AssertionError, match="Δref"):
            _check_moves(ref["before"], g["params"], ref["after"], ref["nu"], STEP_LR, fault)


def test_model_axis_step_matches_single_process(model_ranks, step_inputs):
    """One step over 1 × 2: the leaves of at least 1024 elements rest
    split over the two ranks (parameters and Adam's moments); gathered
    after the step, equal on both ranks and to the single-process step."""
    got = _saved(step_inputs["dir"], "model_ok")
    assert [g["batch"] for g in got] == [4, 4]
    assert got[0]["loss"] == got[1]["loss"]
    assert len(got[0]["sharded"]) > 10
    for n, t in got[0]["params"].items():
        assert torch.equal(t, got[1]["params"][n]), n
    _check_step(got[0], step_inputs, "model axis")


@pytest.mark.parametrize("selective", [True, False])
def test_multichip_step_takes_the_module_path(step_inputs, monkeypatch, selective):
    """make_train_step(multichip=True), the JAX flag: the forward it
    differentiates runs every block on the module path with einsum
    attention (hiera.force_fused(False), force_flash(False)); its loss is
    JAX's single-process one, and the selective step's update the
    default step's."""
    from circuitvision_tpu_torch.models.sam2 import hiera as thiera

    seen = []
    model_loss = tts.model_loss
    monkeypatch.setattr(tts, "model_loss", lambda *a, **k: seen.append(
        (thiera._FORCE_FUSED, thiera._FORCE_FLASH)) or model_loss(*a, **k))
    d = step_inputs["dir"]
    tm = TSAM2(tconfig.SAM2Config(**json.loads((d / "sam2_config.json").read_text())))
    tm.load_state_dict(torch.load(d / "sam2_state.pt", weights_only=True), strict=True)
    params = {n: p.detach().clone() for n, p in tm.named_parameters()}
    tx, mask = tts.make_optimizer(tm, tconfig.TrainConfig(),
                                  None if selective else {n: True for n in params})
    with np.load(d / "batch.npz") as z:
        batch = torch.from_numpy(z["images"]), torch.from_numpy(z["masks"])
    after, _o, metrics = tts.make_train_step(tm, tx, tconfig.TrainConfig(), mask,
                                             selective=selective, multichip=True)(
        params, tx.init(params), *batch)
    assert seen == [(False, False)]
    np.testing.assert_allclose(float(metrics["loss"]), step_inputs["jax_loss"], rtol=LOSS_RTOL)
    if selective:
        _check_moves(step_inputs["before"], after, step_inputs["after"], step_inputs["nu"],
                     STEP_LR, "multichip")


# ----------------------------------------------------------- entry points
@pytest.fixture(scope="module")
def drawings(tmp_path_factory):
    """Five PNGs (the golden and loop drawings, alternating) for a 3/2
    split."""
    from .test_torch_port_batch import CIRCUITS

    d = tmp_path_factory.mktemp("imgs")
    for k in range(5):
        img = CIRCUITS[k % 2][0]
        cv2.imwrite(str(d / f"c{k}.png"), cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
    return d


def test_cli_analyze_batch_distributed_two_ranks(drawings, tmp_path, no_launcher_env,
                                                 monkeypatch):
    """`python -m circuitvision_tpu_torch.cli analyze-batch --distributed
    --device cpu` as two ranks: each prints its span, rank 0 writes every
    netlist and the rate, and the files are single-process analyze-batch's."""
    monkeypatch.setenv("CIRCUITVISION_VLM", "")
    flags = ["--device", "cpu", "--scale", "n", "--det-size", "64", "--batch-size", "2"]
    single = tmp_path / "single"
    assert cli.main(["analyze-batch", str(drawings), *flags, "--out-dir", str(single)]) == 0
    out = tmp_path / "ranks"
    res = _run_ranks(lambda r, port: [sys.executable, "-m", "circuitvision_tpu_torch.cli",
                                      "analyze-batch", str(drawings), *flags, "--distributed",
                                      "--out-dir", str(out)])
    assert "[rank 0] images 0:3 of 5 on cpu" in res[0][1]
    assert "[rank 1] images 3:5 of 5 on cpu" in res[1][1]
    assert "5 images over 2 rank(s)" in res[0][1] and "images over" not in res[1][1]
    names = sorted(p.name for p in single.iterdir())
    assert names == [f"c{k}.cir" for k in range(5)]
    assert sorted(p.name for p in out.iterdir()) == names
    for n in names:
        assert (out / n).read_bytes() == (single / n).read_bytes(), n


def test_cli_a_failing_rank_fails_the_run(drawings, tmp_path):
    """A rank whose span holds an image kind the reader refuses exits
    non-zero, and so does the rank waiting for it in the gather."""
    d = tmp_path / "imgs"
    d.mkdir()
    for k in range(2):
        (d / f"c{k}.png").write_bytes((drawings / f"c{k}.png").read_bytes())
    from PIL import Image

    # an AVIF file named as a BMP
    Image.open(drawings / "c0.png").convert("RGB").save(d / "c2.bmp", format="AVIF")
    res = _run_ranks(lambda r, port: [sys.executable, "-m", "circuitvision_tpu_torch.cli",
                                      "analyze-batch", str(d), "--device", "cpu", "--scale",
                                      "n", "--det-size", "64", "--distributed"],
                     expect_ok=False)
    assert res[1][0] != 0 and "AVIF" in res[1][1]
    assert res[0][0] != 0


def test_cli_device_and_backend_flags():
    p = cli._parser()
    args = p.parse_args(["analyze-batch", "x.png", "--distributed", "--backend", "gloo",
                         "--device", "cuda:0"])
    assert (args.distributed, args.backend, args.device) == (True, "gloo", "cuda:0")
    for bad in (["--device", "gpu"], ["--device", "cuda:x"], ["--backend", "mpi"]):
        with pytest.raises(SystemExit):
            p.parse_args(["analyze-batch", "x.png", *bad])


def _demo_losses(out: str) -> list:
    return re.findall(r"^step +\d+ +loss (\S+)", out, re.MULTILINE)


def test_demo_distributed_two_ranks(tmp_path, no_launcher_env, capsys):
    """scripts/torch_train_demo.py --distributed as two ranks on the CPU:
    both ranks print the same losses, those of the demo in one process."""
    argv = ["--device", "cpu", "--steps", "2", "--res", "64", "--batch", "4",
            "--log-every", "1"]
    demo = _load_demo()
    demo.main(argv)
    single = _demo_losses(capsys.readouterr().out)
    res = _run_ranks(lambda r, port: [sys.executable, str(DEMO), *argv, "--distributed"])
    losses = [_demo_losses(out) for _rc, out in res]
    assert len(single) == 2 and losses[0] == losses[1] == single
    assert "distributed: 2 process(es), mesh {'data': 2, 'model': 1}, cpu, gloo" in res[0][1]
    assert "TRAIN DEMO OK" in res[0][1] and "TRAIN DEMO OK" in res[1][1]


def _load_demo():
    import importlib.util

    spec = importlib.util.spec_from_file_location("torch_train_demo", DEMO)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _load_jax_demo():
    import importlib.util

    spec = importlib.util.spec_from_file_location("train_demo", ROOT / "scripts" / "train_demo.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_demo_small_cfg_and_make_batch_match_jax():
    """small_cfg is the JAX script's config; make_batch renders the same
    circuits: masks byte-equal, images within 1e-5 (the resize's float32
    products are summed in another order by XLA's dot and by torch's;
    max difference 2.6e-6 measured at 64 and 256; XLA's own images change
    with the number of cores its thread pool splits the dot over)."""
    demo, jdemo = _load_demo(), _load_jax_demo()
    for res in (64, 256):
        want = dataclasses.asdict(jdemo.small_cfg(res))
        got = dataclasses.asdict(demo.small_cfg(res))
        assert {k: list(v) if isinstance(v, tuple) else v for k, v in got.items()} == \
            {k: list(v) if isinstance(v, tuple) else v for k, v in want.items() if k in got}
    for seed, n, res in ((1000, 2, 64), (990000, 1, 96)):
        ji, jm = (np.asarray(a) for a in jdemo.make_batch(seed, n, res))
        ti, tm = demo.make_batch(seed, n, res)
        assert ti.dtype == ji.dtype == np.float32 and ti.shape == ji.shape
        assert tm.tobytes() == jm.tobytes()
        np.testing.assert_allclose(ti, ji, rtol=0, atol=1e-5)


@pytest.mark.parametrize("argv,words", [
    (["--distributed", "--ckpt-dir", "x"], "--ckpt-dir with --distributed is not supported"),
    (["--distributed", "--surface", "lora"], "--surface lora with --distributed is not wired"),
    (["--surface", "lora", "--ema-decay", "0.9"], "--ema-decay with --surface lora is not"),
])
def test_demo_refusals(no_launcher_env, argv, words):
    """The JAX script's refusals, word for word: each message the port's
    raises is one of the JAX script's `raise SystemExit(...)` strings."""
    import ast

    tree = ast.parse((ROOT / "scripts" / "train_demo.py").read_text())
    jax_msgs = {node.exc.args[0].value for node in ast.walk(tree)
                if isinstance(node, ast.Raise) and isinstance(node.exc, ast.Call)
                and getattr(node.exc.func, "id", "") == "SystemExit" and node.exc.args
                and isinstance(node.exc.args[0], ast.Constant)}
    with pytest.raises(SystemExit) as e:
        _load_demo().main(["--device", "cpu", "--res", "64", "--steps", "1", *argv])
    assert str(e.value).startswith(words)
    assert str(e.value) in jax_msgs
