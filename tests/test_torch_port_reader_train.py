"""The port's reader trainer (circuitvision_tpu_torch/train/reader.py)
against the JAX package's train/reader.py and
scripts/train_reader_demo.py on the CPU, at the shipped reader's width
(ReaderConfig(): 160 px crops, width 48): the dataset, the loss and its
gradients, two train steps after JAX's parameters and optax state are
carried across, and the held-out product metrics through the serving
client.

Tolerances, float32, JAX under jax.default_matmul_precision("highest"):
the dataset exactly equal; losses within 1e-5 · max(1, |jax|); gradients
within 1e-4 · max(1, max |jax|) per leaf; a step's change of each element
within 1e-2 · lr of JAX's (`_check_moves`).
"""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from circuitvision_tpu.train import reader as jreader
from circuitvision_tpu_torch.models import bridge
from circuitvision_tpu_torch.models.reader import CropReader, ReaderConfig
from circuitvision_tpu_torch.train import reader as treader

ROOT = Path(__file__).resolve().parents[1]
LOSS_RTOL, GRAD_RTOL = 1e-5, 1e-4
STEP_LR, STEP_TOL, ROUNDOFF, MAX_DROPPED = 1e-3, 1e-2, 1e-6, 0.1


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the module's tests, restored after: the
    suite runs six workers on eight cores, where torch's oversubscribed
    thread pools make these tests several times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _exact_matmuls():
    with jax.default_matmul_precision("highest"):
        yield


def _close(got, ref, rtol, what=""):
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err, bound = np.abs(got - ref).max(initial=0.0), rtol * max(1.0, np.abs(ref).max(initial=0))
    assert err <= bound, f"{what}: {err:.3e} > {bound:.3e}"


@pytest.fixture(scope="module")
def data():
    """Two circuits' crops from each package (seed 50 000, as the demo)."""
    return treader.generate_reader_dataset(2, 50_000), jreader.generate_reader_dataset(2, 50_000)


@pytest.fixture(scope="module")
def variables():
    v = jax.tree.map(np.asarray, jreader.init_reader(jreader.ReaderConfig(),
                                                     jax.random.PRNGKey(0)))
    model = CropReader(ReaderConfig())
    model.load_state_dict(bridge.state_dict_from_variables(v), strict=True)
    return v, model


def test_generate_reader_dataset_matches_jax(data):
    got, ref = data
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert (ref["val_w"] == 0).any() and (ref["dir"] > 0).any()


def _batch(data, idx):
    d = data[0]
    return tuple(d[k][idx] for k in ("crops", "cls", "val", "dir", "val_w"))


@pytest.mark.parametrize("masked", [True, False])
def test_reader_loss_and_gradients_match_jax(data, variables, masked):
    v, model = variables
    idx = np.flatnonzero(data[0]["val_w"] == 0)[:2].tolist() + [0, 1, 2]
    crops, cls, val, dirs, w = _batch(data, idx)
    jm = jreader.CropReader(jreader.ReaderConfig())

    def jloss(p):
        return jreader.reader_loss(jm, p, jnp.asarray(crops), cls, val, dirs,
                                   jnp.asarray(w) if masked else None)

    (jl, jmet), jg = jax.value_and_grad(jloss, has_aux=True)(v)
    params = treader.reader_params(model)
    tmet, tg = treader.reader_loss_and_grads(model, params, *map(torch.from_numpy, (
        crops, cls, val, dirs)), torch.from_numpy(w) if masked else None)
    for k in ("loss", "cls_loss", "val_loss", "dir_loss"):
        _close(tmet[k], jmet[k], LOSS_RTOL, k)
    ref = bridge.port_tree(jax.tree.map(np.asarray, jg))
    assert set(tg) == set(ref)
    for n in ref:
        _close(tg[n], ref[n].numpy(), GRAD_RTOL, n)


def _check_moves(before, after, jbefore, jafter, nu, lr, what):
    """tests/test_torch_port_train.py's rule: each element's change against
    JAX's within STEP_TOL · lr, elements whose √ν is at round-off of the
    largest dropped and counted."""
    rms = {n: np.sqrt(x.double().numpy()) for n, x in nu.items()}
    top = max(r.max(initial=0.0) for r in rms.values())
    dropped = total = 0
    for n, r in rms.items():
        dj = jafter[n].double().numpy() - jbefore[n].double().numpy()
        dt = after[n].double().numpy() - before[n].double().numpy()
        live = r > ROUNDOFF * top if r.any() else np.ones(r.shape, bool)
        err = np.abs(dt - dj)[live].max(initial=0.0)
        assert err <= STEP_TOL * lr, \
            f"{what} {n}: |Δport − Δjax| {err:.3e} > {STEP_TOL * lr:.3e}"
        dropped, total = dropped + int((~live).sum()), total + live.size
    assert dropped <= MAX_DROPPED * total, f"{what}: {dropped} of {total} elements at round-off"


@pytest.mark.parametrize("fault", [None, "no_update", "sign"])
def test_reader_steps_match_jax_after_state_carried_across(data, variables, fault):
    """The demo's optimizer (adamw, warmup → cosine, decay 1e-4) at peak lr
    STEP_LR: one JAX step, its params and state carried into the port,
    then two steps in each; planted faults in the last step must fail."""
    v, model = variables
    steps = 20
    sched = optax.warmup_cosine_decay_schedule(0.0, STEP_LR, warmup_steps=max(1, steps // 10),
                                               decay_steps=steps, end_value=STEP_LR * 0.05)
    tx = optax.adamw(sched, weight_decay=1e-4)
    jm = jreader.CropReader(jreader.ReaderConfig())
    step = jax.jit(jreader.make_reader_train_step(jm, tx))
    n = data[0]["crops"].shape[0]
    rng = np.random.default_rng(0)
    batches = [_batch(data, rng.integers(0, n, 6)) for _ in range(3)]
    jp, js, _ = step(v, tx.init(v), *batches[0])
    tp = bridge.port_tree(jax.tree.map(np.asarray, jp))
    ts = bridge.optax_state_from_jax(jax.tree.map(np.asarray, js))
    tstep = treader.make_reader_train_step(model, treader.make_reader_optimizer(STEP_LR, steps))
    for i, b in enumerate(batches[1:]):
        jb, tb = bridge.port_tree(jax.tree.map(np.asarray, jp)), tp
        jp, js, jmet = step(jp, js, *b)
        tp, ts, tmet = tstep(tp, ts, *map(torch.from_numpy, b))
        _close(tmet["loss"], jmet["loss"], LOSS_RTOL, f"step {i} loss")
        if fault == "no_update" and i == 1:
            tp = tb
        if fault == "sign" and i == 1:
            tp = {k: 2 * tb[k] - p for k, p in tp.items()}
        ja = bridge.port_tree(jax.tree.map(np.asarray, jp))
        nu = bridge.port_tree(jax.tree.map(np.asarray, js[0].nu))
        if fault and i == 1:
            with pytest.raises(AssertionError):
                _check_moves(tb, tp, jb, ja, nu, STEP_LR, f"step {i}")
        else:
            _check_moves(tb, tp, jb, ja, nu, STEP_LR, f"step {i}")
    assert int(ts[2]["count"]) == int(js[2].count) == 3


def test_evaluate_product_matches_the_jax_demo(variables):
    """The held-out metrics through each package's serving client, same
    weights, two circuits; the port's per-head accuracies bound the row
    match."""
    v, model = variables
    spec = importlib.util.spec_from_file_location("train_reader_demo",
                                                  ROOT / "scripts" / "train_reader_demo.py")
    demo = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(demo)
    ref = demo.evaluate_product(v, 2, seed0=990_000)
    got = treader.evaluate_product(treader.reader_params(model), 2, seed0=990_000, device="cpu")
    assert {k: got[k] for k in ref} == ref
    assert min(got["class_accuracy"], got["value_accuracy"]) >= got["row_exact_match"]
