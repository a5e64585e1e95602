"""The port's detector trainer (circuitvision_tpu_torch/train/yolo_loss.py,
optim.py, yolo_train.py) against the JAX package's on the CPU: the loss
functions and the assignment (with planted ties), the optimizer against
optax step for step (a NaN gradient planted, a run of non-finite steps
past apply_if_finite's limit, the schedules), the target packing and
bias init, and two train steps after JAX's whole variable tree —
`batch_stats` included — and its optimizer state are carried across.

Tolerances, float32, JAX under jax.default_matmul_precision("highest"):
assignments exactly equal; losses within 1e-5 · max(1, |jax|); gradients
with respect to the head outputs within 1e-4 · max(1, max |jax|); a train
step's change of each element within 1e-2 · lr of JAX's (`_check_moves`,
elements at round-off dropped and counted).
"""
import logging

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from circuitvision_tpu.core.types import BBox as JBBox
from circuitvision_tpu.models.yolo.model import YOLOv11 as JYOLO
from circuitvision_tpu.models.yolo.model import init_params as jyolo_init
from circuitvision_tpu.train import yolo_loss as jyl
from circuitvision_tpu.train import yolo_train as jyt
from circuitvision_tpu_torch.core.types import BBox
from circuitvision_tpu_torch.models import bridge
from circuitvision_tpu_torch.models.yolo.model import YOLOv11
from circuitvision_tpu_torch.train import optim
from circuitvision_tpu_torch.train import yolo_loss as tyl
from circuitvision_tpu_torch.train import yolo_train as tyt

LOSS_RTOL, GRAD_RTOL = 1e-5, 1e-4
STEP_LR, STEP_TOL, ROUNDOFF, MAX_DROPPED = 1e-3, 1e-2, 1e-6, 0.1
NC, IMG, R = 5, 64, 16


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


def _heads(seed: int, b: int = 2, ties: bool = False):
    """Per-scale head outputs (B, n, n, 4R + NC) at IMG, float32."""
    rng = np.random.default_rng(seed)
    outs = []
    for s in (8, 16, 32):
        n = IMG // s
        o = rng.normal(0, 1.5, (b, n, n, 4 * R + NC)).astype(np.float32)
        if ties:  # identical predictions at every anchor: exact ties
            o[:] = o[:1, :1, :1]
        outs.append(o)
    return outs


def _gt(seed: int, b: int = 2, m: int = 6):
    rng = np.random.default_rng(seed)
    boxes = np.zeros((b, m, 4), np.float32)
    x0 = rng.uniform(0, IMG - 24, (b, m))
    y0 = rng.uniform(0, IMG - 24, (b, m))
    boxes[..., 0], boxes[..., 1] = x0, y0
    boxes[..., 2] = x0 + rng.uniform(8, 24, (b, m))
    boxes[..., 3] = y0 + rng.uniform(8, 24, (b, m))
    boxes = np.round(boxes)
    classes = rng.integers(0, NC, (b, m)).astype(np.int32)
    valid = np.ones((b, m), bool)
    valid[:, -1] = False
    return boxes, classes, valid


CFG = dict(num_classes=NC, reg_max=R, img_size=IMG)


def test_anchor_grid_ciou_iou_match_jax():
    jp, js = jyl.anchor_grid(IMG)
    tp, ts = tyl.anchor_grid(IMG)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    rng = np.random.default_rng(0)
    a = np.sort(rng.uniform(0, 64, (50, 4)).reshape(50, 2, 2), axis=1).transpose(0, 2, 1)
    b = np.sort(rng.uniform(0, 64, (50, 4)).reshape(50, 2, 2), axis=1).transpose(0, 2, 1)
    a, b = a.reshape(50, 4)[:, [0, 2, 1, 3]].astype(np.float32), \
        b.reshape(50, 4)[:, [0, 2, 1, 3]].astype(np.float32)
    _close(tyl.pairwise_ciou(torch.from_numpy(a), torch.from_numpy(b)),
           jyl.pairwise_ciou(jnp.asarray(a), jnp.asarray(b)), LOSS_RTOL, "ciou")
    _close(tyl.iou_matrix_xyxy(torch.from_numpy(a[None, :7]), torch.from_numpy(b[None])),
           jyl.iou_matrix_xyxy(jnp.asarray(a[None, :7]), jnp.asarray(b[None])), LOSS_RTOL, "iou")
    t = rng.uniform(0, 15, (2, 9, 4)).astype(np.float32)
    d = rng.normal(size=(2, 9, 4 * R)).astype(np.float32)
    _close(tyl._dfl_loss(torch.from_numpy(d), torch.from_numpy(t), R),
           jyl._dfl_loss(jnp.asarray(d), jnp.asarray(t), R), LOSS_RTOL, "dfl")
    x, y = rng.normal(0, 4, (40,)).astype(np.float32), rng.uniform(0, 1, (40,)).astype(np.float32)
    _close(tyl.sigmoid_bce(torch.from_numpy(x), torch.from_numpy(y)),
           jyl.optax_sigmoid_bce(jnp.asarray(x), jnp.asarray(y)), LOSS_RTOL, "bce")


def _decoded(outs):
    """The assigner's inputs from head outputs, through the JAX decode."""
    flat = jnp.concatenate([jnp.asarray(o).reshape(o.shape[0], -1, o.shape[-1]) for o in outs], 1)
    from circuitvision_tpu.models.yolo.decode import _dfl
    ap, st = jyl.anchor_grid(IMG)
    lt = _dfl(flat[..., :4 * R], R)
    boxes = jnp.stack([ap[None, :, 0] - lt[..., 0] * st, ap[None, :, 1] - lt[..., 1] * st,
                       ap[None, :, 0] + lt[..., 2] * st, ap[None, :, 1] + lt[..., 3] * st], -1)
    return np.asarray(jax.nn.sigmoid(flat[..., 4 * R:])), np.asarray(boxes), np.asarray(ap)


@pytest.mark.parametrize("seed,ties", [(0, False), (1, False), (2, True), (3, True)])
def test_task_aligned_assign_matches_jax(seed, ties):
    """Assignments exactly equal, also where every prediction is the same
    (top-k over exact ties: lower anchor index first in both)."""
    scores, boxes, ap = _decoded(_heads(seed, ties=ties))
    gb, gc, gv = _gt(seed + 10)
    if ties:  # two identical gts as well: conflicts resolved alike
        gb[:, 1], gc[:, 1] = gb[:, 0], gc[:, 0]
    jf, ja, jt = jyl.task_aligned_assign(scores, boxes, ap, gb, gc, gv, jyl.YOLOLossConfig(**CFG))
    tf, ta, tt = tyl.task_aligned_assign(*map(torch.from_numpy, (scores, boxes, ap, gb, gc, gv)),
                                         tyl.YOLOLossConfig(**CFG))
    assert np.asarray(jf).sum() > 0
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    _close(tt, jt, LOSS_RTOL, "target scores")


@pytest.mark.parametrize("seed,ties", [(0, False), (4, False), (5, True)])
def test_detection_loss_and_head_gradients_match_jax(seed, ties):
    outs = _heads(seed, ties=ties)
    gb, gc, gv = _gt(seed + 20)
    jcfg, tcfg = jyl.YOLOLossConfig(**CFG), tyl.YOLOLossConfig(**CFG)

    def jloss(o):
        return jyl.yolo_detection_loss(o, gb, gc, gv, jcfg)

    (jl, jm), jg = jax.value_and_grad(jloss, has_aux=True)([jnp.asarray(o) for o in outs])
    touts = [torch.from_numpy(o).requires_grad_(True) for o in outs]
    tl, tm = tyl.yolo_detection_loss(touts, *map(torch.from_numpy, (gb, gc, gv)), tcfg)
    tg = torch.autograd.grad(tl, touts)
    for k in ("loss", "box_loss", "cls_loss", "dfl_loss"):
        _close(tm[k], jm[k], LOSS_RTOL, k)
    assert int(tm["n_fg"]) == int(jm["n_fg"]) > 0
    for i, (a, b) in enumerate(zip(tg, jg)):
        _close(a, b, GRAD_RTOL, f"d loss / d head {i}")


# ---------------------------------------------------------------- optimizer
def _flat_tree(t, device=None):
    return {k: torch.from_numpy(np.array(v)) for k, v in t.items()}


def _state_equal(tstate, jstate, what):
    """Port state against optax's converted: counters and flags exactly,
    float leaves within 1e-6 relative."""
    ref = bridge.optax_state_from_jax(jax.tree.map(np.asarray, jstate), tree=_flat_tree)

    def walk(a, b, path):
        if isinstance(b, dict):
            assert set(a) == set(b), (what, path, set(a), set(b))
            for k in b:
                walk(a[k], b[k], f"{path}/{k}")
        elif isinstance(b, tuple):
            assert len(a) == len(b), (what, path)
            for i, (x, y) in enumerate(zip(a, b)):
                walk(x, y, f"{path}/{i}")
        elif b.dtype.is_floating_point:
            _close(a, b.numpy(), 1e-6, f"{what} {path}")
        else:
            assert a.dtype == b.dtype and torch.equal(a, b), (what, path, a, b)
    walk(tstate, ref, "")


def _grads(seed, n, nan_at=(), size=1.0):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        g = {"a": rng.normal(0, size, (3, 4)).astype(np.float32),
             "b": rng.normal(0, size, (5,)).astype(np.float32)}
        if i in nan_at:
            g["b"][2] = np.nan
        out.append(g)
    return out


@pytest.mark.parametrize("kind", ["warmup", "cosine", "constant", "reader"])
def test_optimizer_matches_optax_with_a_nan_step(kind):
    """5 steps, a NaN gradient at step 3 (skipped: zero update, counters
    up), the global-norm clip active on some steps; the updates and the
    whole state (counters, moments, schedule counts) against optax."""
    if kind == "reader":
        sched = optax.warmup_cosine_decay_schedule(0.0, 3e-4, warmup_steps=1, decay_steps=5,
                                                   end_value=3e-4 * 0.05)
        jtx = optax.adamw(sched, weight_decay=1e-4)
        from circuitvision_tpu_torch.train.reader import make_reader_optimizer
        ttx = make_reader_optimizer(3e-4, 5)
        nan_at = ()
    else:
        kw = {"warmup": dict(warmup_steps=3), "cosine": dict(warmup_steps=2, total_steps=5),
              "constant": {}}[kind]
        jtx = jyt.make_yolo_optimizer(2e-3, **kw)
        ttx = tyt.make_yolo_optimizer(2e-3, **kw)
        nan_at = (2,)
    rng = np.random.default_rng(7)
    p0 = {"a": rng.normal(size=(3, 4)).astype(np.float32),
          "b": rng.normal(size=(5,)).astype(np.float32)}
    jp, js = {k: jnp.asarray(v) for k, v in p0.items()}, None
    tp = _flat_tree(p0)
    js, ts = jtx.init(jp), ttx.init(tp)
    _state_equal(ts, js, "init")
    for i, g in enumerate(_grads(1, 5, nan_at, size=4.0)):
        ju, js = jtx.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        jp = optax.apply_updates(jp, ju)
        tu, ts = ttx.update(_flat_tree(g), ts, tp)
        tp = optim.apply_updates(tp, tu)
        for k in p0:
            _close(tu[k], ju[k], 1e-6, f"step {i} update {k}")
            _close(tp[k], jp[k], 1e-6, f"step {i} param {k}")
        _state_equal(ts, js, f"step {i}")
    if nan_at:
        assert int(ts["total_notfinite"]) == 1


def test_apply_if_finite_gives_up_after_51_nonfinite_steps():
    jtx, ttx = jyt.make_yolo_optimizer(1e-3), tyt.make_yolo_optimizer(1e-3)
    p0 = {"a": np.ones((3, 4), np.float32), "b": np.zeros((5,), np.float32)}
    jp, tp = {k: jnp.asarray(v) for k, v in p0.items()}, _flat_tree(p0)
    js, ts = jtx.init(jp), ttx.init(tp)
    for i, g in enumerate(_grads(3, 53, nan_at=range(1, 53))):
        ju, js = jtx.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        jp = optax.apply_updates(jp, ju)
        tu, ts = ttx.update(_flat_tree(g), ts, tp)
        tp = optim.apply_updates(tp, tu)
        for k in p0:
            np.testing.assert_array_equal(np.isnan(tp[k].numpy()), np.isnan(np.asarray(jp[k])))
        assert int(ts["notfinite_count"]) == int(js.notfinite_count)
        assert int(ts["total_notfinite"]) == int(js.total_notfinite)
        assert bool(ts["last_finite"]) == bool(js.last_finite)
    assert int(ts["total_notfinite"]) == 52 and np.isnan(tp["b"].numpy()).any()


@pytest.mark.parametrize("which", ["linear", "constant", "join", "warmup_cosine"])
def test_schedules_match_optax(which):
    j, t = {
        "linear": (optax.linear_schedule(0.0, 2e-3, 7), optim.linear_schedule(0.0, 2e-3, 7)),
        "constant": (optax.constant_schedule(3e-4), optim.constant_schedule(3e-4)),
        "join": (optax.join_schedules([optax.linear_schedule(0.0, 1e-3, 4),
                                       optax.constant_schedule(1e-3)], [4]),
                 optim.join_schedules([optim.linear_schedule(0.0, 1e-3, 4),
                                       optim.constant_schedule(1e-3)], [4])),
        "warmup_cosine": (optax.warmup_cosine_decay_schedule(0.0, 2e-3, 5, 40, 1e-4),
                          optim.warmup_cosine_decay_schedule(0.0, 2e-3, 5, 40, 1e-4)),
    }[which]
    for c in range(0, 50):
        _close(t(torch.tensor(c, dtype=torch.int32)), j(jnp.int32(c)), 1e-6, f"count {c}")


# ------------------------------------------------------- packing and biases
def test_targets_from_boxes_matches_jax_and_warns(caplog):
    names = ["resistor", "capacitor", "not_a_class", "text"]
    rng = np.random.default_rng(0)
    per = [[(names[int(rng.integers(0, 4))], *map(int, rng.integers(0, 60, 4)))
            for _ in range(n)] for n in (3, 7, 0)]
    jb = [[JBBox(class_name=c, confidence=1.0, xmin=a, ymin=b, xmax=a + d, ymax=b + e)
           for c, a, b, d, e in item] for item in per]
    tb = [[BBox(class_name=c, confidence=1.0, xmin=a, ymin=b, xmax=a + d, ymax=b + e)
           for c, a, b, d, e in item] for item in per]
    with caplog.at_level(logging.WARNING):
        got = tyt.targets_from_boxes(tb, max_gt=5)
    text = caplog.text
    assert "not in the label map" in text and "not_a_class" in text
    assert "dropping 2 ground-truth boxes over max_gt=5" in text
    ref = jyt.targets_from_boxes(jb, max_gt=5)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.fixture(scope="module")
def tiny():
    """YOLOv11-n at 64 px, 5 classes: JAX variables (batch_stats moved off
    their init so that they are not trivial) and the port model."""
    jm = JYOLO(num_classes=NC, scale="n", reg_max=R)
    v = jax.tree.map(np.asarray, jyolo_init(jm, jax.random.PRNGKey(0), img_size=IMG))
    rng = np.random.default_rng(5)
    v["batch_stats"] = jax.tree.map(
        lambda a: (a + rng.uniform(0.5, 1.5, a.shape) if a.min() > 0
                   else a + rng.normal(0, 0.1, a.shape)).astype(np.float32), v["batch_stats"])
    tm = YOLOv11(num_classes=NC, scale="n", reg_max=R)
    tm.load_state_dict(bridge.state_dict_from_variables(v), strict=True)
    return jm, v, tm


def test_init_detect_biases_matches_jax(tiny):
    _jm, v, tm = tiny
    ref = bridge.state_dict_from_variables(
        jax.tree.map(np.asarray, jyt.init_detect_biases(v, NC, IMG)))
    got = tyt.init_detect_biases(tyt.yolo_params(tm), NC, IMG)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k].numpy(), ref[k].numpy(), err_msg=k)


def _check_moves(before, after, jbefore, jafter, nu, lr, what):
    """Each leaf of `nu`'s change, port (before → after) against JAX
    (jbefore → jafter), within STEP_TOL · lr on every element not at
    round-off (the rule of tests/test_torch_port_train.py, with round-off
    measured against each leaf's largest √ν: from random weights the
    detector's gradients span more than six decades across leaves, the
    head's class biases on top, and a global measure would drop most of
    the backbone)."""
    rms = {n: np.sqrt(x.double().numpy()) for n, x in nu.items()}
    dropped = total = 0
    for n, r in rms.items():
        dj = jafter[n].double().numpy() - jbefore[n].double().numpy()
        dt = after[n].double().numpy() - before[n].double().numpy()
        live = r > ROUNDOFF * r.max() if r.any() else np.ones(r.shape, bool)
        err = np.abs(dt - dj)[live].max(initial=0.0)
        assert err <= STEP_TOL * lr, \
            f"{what} {n}: |Δport − Δjax| {err:.3e} > {STEP_TOL * lr:.3e}"
        dropped, total = dropped + int((~live).sum()), total + live.size
    assert dropped <= MAX_DROPPED * total, f"{what}: {dropped} of {total} elements at round-off"


def _nu(jstate):
    """The Adam second moments of make_yolo_optimizer's state, port names."""
    adam = jstate.inner_state[1][0]
    return bridge.port_tree(jax.tree.map(np.asarray, adam.nu))


@pytest.mark.parametrize("fault", [None, "stats_frozen", "sign"])
def test_yolo_steps_match_jax_after_state_carried_across(tiny, fault):
    """One JAX step, then its variables (batch_stats included) and optax
    state carried into the port (bridge.optax_state_from_jax), then two
    steps in each package: every element's change against JAX's. The
    planted faults — the BatchNorm statistics not updated, the update's
    sign flipped — must fail the same check."""
    jm, v, tm = tiny
    v = jyt.init_detect_biases(v, NC, IMG)
    tx = jyt.make_yolo_optimizer(STEP_LR, warmup_steps=0)
    step = jax.jit(jyt.make_yolo_train_step(jm, tx, jyl.YOLOLossConfig(**CFG)))
    rng = np.random.default_rng(3)
    batches = []
    for k in range(3):
        gb, gc, gv = _gt(30 + k)
        batches.append((rng.uniform(0, 1, (2, IMG, IMG, 3)).astype(np.float32), gb, gc, gv))
    jp, js, _ = step(v, tx.init(v), *batches[0])
    tp = bridge.port_tree(jax.tree.map(np.asarray, jp))
    ts = bridge.optax_state_from_jax(jax.tree.map(np.asarray, js))
    ttx = tyt.make_yolo_optimizer(STEP_LR, warmup_steps=0)
    tstep = tyt.make_yolo_train_step(tm, ttx, tyl.YOLOLossConfig(**CFG))
    stats = [n for n in tp if n.endswith(("running_mean", "running_var"))]
    assert stats
    for i, b in enumerate(batches[1:]):
        jb, tb = bridge.port_tree(jax.tree.map(np.asarray, jp)), tp
        jp, js, jmet = step(jp, js, *b)
        tp, ts, tmet = tstep(tp, ts, *map(torch.from_numpy, b))
        _close(tmet["loss"], jmet["loss"], LOSS_RTOL, f"step {i} loss")
        assert int(tmet["n_fg"]) == int(jmet["n_fg"])
        if fault == "stats_frozen" and i == 1:
            tp = {n: tb[n] if n in stats else p for n, p in tp.items()}
        if fault == "sign" and i == 1:
            tp = {n: 2 * tb[n] - p for n, p in tp.items()}
        ja = bridge.port_tree(jax.tree.map(np.asarray, jp))
        if fault and i == 1:
            with pytest.raises(AssertionError):
                _check_moves(tb, tp, jb, ja, _nu(js), STEP_LR, f"step {i}")
        else:
            _check_moves(tb, tp, jb, ja, _nu(js), STEP_LR, f"step {i}")
    # the statistics moved, as JAX moves them
    assert max(float((tp[n] - bridge.port_tree(jax.tree.map(np.asarray, v))[n]).abs().max())
               for n in stats) > 0.5 * STEP_LR


def _chip_smoke():
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("seed", [0, 1])
def test_card_gate_takes_near_ties_and_rejects_real_differences(seed):
    """chip_smoke.py phase 13's detector-step gate (`assignment_sides`,
    `assignment_ties`) on constructed sides: one side's predictions as
    decoded, the other's the same but for one anchor's score, moved so
    that its metric t for one GT lands just past that GT's k-th best —
    within float32 rounding (a few ulps, a near-tie: the top-k sets of
    both sides differ, and each differing anchor's t lies at the k-th
    best on one side: tied, no real difference) — or half as far again
    (a real difference, which the gate reports)."""
    cs = _chip_smoke()
    cfg = tyl.YOLOLossConfig(**CFG)
    scores, boxes, ap = (torch.from_numpy(np.array(a)) for a in _decoded(_heads(seed)))
    # boxes large enough to hold more than k anchors' centres, one class each
    gb = torch.tensor([[[2, 2, 62, 62], [4, 6, 40, 44], [24, 18, 62, 58]]] * 2, dtype=torch.float32)
    gc = torch.tensor([[0, 1, 2], [3, 1, 4]], dtype=torch.int32)
    gv = torch.ones((2, 3), dtype=torch.bool)
    cpu = cs.assignment_sides(torch, tyl, scores, boxes, ap, gb, gc, gv, cfg)
    k = cfg.topk
    # the GT (unique class in its image) and first anchor past its top k
    # whose t is nearest below the k-th best
    best = None
    for b in range(gb.shape[0]):
        for g in range(gb.shape[1]):
            if not gv[b, g] or int((gc[b][gv[b]] == gc[b, g]).sum()) > 1:
                continue
            order = torch.sort(cpu["align"][b, g], descending=True, stable=True)
            a_n, t_n = int(order.indices[k]), float(order.values[k])
            if t_n > 0 and (best is None or float(cpu["kth"][b, g]) / t_n < best[0]):
                best = (float(cpu["kth"][b, g]) / t_n, b, g, a_n)
    assert best is not None
    ratio, b, g, a_n = best
    cls = int(gc[b, g])
    for push, want_real in ((1 + 8 * 2.0 ** -23, False), (1.5, True)):
        moved = scores.clone()
        # t ∝ score^0.5: squared ratios move t by `push` past the k-th best
        moved[b, a_n, cls] = scores[b, a_n, cls] * (ratio * push) ** 2
        card = cs.assignment_sides(torch, tyl, moved, boxes, ap, gb, gc, gv, cfg)
        tied, real = cs.assignment_ties(torch, card, cpu)
        diff = (card["fg"] != cpu["fg"]) | (card["assigned"] != cpu["assigned"])
        assert bool((card["cand"] != cpu["cand"]).any())
        assert len(tied) + len(real) == int(diff.sum())
        if want_real:
            assert real and any(e["anchor"] == a_n for e in real), (tied, real)
        else:
            assert tied and not real, (tied, real)
            # the targets off the tie agree; the tied GT's anchors are left out
            targets = cs.target_score_errors(torch, card, cpu, tied)
            assert targets["n_over"] == 0 and targets["left_out"] > 1, targets


@pytest.mark.parametrize("seed", [0, 1])
def test_card_gate_holds_target_scores_off_the_ties(seed):
    """Phase 13's target-score gate (`target_score_errors`): one side's
    predictions as decoded, the other's the same but for the assigned
    anchor of largest target that is well inside its GT's top k and not
    its best, whose score moves by an ulp (the targets within float32
    rounding: passes) or by 1e-2 (the assignment the same, its target off
    by ~5e-3 of itself: rejected)."""
    cs = _chip_smoke()
    cfg = tyl.YOLOLossConfig(**CFG)
    scores, boxes, ap = (torch.from_numpy(np.array(a)) for a in _decoded(_heads(seed)))
    gb = torch.tensor([[[2, 2, 62, 62], [4, 6, 40, 44], [24, 18, 62, 58]]] * 2, dtype=torch.float32)
    gc = torch.tensor([[0, 1, 2], [3, 1, 4]], dtype=torch.int32)
    gv = torch.ones((2, 3), dtype=torch.bool)
    cpu = cs.assignment_sides(torch, tyl, scores, boxes, ap, gb, gc, gv, cfg)
    def inside(b, a):
        g = int(cpu["assigned"][b, a])
        t = cpu["align"][b, g]
        best = float(t[cpu["fg"][b] & (cpu["assigned"][b] == g)].max())
        return 1.01 * float(cpu["kth"][b, g]) <= float(t[a]) < best
    b, a = max((ba for ba in cpu["fg"].nonzero().tolist() if inside(*ba)),
               key=lambda ba: float(cpu["target"][ba[0], ba[1]].max()))
    cls = int(gc[b, int(cpu["assigned"][b, a])])
    for push, rejected in ((1 + 2.0 ** -23, False), (1 + 1e-2, True)):
        moved = scores.clone()
        moved[b, a, cls] = scores[b, a, cls] * push
        card = cs.assignment_sides(torch, tyl, moved, boxes, ap, gb, gc, gv, cfg)
        assert cs.assignment_ties(torch, card, cpu) == ([], [])
        targets = cs.target_score_errors(torch, card, cpu, [])
        assert (targets["n_over"] > 0) == rejected, targets
