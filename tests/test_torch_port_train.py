"""The port's SAM2 fine-tune (circuitvision_tpu_torch/train/) against the
JAX package's (circuitvision_tpu/train/) on the CPU: the five losses,
whole-tree and selective gradients, the trainable surface, the optimizer
(Adam with optax's formulas, schedules, accumulation, EMA) step for step
after the JAX state is carried across, the LoRA step and its export,
checkpoint resume and the restore of a JAX-written checkpoint, the
folder dataset, the kernel gate's routing, and max-pool gradients at
ties.

Tolerance, unless a test states another with its reason: max |port − jax|
≤ 1e-4 · max(1, max |jax|) per leaf, in float32, JAX under
jax.default_matmul_precision("highest"). Model-level tests run
`scripts/train_demo.py:small_cfg` at resolution 64 (8 Hiera blocks,
a global block, q-pool transitions; 6.2 M parameters).
"""
import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from circuitvision_tpu.core.config import SAM2Config as JSAM2Config
from circuitvision_tpu.core.config import TrainConfig as JTrainConfig
from circuitvision_tpu.models.sam2 import hiera as jhiera
from circuitvision_tpu.models.sam2.wrapper import SAM2ImageSegmenter as JSAM2
from circuitvision_tpu.models.sam2.wrapper import init_params as jsam2_init
from circuitvision_tpu.train import checkpoint as jckpt
from circuitvision_tpu.train import lora as jlora
from circuitvision_tpu.train import losses as jlosses
from circuitvision_tpu.train import train_step as jts
from circuitvision_tpu.train.data import SegmentationFolderDataset as JDataset
from circuitvision_tpu_torch.core import config as tconfig
from circuitvision_tpu_torch.models import bridge
from circuitvision_tpu_torch.models.sam2 import hiera as thiera
from circuitvision_tpu_torch.models.sam2 import wrapper as twrapper
from circuitvision_tpu_torch.models.sam2.wrapper import SAM2ImageSegmenter as TSAM2
from circuitvision_tpu_torch.ops.cuda import flash_attn as fa
from circuitvision_tpu_torch.ops.cuda.build import KernelError
from circuitvision_tpu_torch.train import checkpoint as tckpt
from circuitvision_tpu_torch.train import lora as tlora
from circuitvision_tpu_torch.train import losses as tlosses
from circuitvision_tpu_torch.train import train_step as tts
from circuitvision_tpu_torch.train.data import SegmentationFolderDataset as TDataset

ROOT = Path(__file__).resolve().parents[1]
RTOL = 1e-4
#: scripts/train_demo.py:small_cfg at resolution 64
SMALL = dict(resolution=64, embed_dim=48, num_heads=2, stages=(1, 2, 4, 1),
             global_att_blocks=(5,), window_spec=(8, 4, 8, 4),
             backbone_channel_list=(384, 192, 96, 48), decoder_mlp_dim=256, dtype="float32")


@pytest.fixture(autouse=True)
def _exact_matmuls():
    with jax.default_matmul_precision("highest"):
        yield


def _close(got, ref, rtol=RTOL, what=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, what
    err, bound = np.abs(got - ref).max(initial=0.0), rtol * max(1.0, np.abs(ref).max(initial=0))
    assert err <= bound, f"{what}: {err:.3e} > {bound:.3e}"


def _port(tree):
    """A JAX params-shaped tree (numpy leaves) → {port name: array}."""
    return {k: v.numpy() for k, v in bridge.state_dict_from_variables(
        jax.tree.map(np.asarray, tree)).items()}


@pytest.fixture(scope="module")
def small():
    cfg = JSAM2Config(**SMALL)
    jm = JSAM2(cfg=cfg)
    v = jax.tree.map(np.asarray, jsam2_init(jm, jax.random.PRNGKey(0)))
    tm = TSAM2(tconfig.SAM2Config(**SMALL))
    tm.load_state_dict(bridge.state_dict_from_variables(v), strict=True)
    rng = np.random.default_rng(1)
    images = rng.random((2, 64, 64, 3), np.float32)
    masks = (rng.random((2, 64, 64)) > 0.7).astype(np.float32)
    return jm, v, tm, images, masks


def _params(tm):
    return {n: p.detach().clone() for n, p in tm.named_parameters()}


def _tcfg(jcfg):
    return tconfig.TrainConfig(**dataclasses.asdict(jcfg))


# ----------------------------------------------------------------- losses
def test_losses_match_jax():
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((3, 40, 56)) * 3).astype(np.float32)
    logits[0, 0, :4] = 0.0  # ties of jnp.maximum
    targets = (rng.random((3, 40, 56)) > 0.6).astype(np.float32)
    iou = rng.random((3, 1)).astype(np.float32)
    jl, jt, ji = map(jnp.asarray, (logits, targets, iou))
    tl, tt, ti = map(torch.from_numpy, (logits, targets, iou))
    for name in ("dice_loss", "focal_loss", "frequency_loss"):
        _close(getattr(tlosses, name)(tl, tt), getattr(jlosses, name)(jl, jt), what=name)
    _close(tlosses.iou_prediction_loss(ti, tl, tt), jlosses.iou_prediction_loss(ji, jl, jt))
    cfg = JTrainConfig(focal_gamma=1.5, dice_smooth=1e-3)
    (jtot, jmet), jgrad = jax.value_and_grad(
        lambda x: jlosses.combined_loss(x, ji, jt, cfg), has_aux=True)(jl)
    tx = tl.clone().requires_grad_()
    ttot, tmet = tlosses.combined_loss(tx, ti, tt, _tcfg(cfg))
    (tgrad,) = torch.autograd.grad(ttot, tx)
    for k in jmet:
        _close(tmet[k], jmet[k], what=k)
    _close(tgrad, jgrad, what="d combined / d logits")


# -------------------------------------------------------- trainable surface
def test_trainable_set_equals_jax_mask(small):
    jm, v, tm, *_ = small
    jmask = jts.trainable_mask(v)
    want = {"/".join(str(getattr(p, "key", p)) for p in path)
            for path, m in jax.tree_util.tree_flatten_with_path(jmask)[0] if m}
    names = bridge.flax_names(tm)
    got = {names[n] for n, m in tts.trainable_mask(tm).items() if m}
    assert got == want and len(got) > 20
    # every port parameter maps to a JAX leaf and back
    assert {bridge.port_key(tuple(p.split("/"))) for p in names.values()} == set(names)
    assert len(names) == len(jax.tree_util.tree_leaves(v))
    assert tts._trunk_diff_cutoff(tts.trainable_mask(tm)) == 1 << 30
    mask = tts.trainable_mask(tm)
    mask.update({n: True for n in mask if n.startswith("trunk.blocks_6.")})
    assert tts._trunk_diff_cutoff(mask) == 6


# ------------------------------------------------------------- gradients
@pytest.fixture(scope="module")
def jax_grads(small):
    jm, v, _tm, images, masks = small
    cfg = JTrainConfig()

    def loss_fn(params):
        high, _low, iou = jm.apply(params, jnp.asarray(images))
        return jlosses.combined_loss(high[..., 0], iou, jnp.asarray(masks), cfg)

    with jhiera.force_fused(False):
        (loss, metrics), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(v)
    return float(loss), {k: float(x) for k, x in metrics.items()}, _port(grads)


def test_whole_tree_gradients_match_jax(small, jax_grads):
    _jm, _v, tm, images, masks = small
    jloss, jmet, jgrads = jax_grads
    loss, metrics, grads = tts.loss_and_grads(tm, _params(tm), torch.from_numpy(images),
                                              torch.from_numpy(masks), selective=False)
    _close(loss, jloss, what="loss")
    for k in jmet:
        _close(metrics[k], jmet[k], what=k)
    assert set(grads) == set(jgrads)
    for n, g in grads.items():
        _close(g, jgrads[n], what=n)


def test_selective_gradients_match_whole_tree_and_jax(small, jax_grads):
    """The reference surface (no trunk leaf: the whole trunk keeps its
    kernels — their plain versions on the CPU) and a surface reaching
    trunk block 6 (cutoff 6: blocks 0-5 on the kernels, 6-7 on the module
    path). Trainable leaves equal the whole-tree and JAX gradients within
    the tolerance — the kernels' plain versions round differently from
    the module path, so not bitwise — and frozen leaves get zeros."""
    _jm, _v, tm, images, masks = small
    _jloss, _jmet, jgrads = jax_grads
    params = _params(tm)
    args = (torch.from_numpy(images), torch.from_numpy(masks))
    _l, _m, whole = tts.loss_and_grads(tm, params, *args, selective=False)
    base = tts.trainable_mask(tm)
    reach = {**base, **{n: True for n in base if n.startswith(("trunk.blocks_6.",
                                                               "trunk.blocks_7."))}}
    for mask in (base, reach):
        _l, _m, grads = tts.loss_and_grads(tm, params, *args, mask=mask, selective=True)
        for n, g in grads.items():
            if mask[n]:
                _close(g, whole[n], what=n)
                _close(g, jgrads[n], what=n)
            else:
                assert not g.any(), n


# ------------------------------------------------------------- optimizer
def _toy_tree(rng):
    return {"params": {
        "a": {"kernel": rng.standard_normal((3, 4)).astype(np.float32),
              "bias": rng.standard_normal((4,)).astype(np.float32)},
        "c": {"kernel": rng.standard_normal((2, 2, 3, 5)).astype(np.float32)},
        "d": {"scale": rng.standard_normal((5,)).astype(np.float32)}}}


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("sched", [dict(), dict(warmup_steps=2),
                                   dict(schedule="cosine", warmup_steps=1, total_steps=4,
                                        min_lr_ratio=0.1)])
def test_optimizer_matches_optax_step_for_step(sched, accum):
    """make_optimizer's Adam (hard-frozen leaf "a/bias"), schedules and
    accumulation against the JAX package's optax chain on the same
    gradients, six micro-steps, params and the carried state compared
    after each."""
    rng = np.random.default_rng(0)
    tree = _toy_tree(rng)
    jmask = jax.tree.map(lambda x: True, tree)
    jmask["params"]["a"]["bias"] = False
    cfg = JTrainConfig(learning_rate=3e-2, grad_accum_steps=accum, **sched)
    tx, _ = jts.make_optimizer(tree, cfg, mask=jmask)
    jstate = tx.init(tree)
    names = _port(tree)
    tmask = {n: n != "a.bias" for n in names}
    opt = tts.Optimizer(_tcfg(cfg), tmask)
    tparams = {n: torch.from_numpy(a.copy()) for n, a in names.items()}
    tstate = opt.init(tparams)
    jparams = tree
    for step in range(6):
        g = jax.tree.map(lambda x: rng.standard_normal(x.shape).astype(np.float32), tree)
        upd, jstate = tx.update(g, jstate, jparams)
        jparams = jax.tree.map(np.asarray, optax.apply_updates(jparams, upd))
        tupd, tstate = opt.update({n: torch.from_numpy(a) for n, a in _port(g).items()}, tstate)
        tparams = tts.apply_updates(tparams, tupd)
        _p, carried, _e = bridge.train_state_from_jax(jparams, jax.tree.map(np.asarray, jstate))
        assert set(carried) == set(tstate)
        for n, a in _port(jparams).items():
            _close(tparams[n], a, 1e-6, f"step {step} {n}")
        assert torch.equal(tparams["a.bias"], torch.from_numpy(names["a.bias"]))
        for key in ("count", "schedule_count", "mini_step", "gradient_step"):
            if key in carried:
                assert int(carried[key]) == int(tstate[key]), key
        for key in ("mu", "nu", "acc_grads"):
            if key in carried:
                assert set(carried[key]) == set(tstate[key]) == {"a.weight", "c.weight", "d.weight"}
                for n in carried[key]:
                    _close(tstate[key][n], carried[key][n], 1e-6, f"step {step} {key} {n}")


def test_learning_rate_schedules_match_optax():
    for sched in (dict(warmup_steps=3), dict(schedule="cosine", total_steps=7),
                  dict(schedule="cosine", warmup_steps=2, total_steps=9, min_lr_ratio=0.05)):
        cfg = JTrainConfig(learning_rate=2e-3, **sched)
        jfn, tfn = jts.learning_rate_schedule(cfg), tts.learning_rate_schedule(_tcfg(cfg))
        for count in range(12):
            assert float(tfn(count)) == float(jfn(jnp.int32(count))), (sched, count)
    assert tts.learning_rate_schedule(tconfig.TrainConfig()) == 1e-3
    with pytest.raises(ValueError, match="total_steps"):
        tts.learning_rate_schedule(tconfig.TrainConfig(schedule="cosine"))
    with pytest.raises(ValueError, match="grad_accum_steps"):
        tconfig.TrainConfig(grad_accum_steps=0)


#: The whole-step comparisons run Adam at a normal learning rate and hold
#: each parameter's CHANGE over a step (after − before) to JAX's within
#: STEP_TOL · lr per element. Adam moves an element by about lr · m̂/√v̂
#: whatever the gradient's size, so an element whose gradient is zero but
#: for rounding (a key projection's bias, which softmax ignores, is the
#: usual one: 1e-12 to 1e-9 here) may move by up to lr in either package
#: and either direction. So the elements with √ν ≤ ROUNDOFF · (the largest
#: √ν in the tree), ν read from JAX's state after the step, are left out
#: and counted: at small_cfg 5 % of the whole tree's elements, 8 % of the
#: selective surface's and 3 % of the adapters' — nearly all of them exact
#: zeros, hidden units of the decoder's MLPs that the ReLU shuts, which
#: the port leaves unmoved too — and never more than MAX_DROPPED of them.
#: A leaf that JAX's gradient never reaches (ν ≡ 0: the unused mask
#: outputs' hypernetworks) is compared whole, and the tests hold its
#: parameters bit-unchanged, as they hold the frozen leaves.
STEP_LR, STEP_TOL, ROUNDOFF, MAX_DROPPED = 1e-3, 1e-2, 1e-6, 0.1


def _check_moves(before, after, jbefore, jafter, nu, lr, what):
    """Each leaf of `nu`'s change, port (before → after, tensors) against
    JAX (jbefore → jafter, arrays), within STEP_TOL · lr on every element
    not at round-off; returns (elements dropped, elements, the largest
    change JAX made to a compared element)."""
    rms = {n: np.sqrt(np.asarray(x, np.float64)) for n, x in nu.items()}
    top = max(r.max(initial=0.0) for r in rms.values())
    dropped = total = 0
    moved = 0.0
    for n, r in rms.items():
        dj = np.asarray(jafter[n], np.float64) - np.asarray(jbefore[n], np.float64)
        dt = after[n].double().numpy() - before[n].double().numpy()
        live = r > ROUNDOFF * top if r.any() else np.ones(r.shape, bool)
        err = np.abs(dt - dj)[live].max(initial=0.0)
        assert err <= STEP_TOL * lr, \
            f"{what} {n}: |Δport − Δjax| {err:.3e} > {STEP_TOL * lr:.3e}"
        dropped, total = dropped + int((~live).sum()), total + live.size
        moved = max(moved, np.abs(dj[live]).max(initial=0.0))
    assert dropped <= MAX_DROPPED * total, f"{what}: {dropped} of {total} elements at round-off"
    return dropped, total, moved


@pytest.mark.parametrize("selective,sched", [
    (False, dict(ema_decay=0.9)),
    (True, dict(schedule="cosine", warmup_steps=1, total_steps=4, min_lr_ratio=0.1,
                grad_accum_steps=2, ema_decay=0.8)),
])
def test_train_steps_match_jax_after_state_carried_across(small, selective, sched, monkeypatch):
    """JAX steps until the first update, its (params, optimizer state,
    EMA) carried into the port (bridge.train_state_from_jax), then two more
    steps in each package — whole-tree: two updates; selective with
    accumulation 2: a micro-step, which must change nothing, then an
    update at the schedule's full rate. After each: every trainable
    leaf's and EMA leaf's change against JAX's (`_check_moves`), frozen
    leaves bit-unchanged, the moments against JAX's at the gradient
    tolerance (√ν for ν). Then planted faults in the last step — its
    update not applied, or applied with the sign flipped — must fail the
    same check."""
    jm, v, tm, images, masks = small
    cfg = JTrainConfig(learning_rate=STEP_LR, **sched)
    jmask = jts.trainable_mask(v) if selective else jax.tree.map(lambda x: True, v)
    tx, jmask = jts.make_optimizer(v, cfg, mask=jmask)
    step = jax.jit(jts.make_train_step(jm, tx, cfg, mask=jmask, selective=selective))
    jparams, jstate, jema = v, tx.init(v), jts.init_ema(v, jmask)
    # two batches in turn, so that the micro-steps' gradients differ
    batches = [(images, masks), (images[:, ::-1].copy(), masks[:, ::-1].copy())]
    jargs = [tuple(map(jnp.asarray, b)) for b in batches]
    targs = [tuple(map(torch.from_numpy, b)) for b in batches]
    for k in range(cfg.grad_accum_steps):  # up to and including the first update
        jparams, jstate, _ = step(jparams, jstate, *jargs[k % 2])
    jema = jts.update_ema(jema, jparams, jmask, cfg.ema_decay)
    tmask = tts.trainable_mask(tm) if selective else {n: True for n, _ in tm.named_parameters()}
    trainable = [n for n, m in tmask.items() if m]
    opt, tmask = tts.make_optimizer(tm, _tcfg(cfg), tmask)

    def carry(jparams, jstate, jema):
        return bridge.train_state_from_jax(
            jax.tree.map(np.asarray, jparams), jax.tree.map(np.asarray, jstate),
            [np.asarray(e) for e in jema], trainable)

    tparams, tstate, tema = carry(jparams, jstate, jema)
    ja, cema = _port(jparams), tema
    tstep = tts.make_train_step(tm, opt, _tcfg(cfg), mask=tmask, selective=selective)
    for i in range(2):
        what, flush = f"step {i + 1}", (i + 1) % cfg.grad_accum_steps == 0
        b = (cfg.grad_accum_steps + i) % 2
        jb, jemab, tb, tsb, temab = ja, cema, tparams, tstate, tema
        jparams, jstate, jmet = step(jparams, jstate, *jargs[b])
        jema = jts.update_ema(jema, jparams, jmask, cfg.ema_decay) if flush else jema
        tparams, tstate, tmet = tstep(tparams, tstate, *targs[b])
        tema = tts.update_ema(tema, tparams, cfg.ema_decay) if flush else tema
        _close(tmet["loss"], jmet["loss"], what=f"{what} loss")
        _p, carried, cema = carry(jparams, jstate, jema)
        ja = _port(jparams)
        dropped, total, moved = _check_moves(tb, tparams, jb, ja, carried["nu"], STEP_LR, what)
        assert (moved >= 0.5 * STEP_LR) == flush, (what, moved)  # an update moves, a micro-step not
        _check_moves(temab, tema, jemab, cema, carried["nu"], STEP_LR, f"{what} ema")
        for n in tmask:  # frozen, or out of the gradient's reach
            if not tmask[n] or not carried["nu"][n].any():
                assert torch.equal(tparams[n], tb[n]), n
        for key in ("mu", "acc_grads"):
            for n in carried.get(key, {}):
                # the moments hold gradients: the gradient tolerance
                _close(tstate[key][n], carried[key][n], what=f"{what} {key} {n}")
        for n in carried["nu"]:
            _close(tstate["nu"][n].sqrt(), carried["nu"][n].sqrt(), what=f"{what} √ν {n}")
        assert int(tstate["count"]) == int(carried["count"])
    assert dropped > 0  # the rule is needed: round-off elements are there
    for fault in (lambda p, u: dict(p),
                  lambda p, u, real=tts.apply_updates: real(p, {n: -x for n, x in u.items()})):
        with monkeypatch.context() as m:
            m.setattr(tts, "apply_updates", fault)
            bad, _s, _m = tstep(tb, tsb, *targs[b])
        with pytest.raises(AssertionError, match="Δport"):
            _check_moves(tb, bad, jb, ja, carried["nu"], STEP_LR, "planted fault")


# ------------------------------------------------------------------ LoRA
@pytest.fixture(scope="module")
def lora_pair(small):
    jm, v, tm, images, masks = small
    cfg = JTrainConfig(learning_rate=STEP_LR)
    jtstate = jlora.init_train_state(v, jax.random.PRNGKey(5), cfg, n_trunk_blocks=8)
    tx = jlora.make_lora_optimizer(cfg)
    step = jax.jit(jlora.make_lora_train_step(jm, tx, cfg))
    jopt = tx.init(jtstate)
    # one JAX step from PEFT's init (B = 0), so the carried B is nonzero
    jtstate, jopt, _ = step(v, jtstate, jopt, jnp.asarray(images), jnp.asarray(masks))
    return cfg, jtstate, jopt, step


def test_lora_surface_and_step_zero_is_the_base_forward(small):
    """36 targets at Hiera-L's depth; at this config the ones present, as
    the JAX package finds them; PEFT's zero B reproduces the base forward
    bitwise."""
    _jm, v, tm, images, _masks = small
    assert len(tlora.reference_lora_paths()) == 36
    assert tlora.reference_lora_paths(8) == jlora.reference_lora_paths(8)
    assert tlora.lora_target_paths(tm, 8) == jlora.lora_target_paths(v, 8)
    gen = torch.Generator().manual_seed(0)
    tstate = tlora.init_train_state(tm, gen, tconfig.TrainConfig(), n_trunk_blocks=8)
    assert set(tstate["lora"]) == set(jlora.lora_target_paths(v, 8))
    for path, ab in tstate["lora"].items():
        jk = jlora._kernel_index(v)[path]
        bound = 1.0 / np.sqrt(np.prod(jk.shape[:-1]))
        assert ab["a"].shape == (*jk.shape[:-1], 4) and ab["b"].shape == (4, jk.shape[-1])
        assert float(ab["a"].abs().max()) <= bound and not ab["b"].any()
    direct = {n for n, m in tlora.direct_mask(tm).items() if m}
    assert set(tstate["direct"]) == direct
    base = _params(tm)
    merged = tlora.merge_lora({**base, **tstate["direct"]}, tstate["lora"],
                              tlora._kernel_index(tm))
    x = torch.from_numpy(images)
    with torch.no_grad():
        ref = torch.func.functional_call(tm, base, (x,))
        got = torch.func.functional_call(tm, merged, (x,))
    assert all(torch.equal(a, b) for a, b in zip(got, ref))


def test_lora_step_fold_and_export_match_jax(small, lora_pair, monkeypatch):
    jm, v, tm, images, masks = small
    cfg, jtstate, jopt, step = lora_pair
    tcfg = _tcfg(cfg)
    np_state = jax.tree.map(np.asarray, jtstate)
    ttstate, topt = bridge.lora_state_from_jax(np_state, jax.tree.map(np.asarray, jopt))
    # fold and export of the carried adapters against the JAX package's
    jfold = _port(jlora.fold_lora(v, np_state["lora"], cfg))
    tfold = tlora.fold_lora(tm, _params(tm), ttstate["lora"], tcfg)
    for n, a in jfold.items():
        _close(tfold[n], a, 1e-6, n)
    jexp, texp = jlora.export_peft_state(np_state["lora"]), tlora.export_peft_state(ttstate["lora"])
    assert set(jexp) == set(texp) and len(texp) == 2 * len(np_state["lora"])
    for k in jexp:
        np.testing.assert_array_equal(texp[k], jexp[k])
    # one more step in each package from the same state: each adapter's
    # and direct leaf's change against JAX's (`_check_moves`), then planted
    # faults — the update not applied, or with its sign flipped — must fail
    before, jbefore = tlora.flat_names(ttstate), {n: t.numpy() for n, t in
                                                   tlora.flat_names(ttstate).items()}
    state0 = (ttstate, topt)
    jtstate, jopt, jmet = step(v, jtstate, jopt, jnp.asarray(images), jnp.asarray(masks))
    tstep = tlora.make_lora_train_step(tm, tlora.make_lora_optimizer(tcfg), tcfg)
    targs = (torch.from_numpy(images), torch.from_numpy(masks))
    ttstate, topt, tmet = tstep(_params(tm), *state0, *targs)
    _close(tmet["loss"], jmet["loss"], what="loss")
    want, wopt = bridge.lora_state_from_jax(jax.tree.map(np.asarray, jtstate),
                                            jax.tree.map(np.asarray, jopt))
    jafter = {n: t.numpy() for n, t in tlora.flat_names(want).items()}
    after = tlora.flat_names(ttstate)
    assert set(after) == set(jafter) == set(wopt["nu"])
    _d, _t, moved = _check_moves(before, after, jbefore, jafter, wopt["nu"], STEP_LR, "LoRA")
    assert moved >= 0.5 * STEP_LR
    for fault in (lambda p, u: dict(p),
                  lambda p, u, real=tlora.apply_updates: real(p, {n: -x for n, x in u.items()})):
        with monkeypatch.context() as m:
            m.setattr(tlora, "apply_updates", fault)
            bad, _o, _m = tstep(_params(tm), *state0, *targs)
        with pytest.raises(AssertionError, match="Δport"):
            _check_moves(before, tlora.flat_names(bad), jbefore, jafter, wopt["nu"], STEP_LR,
                         "planted fault")
    served = tlora.materialize(tm, _params(tm), ttstate, tcfg)
    jserved = _port(jlora.materialize(v, jax.tree.map(np.asarray, jtstate), cfg))
    for n, a in jserved.items():
        _close(served[n], a, what=n)


# ------------------------------------------------------------ checkpoints
def _tiny_port():
    cfg = tconfig.SAM2Config(resolution=64, embed_dim=16, num_heads=2, stages=(1, 1, 1, 1),
                             global_att_blocks=(2,), window_spec=(4, 2, 4, 2),
                             backbone_channel_list=(128, 64, 32, 16), decoder_mlp_dim=32,
                             dtype="float32")
    tm = TSAM2(cfg)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in tm.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.1)
    return tm


def test_checkpoint_resume_is_bit_exact(tmp_path):
    """Four steps uninterrupted against two steps, a save, an interrupted
    write of step 3 (payload without its commit marker), a restore onto
    fresh templates and two more steps: params, optimizer state and EMA
    bit-equal."""
    tm = _tiny_port()
    cfg = tconfig.TrainConfig(schedule="cosine", warmup_steps=1, total_steps=4,
                              grad_accum_steps=2, ema_decay=0.9)
    opt, mask = tts.make_optimizer(tm, cfg)
    step = tts.make_train_step(tm, opt, cfg, mask=mask)
    rng = np.random.default_rng(0)
    batches = [(torch.from_numpy(rng.random((2, 64, 64, 3), np.float32)),
                torch.from_numpy((rng.random((2, 64, 64)) > 0.7).astype(np.float32)))
               for _ in range(4)]

    def run(params, state, ema, bs):
        for images, masks in bs:
            params, state, _ = step(params, state, images, masks)
            ema = tts.update_ema(ema, params, cfg.ema_decay)
        return params, state, ema

    p0 = _params(tm)
    ref = run(p0, opt.init(p0), tts.init_ema(p0, mask), batches)
    mid = run(p0, opt.init(p0), tts.init_ema(p0, mask), batches[:2])
    tckpt.save_train_state(str(tmp_path), 2, *mid[:2], extra=mid[2])
    torn = tckpt.save_train_state(str(tmp_path), 3, *mid[:2], extra=mid[2])
    Path(torn + ".DONE").unlink()  # interrupted: never committed
    step_n, path = tckpt.latest_checkpoint(str(tmp_path))
    assert step_n == 2
    fresh = _params(_tiny_port())
    restored = tckpt.restore_train_state(path, fresh, opt.init(fresh),
                                         tts.init_ema(fresh, mask))
    got = run(*restored, batches[2:])
    for a, b in zip(got, ref):
        fa, fb = tckpt._flat(a), tckpt._flat(b)
        assert set(fa) == set(fb)
        for k in fa:
            assert torch.equal(fa[k], fb[k]) and fa[k].dtype == fb[k].dtype, k
    with pytest.raises(ValueError, match="extra"):
        tckpt.restore_train_state(path, fresh, opt.init(fresh))
    tckpt.save_train_state(str(tmp_path), 5, *mid[:2], extra=mid[2])
    tckpt.prune_checkpoints(str(tmp_path), keep=1)
    assert tckpt.latest_checkpoint(str(tmp_path))[0] == 5
    assert not (tmp_path / "step_00000002").exists()


@pytest.mark.parametrize("sched", [dict(), dict(schedule="cosine", total_steps=5,
                                                grad_accum_steps=2)])
def test_restore_of_a_jax_written_train_checkpoint(small, tmp_path, sched):
    """The JAX package's save_train_state (orbax) of params, a
    make_optimizer state and an EMA list, with every leaf made distinct,
    read by the port: the same values as the state carried across in
    memory (bridge.train_state_from_jax)."""
    _jm, v, tm, *_ = small
    cfg = JTrainConfig(**sched)
    tx, jmask = jts.make_optimizer(v, cfg)
    rng = np.random.default_rng(3)
    # device arrays, as a run saves them
    state = jax.tree.map(lambda x: jnp.int32(rng.integers(1, 9)) if np.ndim(x) == 0
                         else jnp.asarray(rng.standard_normal(np.shape(x)), jnp.float32),
                         tx.init(v))
    ema = [jnp.asarray(rng.standard_normal(np.shape(x)), jnp.float32)
           for x in jts.init_ema(v, jmask)]
    path = jckpt.save_train_state(str(tmp_path), 7, v, state, extra=ema)
    trainable = [n for n, m in tts.trainable_mask(tm).items() if m]
    params, got, got_ema = tckpt.restore_jax_train_state(path, trainable, _tcfg(cfg), extra=True,
                                                         device="cpu")
    want_params, want, want_ema = bridge.train_state_from_jax(
        v, jax.tree.map(np.asarray, state), [np.asarray(e) for e in ema], trainable)
    for n, t in want_params.items():
        assert torch.equal(params[n], t), n
    assert set(got) == set(want)
    for k, t in want.items():
        if isinstance(t, dict):
            assert set(got[k]) == set(t) == set(trainable)
            assert all(torch.equal(got[k][n], t[n]) for n in t), k
        else:
            assert int(got[k]) == int(t), k
    assert all(torch.equal(got_ema[n], want_ema[n]) for n in want_ema)


# ---------------------------------------------------------------- dataset
def test_dataset_batches_match_jax():
    """Two shards' first batches, augmented: the same (perm, code) streams
    and the same preprocessed pixels; masks bit-equal."""
    root = str(ROOT / "eval_data")
    jds, tds = JDataset(root, resolution=64), TDataset(root, resolution=64, device="cpu")
    assert len(tds) == len(jds) == 63 and tds.items == jds.items
    for shard in ((0, 2), (1, 2)):
        jb = jds.batches(2, seed=4, augment=True, shard=shard)
        tb = tds.batches(2, seed=4, augment=True, shard=shard)
        for _ in range(2):
            (ji, jmk), (ti, tmk) = next(jb), next(tb)
            _close(ti, ji, 1e-5, "images")
            np.testing.assert_array_equal(tmk.numpy(), jmk)
        jb.close()
        tb.close()
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            TDataset(root, resolution=64)


# ------------------------------------------------------------ the gate
def test_gate_routes_no_kernel_at_or_past_the_cutoff(monkeypatch):
    """Under force_fused(N), no trunk block ≥ N and no non-trunk site calls a
    kernel wrapper; blocks < N still do; force_fused(False) calls none and
    the serving default (None) calls them in every block."""
    tm = _tiny_port()
    calls = []
    current = {"block": None}
    for i in range(4):
        getattr(tm.trunk, f"blocks_{i}").register_forward_pre_hook(
            lambda m, a, i=i: current.update(block=i))
    tm.neck.register_forward_pre_hook(lambda m, a: current.update(block=None))
    for mod, name in ((thiera, "mlp_block"), (thiera, "window_attn_block"),
                      (thiera, "qpool_attn_block"), (thiera, "window_attn_block_tiled"),
                      (twrapper, "refinement")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _r=real, _n=name, **k: calls.append(
            (_n, current["block"])) or _r(*a, **k))
    x = torch.from_numpy(np.random.default_rng(0).random((1, 64, 64, 3), np.float32))
    with torch.no_grad():
        for gate in (2, False, None):
            calls.clear()
            with thiera.force_fused(gate):
                tm(x)
            blocks = {b for _n, b in calls}
            if gate is False:
                assert not calls
            elif gate is None:
                assert blocks == {0, 1, 2, 3, None} and ("refinement", None) in calls
            else:
                assert blocks == {0, 1}


def test_flash_route_walk_and_head_widths():
    """The module path's FlashAttention blocks, walked from the config as
    Hiera.forward runs them: Hiera-L@1024's globals 23/33/43 (4096 tokens,
    heads of 72), Hiera-t@1024's 5/7/9 (heads of 96), none at t@512 (1024
    tokens) or from a start past the last; and the widths the card's
    kernels take: bfloat16 heads a multiple of 8 up to 96 (instances at 72
    and 96), float32 up to 128. On the CPU nothing is refused."""
    def trunk(**kw):
        with torch.device("meta"):
            return TSAM2(tconfig.SAM2Config(**kw)).trunk
    big = trunk()
    assert thiera.flash_blocks(big, 1024) == [(23, 4096, 72), (33, 4096, 72), (43, 4096, 72)]
    assert thiera.flash_blocks(big, 1024, start=44) == []
    t = dict(embed_dim=96, num_heads=1, stages=(1, 2, 7, 2), global_att_blocks=(5, 7, 9),
             window_spec=(8, 4, 14, 7))
    assert thiera.flash_blocks(trunk(resolution=1024, **t), 1024) == [
        (5, 4096, 96), (7, 4096, 96), (9, 4096, 96)]
    assert thiera.flash_blocks(trunk(resolution=512, **t), 512) == []
    ok = fa.grad_head_width_ok
    assert ok(72, torch.bfloat16) and ok(64, torch.bfloat16) and ok(96, torch.float32)
    assert ok(96, torch.bfloat16) and ok(88, torch.bfloat16)
    assert not ok(60, torch.bfloat16) and not ok(104, torch.bfloat16)
    assert not ok(136, torch.float32)
    with torch.device("meta"):
        wide = TSAM2(tconfig.SAM2Config(resolution=1024, **t)).to(torch.bfloat16)
    tts.check_flash_widths(wide, 0)


def test_check_flash_widths_on_the_card_admits_t_at_1024_and_refuses_other_widths(monkeypatch):
    """check_flash_widths as it runs for a model on the card (the weight's
    is_cuda seen as true): bfloat16 Hiera-t@1024 (global heads of 96) is
    admitted, and so is L@1024 (72); a layout whose global heads are 104
    wide, or 60, is refused before any step with its width and the
    kernels' instance widths named; in float32 the 104-wide model is
    taken."""
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    t = dict(embed_dim=96, num_heads=1, stages=(1, 2, 7, 2), global_att_blocks=(5, 7, 9),
             window_spec=(8, 4, 14, 7))

    def model(dtype, **kw):
        with torch.device("meta"):
            return TSAM2(tconfig.SAM2Config(resolution=1024, **{**t, **kw})).to(dtype)
    tts.check_flash_widths(model(torch.bfloat16), 0)
    with torch.device("meta"):
        tts.check_flash_widths(TSAM2(tconfig.SAM2Config()).to(torch.bfloat16), 0)
    for embed in (104, 60):
        with pytest.raises(KernelError, match=f"widths 72, 96.*heads of width {embed} "):
            tts.check_flash_widths(model(torch.bfloat16, embed_dim=embed), 0)
    tts.check_flash_widths(model(torch.float32, embed_dim=104), 0)


def test_restore_jax_train_state_defaults_to_the_card(monkeypatch, tmp_path):
    """Like every entry point of the port, restore_jax_train_state runs on
    CUDA unless device="cpu" is passed: without a card the default raises
    and says so, before reading anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tckpt.restore_jax_train_state(str(tmp_path / "missing"), [], _tcfg(JTrainConfig()))


# ------------------------------------------------------- max-pool ties
def test_qpool_max_pool_gradient_credits_the_same_element_at_ties():
    """Both packages credit the FIRST maximal element of each 2 × 2 window
    in row-major order: JAX's nn.max_pool gradient (select_and_scatter with
    a ≥ select) and F.max_pool2d's (a strict > scan) — on an input of
    three levels, where most windows hold ties."""
    rng = np.random.default_rng(0)
    x = rng.integers(0, 3, (2, 6, 8, 5)).astype(np.float32)
    dy = rng.standard_normal((2, 3, 4, 5)).astype(np.float32)
    _, vjp = jax.vjp(jhiera._pool2x, jnp.asarray(x))
    (jg,) = vjp(jnp.asarray(dy))
    tx = torch.from_numpy(x).requires_grad_()
    (tg,) = torch.autograd.grad(thiera._pool2x(tx), tx, torch.from_numpy(dy))
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    assert (x.reshape(2, 3, 2, 4, 2, 5).max((2, 4), keepdims=True)
            == x.reshape(2, 3, 2, 4, 2, 5)).sum() > 2 * 3 * 4 * 5  # ties present
