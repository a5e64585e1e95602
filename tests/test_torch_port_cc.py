"""The port's device connected-components route — `ops/cc.py`,
`host_cc.label_touch_stage_host` and `extract_nodes_batched(device_cc=True)`
— against the JAX package's, on the same numpy rasters.

Labels, `valid`, areas, contour areas, boundary counts, bboxes, keep
masks and touch matrices are integers, booleans or extrema and must be
identical. Centroids are sums of pixel coordinates divided by the area:
the port sums in float64 and rounds once, JAX sums in float32 in an order
of its own, so where a sum passes 2**24 the two may differ by float32
summation error. For a label of n pixels whose coordinates are at most
c, any order of float32 summation errs by at most (n - 1)·u·n·c with
u = 2**-24 (Higham, Accuracy and Stability of Numerical Algorithms,
(4.4)), so the centroid by (n - 1)·u·c, plus one rounding of the
quotient: `_centroid_tol`. Where every sum stays below 2**24 both are
exact and the centroids must be identical.

The places where the port computes the JAX function another way are
each named by a test: the segmented run minimum (a scatter-min keyed by
run ids for two associative scans), the hook's scatter-min, the loop cut
by `max_iters` and frozen per raster in a stack, `lax.top_k`'s tie
order, the one-hot statistics, and padding.
"""
import functools
import glob
import json
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from circuitvision_tpu.core.config import TopologyConfig as JTopologyConfig
from circuitvision_tpu.core.types import BBox as JBBox
from circuitvision_tpu.ops import cc as jcc
from circuitvision_tpu.topology import host_cc as jhost
from circuitvision_tpu.topology import nodes as jnodes
from circuitvision_tpu_torch.core.config import TopologyConfig
from circuitvision_tpu_torch.core.types import BBox as TBBox
from circuitvision_tpu_torch.ops import cc as tcc
from circuitvision_tpu_torch.topology import host_cc as thost
from circuitvision_tpu_torch.topology import nodes as tnodes

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = sorted(os.path.basename(p)[:-4]
               for p in glob.glob(os.path.join(ROOT, "eval_data", "images", "*.png")))
EVAL = NAMES[::8][:3]
FIELDS = ("labels", "valid", "area", "contour_area", "bbox", "boundary_count")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with jax.default_matmul_precision("highest"):
        yield
    torch.set_num_threads(threads)


def _load(name):
    mask = cv2.imread(os.path.join(ROOT, "eval_data", "masks", name + ".png"),
                      cv2.IMREAD_GRAYSCALE)
    with open(os.path.join(ROOT, "eval_data", "boxes", name + ".json")) as f:
        boxes = json.load(f)
    return mask, boxes


def _random_mask(seed, shape=None, density=None):
    rng = np.random.default_rng(seed)
    shape = shape or tuple(int(v) for v in rng.integers(6, 48, 2))
    return rng.random(shape) < (density or rng.uniform(0.2, 0.7))


def _serpentine(h=21, w=23):
    """One wire folded back and forth: the minimum index sits at one end,
    so labels must travel the whole length and the loop needs several
    iterations to reach its fixpoint."""
    m = np.zeros((h, w), bool)
    for r in range(0, h, 2):
        m[r, 1:w - 1] = True
        if r + 1 < h:
            m[r + 1, w - 2 if (r // 2) % 2 == 0 else 1] = True
    return m[::-1].copy()


_jit_run_min = jax.jit(jcc._segmented_run_min, static_argnums=(2, 3))


def _centroid_tol(area, centroid):
    n = np.maximum(area, 1.0).astype(np.float64)
    return (n - 1) * 2.0 ** -24 * np.abs(centroid) + np.spacing(np.abs(centroid).astype(np.float32))


def _assert_stats_equal(got, ref, exact_centroids):
    for f in FIELDS:
        a, b = getattr(got, f).numpy(), np.asarray(getattr(ref, f))
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    c, rc = got.centroid.numpy(), np.asarray(ref.centroid)
    if exact_centroids:
        np.testing.assert_array_equal(c, rc)
    else:
        tol = _centroid_tol(np.asarray(ref.area)[..., None], rc)
        assert (np.abs(c.astype(np.float64) - rc) <= tol).all()


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("axis", [0, 1])
def test_segmented_run_min_equals_two_associative_scans(seed, axis):
    """The scatter-min over run ids gives what JAX's forward and backward
    segmented scans give, on random rasters whose labels are random on
    the foreground and the sentinel on the background."""
    fg = _random_mask(seed, (29, 37))
    s = fg.size
    lbl = np.where(fg, np.random.default_rng(seed + 100).integers(0, s, fg.shape), s)
    ref = np.asarray(_jit_run_min(jnp.asarray(lbl, jnp.int32), jnp.asarray(fg), axis, s))
    got = tcc._segmented_run_min(torch.from_numpy(lbl), torch.from_numpy(fg), axis, s)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("seed", range(8))
def test_label_components_matches_jax(seed):
    fg = _random_mask(seed)
    ref = np.asarray(jcc.label_components(jnp.asarray(fg), max_iters=32))
    got = tcc.label_components(torch.from_numpy(fg), max_iters=32)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("max_iters", [1, 2, 3, 32])
def test_label_components_cut_by_max_iters(max_iters):
    """Where max_iters stops the loop before the fixpoint the port gives
    JAX's intermediate labels, and counts JAX's iterations."""
    fg = _serpentine()
    ref = np.asarray(jcc.label_components(jnp.asarray(fg), max_iters=max_iters))
    got, iters = tcc.label_components_counted(torch.from_numpy(fg), max_iters=max_iters)
    np.testing.assert_array_equal(got.numpy(), ref)
    full, needed = tcc.label_components_counted(torch.from_numpy(fg), max_iters=64)
    # the serpentine's labels settle at the third iteration; the fourth
    # finds nothing changed
    assert int(needed) == 4
    assert int(iters) == min(max_iters, int(needed))
    assert (got.numpy() != full.numpy()).any() == (max_iters < 3)


@pytest.mark.parametrize("max_iters", [2, 3, 64])
def test_stack_freezes_each_raster_as_vmap_does(max_iters):
    """A stack labels each raster as JAX's vmapped while loop does, each
    raster's state frozen once its own loop condition is false."""
    fgs = np.stack([_serpentine(), _random_mask(3, (21, 23)), np.zeros((21, 23), bool),
                    _random_mask(4, (21, 23), 0.9)])
    ref = np.asarray(jax.vmap(functools.partial(jcc.label_components, max_iters=max_iters))(
        jnp.asarray(fgs)))
    got, iters = tcc.label_components_counted(torch.from_numpy(fgs), max_iters=max_iters)
    np.testing.assert_array_equal(got.numpy(), ref)
    for i, fg in enumerate(fgs):
        assert int(iters[i]) == int(tcc.label_components_counted(
            torch.from_numpy(fg), max_iters=max_iters)[1])


def test_hook_scatter_min_is_order_free():
    """The hook's scatter-min is applied by the port in whatever order its
    backend likes; the labels after one iteration (where the hook alone
    joins runs) equal JAX's on rasters of many crossing diagonals."""
    fg = np.zeros((40, 40), bool)
    for k in range(-40, 40, 5):
        idx = np.arange(40)
        ok = (idx + k >= 0) & (idx + k < 40)
        fg[idx[ok], idx[ok] + k] = True
        fg[idx[ok], 39 - idx[ok] - k] = True
    for it in (1, 2):
        ref = np.asarray(jcc.label_components(jnp.asarray(fg), max_iters=it))
        np.testing.assert_array_equal(
            tcc.label_components(torch.from_numpy(fg), max_iters=it).numpy(), ref)


@pytest.mark.parametrize("seed", range(3))
def test_label_components_host_matches_jax(seed):
    fg = _random_mask(seed, (17, 19))
    ref, rs = jcc.label_components_host(fg)
    got, gs = tcc.label_components_host(fg)
    assert gs == rs
    np.testing.assert_array_equal(got, ref)
    assert got.dtype == ref.dtype


@pytest.mark.parametrize("seed", range(6))
def test_label_stats_matches_jax(seed):
    """Small rasters: every centroid sum is below 2**24, so centroids are
    identical too; padding slots carry the background's statistics."""
    fg = _random_mask(seed, density=0.35)
    labels = np.asarray(jcc.label_components(jnp.asarray(fg), max_iters=64))
    ref = jcc.label_stats(jnp.asarray(labels), max_labels=16)
    got = tcc.label_stats(torch.from_numpy(labels), max_labels=16)
    _assert_stats_equal(got, ref, exact_centroids=True)


def test_top_k_ties_keep_the_lower_index():
    """70 equal squares at max_labels=64: lax.top_k keeps the 64 with the
    lowest roots; torch.topk promises no order, the stable sort does."""
    fg = np.zeros((70, 4 * 70), bool)
    for i in range(70):
        y, x = (i % 7) * 10, (i // 7) * 4 * 7
        fg[y:y + 2, x:x + 2] = True
    labels = np.asarray(jcc.label_components(jnp.asarray(fg), max_iters=64))
    ref = jcc.label_stats(jnp.asarray(labels), max_labels=64)
    got = tcc.label_stats(torch.from_numpy(labels), max_labels=64)
    assert int(np.asarray(ref.valid).sum()) == 64
    _assert_stats_equal(got, ref, exact_centroids=True)


@pytest.mark.parametrize("name", EVAL[:2])
def test_connected_components_on_eval_masks(name):
    """Full-size wire masks: labels and integer statistics identical,
    centroids within float32 summation error (`_centroid_tol`)."""
    fg = _load(name)[0] > 0
    ref_labels, ref = jcc.connected_components(jnp.asarray(fg), max_labels=64, max_iters=64)
    got_labels, got = tcc.connected_components(torch.from_numpy(fg), max_labels=64,
                                               max_iters=64)
    np.testing.assert_array_equal(got_labels.numpy(), np.asarray(ref_labels))
    _assert_stats_equal(got, ref, exact_centroids=False)


@pytest.mark.parametrize("name", EVAL)
def test_label_touch_stage_host_matches_jax(name):
    mask, boxes = _load(name)
    fg = mask > 0
    h, w = fg.shape
    rng = np.random.default_rng(0)
    n = len(boxes)
    cb = np.asarray([[b["xmin"], b["ymin"], b["xmax"], b["ymax"]] for b in boxes], np.float32)
    cb = np.concatenate([cb, np.zeros((32 - n, 4), np.float32)])
    ct = np.concatenate([rng.choice([6.0, 8.0, 20.0], n), np.zeros(32 - n)]).astype(np.float32)
    cv = np.arange(32) < n
    ref = jhost.label_touch_stage_host(fg, float(w), JTopologyConfig(), cb, ct, cv)
    got = thost.label_touch_stage_host(fg, float(w), TopologyConfig(), cb, ct, cv)
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def _nodes_key(result, pad_width=None):
    """The nodes as comparable data; with `pad_width`, each label as the
    (row, column) of its root in a stack padded to that width."""
    return [(n.id, n.centroid, n.area, divmod(n.label, pad_width) if pad_width else n.label,
             [c.persistent_uid for c in n.components])
            for n in result.nodes], result.raw_node_count


def _pad_width(mask):
    h, w = mask.shape
    return (int(600 * (w / h)) + 127) // 128 * 128


@pytest.fixture(scope="module")
def eval_batch():
    """The three eval masks through JAX's device route once (one compile
    of its stage B at this stack's shape) and through the port's."""
    masks, jboxes, tboxes = [], [], []
    for name in EVAL:
        mask, boxes = _load(name)
        masks.append(mask)
        jboxes.append([JBBox.from_dict(b) for b in boxes])
        tboxes.append([TBBox.from_dict(b) for b in boxes])
    ref = jnodes.extract_nodes_batched(masks, jboxes, pad_to=4, device_cc=True)
    got = tnodes.extract_nodes_batched(masks, tboxes, pad_to=4, device_cc=True, device="cpu")
    return masks, tboxes, ref, got


def test_extract_nodes_batched_device_cc_matches_jax(eval_batch):
    _masks, _boxes, ref, got = eval_batch
    assert len(got) == len(ref) == len(EVAL)
    for a, b in zip(got, ref):
        assert _nodes_key(a) == _nodes_key(b)
        assert [x.to_dict() for x in a.resized_bboxes] == [x.to_dict() for x in b.resized_bboxes]
    assert any(r.nodes for r in got)


def test_device_cc_padding_changes_nothing(eval_batch):
    """Padding the stack to more rasters, and each raster to a width that
    is a multiple of 128, changes no node: the same images alone, with no
    pad_to, give the same nodes."""
    masks, boxes, _ref, got = eval_batch
    widths = [_pad_width(m) for m in masks]
    for i in range(len(masks)):
        alone = tnodes.extract_nodes_batched([masks[i]], [boxes[i]], pad_to=None,
                                             device_cc=True, device="cpu")
        # a node's label is its root's linear index in the padded stack
        assert _nodes_key(alone[0], widths[i]) == _nodes_key(got[i], max(widths))


def test_padding_changes_no_label_or_stat():
    """A raster padded with background on the right keeps every label's
    root (its linear index moves with the width, so compare coordinates),
    area, boundary count, bbox and centroid."""
    fg = _random_mask(7, (30, 37), 0.3)
    wide = np.zeros((30, 128), bool)
    wide[:, :37] = fg
    a = tcc.label_stats(tcc.label_components(torch.from_numpy(fg), 64), 8)
    b = tcc.label_stats(tcc.label_components(torch.from_numpy(wide), 64), 8)
    va = a.valid.numpy()
    np.testing.assert_array_equal(va, b.valid.numpy())
    np.testing.assert_array_equal(np.divmod(a.labels.numpy()[va], 37),
                                  np.divmod(b.labels.numpy()[va], 128))
    for f in ("area", "boundary_count", "bbox", "centroid"):
        np.testing.assert_array_equal(getattr(a, f).numpy()[va], getattr(b, f).numpy()[va])


def test_host_route_ignores_pad_to(eval_batch):
    masks, boxes, _ref, _got = eval_batch
    plain = tnodes.extract_nodes_batched(masks, boxes, device="cpu")
    padded = tnodes.extract_nodes_batched(masks, boxes, pad_to=8, device="cpu")
    assert [_nodes_key(r) for r in plain] == [_nodes_key(r) for r in padded]
