"""Node extraction: wire mask + component boxes → electrical node graph.

Counterpart of the single-image path of the JAX package's
`topology/nodes.py` (reference get_node_connections,
src/circuit_analyzer.py:1286-1605):

  component subtraction (host) → stage A on the device: cv2-exact resize
  to H=600 with uint8 rounding, enhance_lines, uint8 quantize,
  auto-invert, binarize → cv2-exact contour trace / polygon stats /
  vertex touch on the host (host_cc) → ground selection → renumbering

with the reference's exact tie-breaks:

  - contours filtered at relative area > 4e-4          (:388,410)
  - ground = source-connected node lowest on screen
    (max centroid-y, stable order on ties)             (:1472-1498)
  - fallbacks: max-connection nodes, then lowest node  (:1499-1545)
  - non-ground nodes renumbered 1..N in old-id order,
    dropped unless >= 2 components (single-other-node
    exception preserved)                               (:1547-1582)

The batched path (`extract_nodes_batched`, JAX nodes.py:451-596) runs
the same stage A per image with the subtraction on the device and hands
the host a bit-packed raster, fetched for a whole chunk at once. With
`TopologyConfig.use_fused_morphology` on and the raster on the card,
stage A's enhance_lines is the `enhance_lines_fused` kernel
(ops/cuda/morphology.py), as JAX nodes.py:99-109 gates it.

With `fetch_viz` (the default, as in the JAX stage) the single-image
path also returns the label image and the reference's three debug
images, drawn by core/viz.py byte-equal to the JAX package's cv2
drawings: the contour image, the connection points and the node image,
whose base is the emptied mask resized by cv2's fixed-point INTER_LINEAR
(ops/image.resize_linear_u8, JAX nodes.py:283-291). The throughput paths
skip them, as the JAX package's fetch_viz=False does.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from ..core import taxonomy
from ..core.config import TopologyConfig, resolve_device
from ..core.types import BBox, Node
from ..core.viz import connection_points_viz, contour_viz, node_viz
from ..ops.cc import label_components
from ..ops.cuda.morphology import enhance_lines_fused
from ..ops.image import resize_bilinear, resize_linear_u8
from ..ops.morphology import enhance_lines
from .host_cc import contour_touch_stage_host


def _cv2_resize_u8(img_f32: torch.Tensor, out_hw) -> torch.Tensor:
    """cv2.resize INTER_LINEAR on uint8 data: plain bilinear, rounded back
    to integer grey values — the reference resizes the uint8 emptied mask
    BEFORE blurring, so the blur must see rounded integers."""
    return torch.clamp(torch.round(resize_bilinear(img_f32, out_hw, antialias=False)), 0, 255)


def subtract_component_boxes(
    mask: np.ndarray, bboxes: Sequence[BBox], preserve=taxonomy.MASK_PRESERVE_CLASSES
) -> np.ndarray:
    """Zero out every bbox not in the preserve set (reference :1328-1341).

    Host-side scatter: the box list is small and dynamic; the result is
    shipped to device once for the heavy raster stages.
    """
    out = np.asarray(mask).copy()
    h, w = out.shape[:2]
    for b in bboxes:
        if b.class_name in preserve:
            continue
        y0, y1 = max(0, int(b.ymin)), min(h, int(b.ymax))
        x0, x1 = max(0, int(b.xmin)), min(w, int(b.xmax))
        if y0 < y1 and x0 < x1:
            out[y0:y1, x0:x1] = 0
    return out


@dataclasses.dataclass
class NodeExtraction:
    """Full output of the node stage (the reference's 6-tuple return,
    src/circuit_analyzer.py:1605)."""

    nodes: list[Node]
    emptied_mask: np.ndarray
    enhanced_mask: np.ndarray
    label_image: np.ndarray
    resized_bboxes: list[BBox]
    raw_node_count: int = 0
    contour_viz: Optional[np.ndarray] = None
    connection_viz: Optional[np.ndarray] = None
    node_viz: Optional[np.ndarray] = None


def _fused_morphology(cfg: TopologyConfig, raster: torch.Tensor) -> bool:
    """The kernel takes enhance_lines at its default parameters only, and
    only on the card (JAX nodes.py:99-109: never on the CPU backend)."""
    return (cfg.use_fused_morphology and raster.is_cuda and cfg.blur_kernel == 5
            and cfg.blur_sigma == 1.0 and cfg.morph_kernel == 3 and cfg.morph_iterations == 2)


def enhance_chain(resized: torch.Tensor, cfg: TopologyConfig) -> torch.Tensor:
    """resize output → enhance_lines → uint8 quantize → auto-invert."""
    if _fused_morphology(cfg, resized):
        enhanced = enhance_lines_fused(resized.contiguous())
    else:
        enhanced = torch.round(enhance_lines(
            resized, blur_ksize=cfg.blur_kernel, blur_sigma=cfg.blur_sigma,
            morph_ksize=cfg.morph_kernel, iterations=cfg.morph_iterations,
        ))
    # cv2 works on rounded uint8: the faint Gaussian halo below 0.5 must
    # NOT count as foreground
    enhanced_u8 = torch.clamp(enhanced, 0, 255)
    # auto-invert when mostly white (reference get_contours :398)
    return torch.where(enhanced_u8.mean() > 127.0, 255.0 - enhanced_u8, enhanced_u8)


def stage_a(emptied: np.ndarray, cfg: TopologyConfig, device) -> torch.Tensor:
    """Device half of the node stage on the emptied mask: cv2-exact
    resize to cfg.resize_height rows → enhance chain. Returns the
    (new_h, new_w) float32 0..255 raster on `device`."""
    in_h, in_w = emptied.shape[:2]
    new_h, new_w = cfg.resize_height, int(cfg.resize_height * (in_w / in_h))
    mask = torch.as_tensor(np.ascontiguousarray(emptied), device=device).to(torch.float32)
    return enhance_chain(_cv2_resize_u8(mask, (new_h, new_w)), cfg)


def _comp_bucket(n: int) -> int:
    for size in (32, 64, 128, 256):
        if n <= size:
            return size
    return ((n + 255) // 256) * 256


def extract_nodes(
    wire_mask: np.ndarray,
    bboxes: Sequence[BBox],
    cfg: Optional[TopologyConfig] = None,
    device="cuda",
    fetch_viz: bool = True,
) -> NodeExtraction:
    """Run the full node-extraction stage.

    wire_mask: (H, W) uint8 0/255 segmentation (SAM2 or classical), in the
        same coordinate space as `bboxes`. Stage A runs on `device`: the
        CUDA device unless `device="cpu"` is asked for.
    fetch_viz: also return the connected-component label image and the
        three debug images (no netlist result depends on them).
    """
    device = resolve_device(device, "extract_nodes")
    cfg = cfg or TopologyConfig()
    if wire_mask is None:
        return NodeExtraction([], None, None, None, [])

    emptied = subtract_component_boxes(wire_mask, bboxes)
    in_h, in_w = emptied.shape[:2]
    enhanced = stage_a(emptied, cfg, device)
    new_h, new_w = enhanced.shape
    sx, sy = new_w / in_w, new_h / in_h
    resized_bboxes = [b.scaled(sx, sy) for b in bboxes]
    comp_indices, comp_boxes, comp_thr, comp_valid = _component_arrays(resized_bboxes, cfg)

    enhanced_u8 = enhanced.to(torch.uint8).cpu().numpy()
    fg = enhanced_u8 > 0
    labels = label_components(fg) if fetch_viz else None

    centroids, rel_area, touch, contours = contour_touch_stage_host(
        fg, float(new_w), cfg, comp_boxes, comp_thr, comp_valid
    )
    touch = touch[:, : len(comp_indices)]
    k = len(rel_area)
    if not comp_indices or k == 0:
        return NodeExtraction([], emptied, enhanced_u8, labels, resized_bboxes)
    nodes, raw_count = _assemble_nodes(
        resized_bboxes, comp_indices, np.arange(k), centroids, rel_area,
        np.ones(k, bool), touch,
    )
    cviz = pviz = nviz = None
    if fetch_viz:
        cviz = contour_viz((new_h, new_w), contours)
        pviz = connection_points_viz(
            cviz, _connection_points(contours, touch, resized_bboxes, comp_indices, cfg))
        # node.label is the compacted contour index (np.arange(k) above)
        nviz = node_viz(resize_linear_u8(emptied, (new_h, new_w)), nodes,
                        dict(enumerate(contours)))
    return NodeExtraction(nodes, emptied, enhanced_u8, labels, resized_bboxes,
                          raw_node_count=raw_count, contour_viz=cviz, connection_viz=pviz,
                          node_viz=nviz)


def _connection_points(contours, touch, resized_bboxes, comp_indices, cfg
                       ) -> list[tuple[int, int]]:
    """First contour vertex matching each touching (component, contour)
    pair — the point the reference appends before `break`ing its walk
    (src/circuit_analyzer.py:1423-1443; JAX nodes.py:297-322)."""
    points: list[tuple[int, int]] = []
    for k, ct in enumerate(contours):
        row = touch[k]
        if not row.any():
            continue
        xs = ct.vertices[:, 0].astype(np.int64)
        ys = ct.vertices[:, 1].astype(np.int64)
        for ci, gi in enumerate(comp_indices):
            if not row[ci]:
                continue
            b = resized_bboxes[gi]
            t = taxonomy.pixel_threshold_for_class(b.class_name, cfg)
            inside = (xs >= b.xmin) & (xs <= b.xmax) & (ys >= b.ymin) & (ys <= b.ymax)
            near = ((np.abs(xs - b.xmin) <= t) | (np.abs(xs - b.xmax) <= t)
                    | (np.abs(ys - b.ymin) <= t) | (np.abs(ys - b.ymax) <= t))
            sel = np.nonzero(inside | near)[0]
            if len(sel):
                points.append((int(xs[sel[0]]), int(ys[sel[0]])))
    return points


def _assemble_nodes(
    resized_bboxes, comp_indices, uniq, centroids, rel_area, keep, touch
) -> tuple[list[Node], int]:
    """Host bookkeeping from fetched device stats: per-label component
    lists → ground selection → renumbering (reference :1431-1582)."""
    # 6. Build per-label component lists in bbox-list order with UID dedupe
    # (reference :1431-1443).
    kept_label_rows = [k for k in range(len(uniq)) if keep[k]]
    node_records = []
    for node_id, k in enumerate(kept_label_rows):
        comps: list[BBox] = []
        seen: set[str] = set()
        for ci, gi in enumerate(comp_indices):
            if touch[k, ci]:
                b = resized_bboxes[gi]
                if b.persistent_uid in seen:
                    continue
                seen.add(b.persistent_uid)
                comps.append(b)
        cx, cy = centroids[k]
        node_records.append(
            {
                "old_id": node_id,
                "label": int(uniq[k]),
                "components": comps,
                "centroid": (int(cx), int(cy)),
                "area": float(rel_area[k]),
            }
        )

    valid_nodes = [r for r in node_records if r["components"]]
    if not valid_nodes:
        return [], len(node_records)

    # 7. Ground selection (reference :1470-1545).
    ground_old_id = _select_ground(valid_nodes)

    # 8. Renumbering (reference :1547-1582).
    return _renumber(valid_nodes, ground_old_id), len(node_records)


def _select_ground(valid_nodes: list[dict]) -> Optional[int]:
    """Ground = source-connected node lowest on screen; fallbacks to the
    max-connection node, then the lowest valid node (reference :1470-1545).
    Sorts are stable, preserving reference tie-break order."""
    source_candidates = [
        r
        for r in valid_nodes
        if any(c.class_name in taxonomy.SOURCE_COMPONENTS for c in r["components"])
    ]
    if source_candidates:
        best = sorted(source_candidates, key=lambda r: r["centroid"][1], reverse=True)[0]
        return best["old_id"]

    max_conn = max(len(r["components"]) for r in valid_nodes)
    nodes_with_max = [r for r in valid_nodes if len(r["components"]) == max_conn]
    if nodes_with_max:
        if len(nodes_with_max) > 1:
            best = sorted(nodes_with_max, key=lambda r: r["centroid"][1], reverse=True)[0]
            return best["old_id"]
        return nodes_with_max[0]["old_id"]
    best = sorted(valid_nodes, key=lambda r: r["centroid"][1], reverse=True)[0]
    return best["old_id"]


def _renumber(valid_nodes: list[dict], ground_old_id: Optional[int]) -> list[Node]:
    by_old = {r["old_id"]: r for r in valid_nodes}
    nodes: list[Node] = []
    if ground_old_id is not None and ground_old_id in by_old:
        g = by_old[ground_old_id]
        nodes.append(
            Node(id=0, components=g["components"], centroid=g["centroid"],
                 area=g["area"], label=g["label"])
        )
        next_id = 1
        for old_id in sorted(r["old_id"] for r in valid_nodes if r["old_id"] != ground_old_id):
            r = by_old[old_id]
            keep = len(r["components"]) >= 2 or (
                len(nodes) == 1 and len(valid_nodes) == 2 and len(r["components"]) > 0
            )
            if keep:
                nodes.append(
                    Node(id=next_id, components=r["components"], centroid=r["centroid"],
                         area=r["area"], label=r["label"])
                )
                next_id += 1
    else:
        next_id = 0
        for old_id in sorted(r["old_id"] for r in valid_nodes):
            r = by_old[old_id]
            if r["components"]:
                nodes.append(
                    Node(id=next_id, components=r["components"], centroid=r["centroid"],
                         area=r["area"], label=r["label"])
                )
                next_id += 1
    return nodes


def _component_arrays(resized_bboxes, cfg: TopologyConfig):
    """Electrical-component boxes padded to a bucket of sizes (32, 64, …),
    as the JAX stage pads them."""
    comp_indices = [
        i
        for i, b in enumerate(resized_bboxes)
        if b.class_name not in taxonomy.NON_COMPONENTS
    ]
    bucket = _comp_bucket(max(1, len(comp_indices)))
    comp_boxes = np.zeros((bucket, 4), np.float32)
    comp_thr = np.zeros(bucket, np.float32)
    comp_valid = np.zeros(bucket, bool)
    for col, i in enumerate(comp_indices):
        b = resized_bboxes[i]
        comp_boxes[col] = (b.xmin, b.ymin, b.xmax, b.ymax)
        comp_thr[col] = taxonomy.pixel_threshold_for_class(b.class_name, cfg)
        comp_valid[col] = True
    return comp_indices, comp_boxes, comp_thr, comp_valid


# ---------------------------------------------------------------- batched
_BIT_WEIGHTS = (128, 64, 32, 16, 8, 4, 2, 1)


def pack_bits(fg: torch.Tensor) -> torch.Tensor:
    """(H, W) bool → (H, ceil(W/8)) uint8, in np.unpackbits order."""
    h, w = fg.shape
    w8 = (w + 7) // 8
    bits = torch.zeros((h, w8 * 8), dtype=torch.int32, device=fg.device)
    bits[:, :w] = fg.to(torch.int32)
    weights = torch.tensor(_BIT_WEIGHTS, dtype=torch.int32, device=fg.device)
    return (bits.reshape(h, w8, 8) * weights).sum(-1).to(torch.uint8)


class PackedFetch:
    """One device-to-host copy of a list of uint8 tensors of one device
    into pinned memory, queued behind the work that makes them on the
    current CUDA stream; `get()` waits for its event and splits the copy
    back into host arrays of the tensors' shapes."""

    def __init__(self, tensors: Sequence[torch.Tensor]):
        self.shapes = [tuple(t.shape) for t in tensors]
        self.event = None
        flat = torch.cat([t.reshape(-1) for t in tensors]) if tensors \
            else torch.zeros(0, dtype=torch.uint8)
        if flat.is_cuda:
            self.host = torch.empty(flat.shape, dtype=flat.dtype, pin_memory=True)
            self.host.copy_(flat, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = flat

    def get(self) -> list[np.ndarray]:
        if self.event is not None:
            self.event.synchronize()
        flat = self.host.numpy()
        out, at = [], 0
        for shape in self.shapes:
            n = int(np.prod(shape))
            out.append(flat[at:at + n].reshape(shape))
            at += n
        return out


def _subtract_arrays(bboxes: Sequence[BBox], h: int, w: int) -> list[tuple[int, int, int, int]]:
    """Boxes to zero out of the mask (everything not mask-preserved),
    clamped to the raster exactly as subtract_component_boxes clamps them
    (JAX nodes.py:451-466)."""
    sub = [(max(0, int(b.xmin)), max(0, int(b.ymin)), min(w, int(b.xmax)), min(h, int(b.ymax)))
           for b in bboxes if b.class_name not in taxonomy.MASK_PRESERVE_CLASSES]
    return [(x0, y0, x1, y1) for x0, y0, x1, y1 in sub if x0 < x1 and y0 < y1]


@dataclasses.dataclass
class PackedRaster:
    """One image's prepared analysis raster (stage A's output): the
    bit-packed binarized enhance chain at cfg.resize_height rows, still on
    its device, with the resize geometry that finishing on the host needs
    (JAX nodes.py:524-532)."""

    packed_dev: torch.Tensor  # (new_h, ceil(new_w/8)) uint8
    in_shape: tuple[int, int]
    new_h: int
    new_w: int


def prepare_packed_raster(mask, bboxes: Sequence[BBox], cfg: TopologyConfig,
                          device="cuda") -> PackedRaster:
    """Stage A for one image on the device (JAX nodes.py:470-503, 535-556):
    component subtraction → cv2-exact resize → enhance chain → bit-pack.

    `mask` is the (H, W) 0/255 wire mask, a tensor already on its device
    or a numpy array that is uploaded to `device`. Subtraction depends
    only on each box's coordinates and on whether its class is
    mask-preserved, which reclassification never changes, so this may run
    before stage [3]; `finish_from_packed` takes the final boxes."""
    device = resolve_device(device, "prepare_packed_raster")
    if not isinstance(mask, torch.Tensor):
        mask = torch.as_tensor(np.ascontiguousarray(mask), device=device)
    in_h, in_w = mask.shape[:2]
    new_h, new_w = cfg.resize_height, int(cfg.resize_height * (in_w / in_h))
    emptied = mask.to(torch.float32, copy=True)
    for x0, y0, x1, y1 in _subtract_arrays(bboxes, in_h, in_w):
        emptied[y0:y1, x0:x1] = 0.0
    enhanced = enhance_chain(_cv2_resize_u8(emptied, (new_h, new_w)), cfg)
    return PackedRaster(pack_bits(enhanced > 0), (in_h, in_w), new_h, new_w)


def finish_from_packed(packed_host: np.ndarray, pr: PackedRaster, bboxes: Sequence[BBox],
                       cfg: TopologyConfig) -> NodeExtraction:
    """Host half of batched extraction (JAX nodes.py:559-593): unpack the
    raster → contour trace / polygon stats / vertex touch (host_cc) →
    nodes. `bboxes` are the final, post-reclassification boxes."""
    in_h, in_w = pr.in_shape
    sx, sy = pr.new_w / in_w, pr.new_h / in_h
    resized_bboxes = [b.scaled(sx, sy) for b in bboxes]
    comp_indices, comp_boxes, comp_thr, comp_valid = _component_arrays(resized_bboxes, cfg)
    fg = np.unpackbits(packed_host, axis=1)[:, : pr.new_w].astype(bool)
    centroids, rel_area, touch, _contours = contour_touch_stage_host(
        fg, float(pr.new_w), cfg, comp_boxes, comp_thr, comp_valid
    )
    touch = touch[:, : len(comp_indices)]
    k = len(rel_area)
    if not comp_indices or k == 0:
        return NodeExtraction([], None, None, None, resized_bboxes)
    nodes, raw_count = _assemble_nodes(
        resized_bboxes, comp_indices, np.arange(k), centroids, rel_area,
        np.ones(k, bool), touch,
    )
    return NodeExtraction(nodes, None, None, None, resized_bboxes, raw_node_count=raw_count)


def extract_nodes_batched(masks: Sequence, bboxes_list: Sequence[Sequence[BBox]],
                          cfg: Optional[TopologyConfig] = None,
                          device="cuda") -> list[NodeExtraction]:
    """Node extraction over a batch (JAX nodes.py:596, its default
    host-CC route): stage A per image on the device, one device-to-host
    copy of every packed raster, then the host stage per image. Gives the
    nodes of per-image `extract_nodes`; the visualisation fields stay
    None. `masks` are tensors on their device or numpy arrays."""
    device = resolve_device(device, "extract_nodes_batched")
    cfg = cfg or TopologyConfig()
    prs = [prepare_packed_raster(m, bbs, cfg, device) for m, bbs in zip(masks, bboxes_list)]
    hosts = PackedFetch([pr.packed_dev for pr in prs]).get()
    return [finish_from_packed(ph, pr, bbs, cfg)
            for ph, pr, bbs in zip(hosts, prs, bboxes_list)]
