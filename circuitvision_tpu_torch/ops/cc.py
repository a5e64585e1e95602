"""Connected-component labelling and per-label statistics on the device.

Counterpart of the JAX package's `ops/cc.py`, with its semantics on torch
tensors of any device, one (H, W) raster or a (B, H, W) stack (the JAX
functions under `vmap`):

  1. every foreground pixel starts labelled with its own linear index;
     background carries the sentinel H·W;
  2. each iteration takes the minimum over each pixel's whole foreground
     run along rows, then along columns, then over its 8-neighbourhood,
     hooks each pixel's new minimum into the pixel its old label points
     at (a scatter-min), and makes two pointer jumps — until nothing
     changes or `max_iters` iterations have run (JAX :90-139);
  3. `label_stats` keeps the `max_labels` largest components, enumerated
     in descending root order, and computes area, centroid, bbox and the
     boundary count of each (JAX :188-253).

Where the port computes the same thing another way:

  * the segmented run minimum (JAX's forward and backward
    `associative_scan`) is one scatter-min keyed by run ids, the running
    count of background pixels along the axis, and a gather. Both give
    each foreground pixel the minimum of its run and its bounding
    background pixels, which carry the sentinel;
  * `lax.top_k`'s tie order (the lower index first among equal counts)
    is a stable descending sort;
  * the one-hot (K, HW) × (HW, 4) statistics are scatter-adds and
    scatter-min/max over each pixel's row in the table: area, boundary
    count and bbox are integers or extrema and equal JAX's exactly; the
    centroid sums are taken in float64 and rounded once to float32, so
    they equal JAX's float32 sums wherever those are exact (every sum
    below 2**24) and lie within float32 summation error elsewhere.

On the card each convergence test is a device-to-host sync, so the loop
tests every `_CHECK_EVERY_CUDA` iterations, never running past
`max_iters`: an iteration that changes nothing leaves a fixpoint, so the
iterations run after the fixpoint and before the test change no label,
and the labels (and the counted iterations) are JAX's.

`label_components_host` is the JAX package's union-find reference;
`label_image` is the scipy label image of the single-image node stage.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from scipy import ndimage

from .morphology import boundary_mask

#: iterations between convergence tests on a CUDA tensor (1 elsewhere)
_CHECK_EVERY_CUDA = 4


@dataclasses.dataclass
class LabelStats:
    """Per-label statistics, padded to a static K (a leading batch dim
    when labelled as a stack).

    labels:    (K,) int32 root linear indices (sentinel HW for padding)
    valid:     (K,) bool
    area:      (K,) float32 pixel counts
    contour_area: (K,) float32 cv2.contourArea-style estimate
    centroid:  (K, 2) float32 (x, y)
    bbox:      (K, 4) float32 (xmin, ymin, xmax, ymax) inclusive pixel bounds
    boundary_count: (K,) float32

    A padding slot carries the statistics of the background pixels, as
    the JAX one-hot of the sentinel label gives them."""

    labels: torch.Tensor
    valid: torch.Tensor
    area: torch.Tensor
    contour_area: torch.Tensor
    centroid: torch.Tensor
    bbox: torch.Tensor
    boundary_count: torch.Tensor


def _neighbor_min(lbl: torch.Tensor, sentinel: int) -> torch.Tensor:
    """3×3 minimum, the sentinel outside the raster (JAX :58)."""
    h, w = lbl.shape[-2:]
    p = F.pad(lbl, (1, 1, 1, 1), value=sentinel)
    out = p[..., 1:h + 1, 1:w + 1]
    for dy in range(3):
        for dx in range(3):
            if dy != 1 or dx != 1:
                out = torch.minimum(out, p[..., dy:dy + h, dx:dx + w])
    return out


def _segmented_run_min(lbl: torch.Tensor, fg: torch.Tensor, axis: int,
                       sentinel: int) -> torch.Tensor:
    """Min label over each contiguous foreground run along `axis` (0: the
    columns, 1: the rows of each (H, W) raster), the sentinel on the
    background; `lbl` carries the sentinel on the background, as every
    label raster of the iteration does (JAX :65)."""
    dim = axis - 2
    x = lbl.movedim(dim, -1)
    f = fg.movedim(dim, -1)
    n = x.shape[-1]
    lines = x.numel() // n
    run = torch.cumsum(~f, dim=-1)
    offset = torch.arange(lines, device=x.device).reshape(x.shape[:-1] + (1,)) * (n + 1)
    seg = (run + offset).reshape(-1)
    table = torch.full((lines * (n + 1),), sentinel, dtype=x.dtype, device=x.device)
    table.scatter_reduce_(0, seg, x.reshape(-1), "amin", include_self=True)
    out = torch.where(f, table[seg].reshape(x.shape), sentinel)
    return out.movedim(-1, dim)


def _as_stack(mask: torch.Tensor) -> tuple[torch.Tensor, bool]:
    if mask.dim() not in (2, 3):
        raise ValueError(f"expected an (H, W) raster or a (B, H, W) stack, got {tuple(mask.shape)}")
    fg = mask.to(torch.bool)
    return (fg[None], True) if fg.dim() == 2 else (fg, False)


def label_components_counted(mask: torch.Tensor, max_iters: int = 32
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """`label_components` and the iterations the JAX loop runs on each
    raster: up to and including the first that changes nothing, at most
    `max_iters`. Returns (int32 labels, int32 iterations (B,) or ())."""
    fg, single = _as_stack(mask)
    b, h, w = fg.shape
    sentinel = h * w
    dev = fg.device
    idx = torch.arange(sentinel, dtype=torch.int64, device=dev).reshape(h, w)
    lbl = torch.where(fg, idx, sentinel)
    tail = torch.full((b, 1), sentinel, dtype=torch.int64, device=dev)
    iters = torch.zeros(b, dtype=torch.int32, device=dev)
    done = torch.zeros(b, dtype=torch.bool, device=dev)
    check_every = _CHECK_EVERY_CUDA if dev.type == "cuda" else 1
    it = 0
    while it < max_iters:
        for _ in range(min(check_every, max_iters - it)):
            l = _segmented_run_min(lbl, fg, 1, sentinel)
            l = _segmented_run_min(l, fg, 0, sentinel)
            m = torch.where(fg, _neighbor_min(l, sentinel), sentinel).reshape(b, -1)
            old = lbl.reshape(b, -1)
            # hook: each pixel's new minimum into the pixel its old label
            # points at; slot HW is the sentinel's, so background self-links
            parent = torch.cat([m, tail], 1)
            parent.scatter_reduce_(1, old, m, "amin", include_self=True)
            flat = parent.gather(1, old)
            for _jump in range(2):
                flat = torch.cat([flat, tail], 1).gather(1, flat)
            new = flat.reshape(b, h, w)
            iters += (~done).to(torch.int32)
            done |= ~(new != lbl).reshape(b, -1).any(1)
            lbl = new
            it += 1
        if bool(done.all()):
            break
    lbl = lbl.to(torch.int32)
    return (lbl[0], iters[0]) if single else (lbl, iters)


def label_components(mask: torch.Tensor, max_iters: int = 32) -> torch.Tensor:
    """8-connected component labelling on the mask's device (JAX :90).

    mask: (H, W) or (B, H, W) bool/int foreground. Returns int32 labels of
    the same shape; background pixels carry the sentinel H*W, foreground
    pixels the linear index of their component's raster-first pixel once
    the loop reaches its fixpoint (before it, where `max_iters` cuts it,
    JAX's intermediate labels)."""
    return label_components_counted(mask, max_iters)[0]


def label_components_host(mask) -> tuple:
    """Reference two-pass union-find labelling on the host (numpy), JAX
    :142. Returns (labels, background sentinel)."""
    m = np.asarray(mask).astype(bool)
    h, w = m.shape
    sentinel = h * w
    parent = np.arange(sentinel, dtype=np.int64)

    def find(x):
        root = x
        while parent[root] != root:
            root = parent[root]
        while parent[x] != root:
            parent[x], x = root, parent[x]
        return root

    def union(a, b):
        ra, rb = find(a), find(b)
        if ra != rb:
            if ra < rb:
                parent[rb] = ra
            else:
                parent[ra] = rb

    for y in range(h):
        for x in range(w):
            if not m[y, x]:
                continue
            p = y * w + x
            for dy, dx in ((-1, -1), (-1, 0), (-1, 1), (0, -1)):
                ny, nx = y + dy, x + dx
                if 0 <= ny < h and 0 <= nx < w and m[ny, nx]:
                    union(p, ny * w + nx)

    labels = np.full((h, w), sentinel, dtype=np.int64)
    for y in range(h):
        for x in range(w):
            if m[y, x]:
                labels[y, x] = find(y * w + x)
    # the root of each set is its minimum index, the raster-first pixel
    return labels, sentinel


def label_stats(labels: torch.Tensor, max_labels: int = 64) -> LabelStats:
    """Compact labels to a static-K table and compute per-label
    statistics (JAX :188): the `max_labels` largest components (ties to
    the lower root), enumerated by descending root, padding slots last."""
    single = labels.dim() == 2
    lab = labels[None] if single else labels
    b, h, w = lab.shape
    sentinel = h * w
    k = max_labels
    dev = lab.device
    flat = lab.reshape(b, -1).to(torch.int64)

    count = torch.zeros((b, sentinel + 1), dtype=torch.int64, device=dev)
    count.scatter_add_(1, flat.clamp(max=sentinel), torch.ones_like(flat))
    count[:, sentinel] = 0
    top_area, top_roots = torch.sort(count, dim=1, descending=True, stable=True)
    top_area, top_roots = top_area[:, :k], top_roots[:, :k]
    sel_valid = top_area > 0
    order_key = torch.where(sel_valid, top_roots, -1)
    perm = torch.argsort(-order_key, dim=1, stable=True)
    valid = sel_valid.gather(1, perm)
    uniq = torch.where(valid, top_roots.gather(1, perm), sentinel)

    # each pixel's row of the table: its slot, K for the background (the
    # sentinel's one-hot, which padding slots read), K + 1 for the rest
    slot = torch.arange(k, device=dev).expand(b, k)
    rowmap = torch.full((b, sentinel + 1), k + 1, dtype=torch.int64, device=dev)
    rowmap.scatter_(1, torch.where(valid, uniq, sentinel), torch.where(valid, slot, k + 1))
    rowmap[:, sentinel] = k
    row = rowmap.gather(1, flat)

    xs = torch.arange(w, dtype=torch.float64, device=dev).repeat(h).expand(b, -1)
    ys = torch.arange(h, dtype=torch.float64, device=dev).repeat_interleave(w).expand(b, -1)
    bnd = boundary_mask(lab != sentinel).reshape(b, -1).to(torch.float64)
    sums = torch.zeros((b, k + 2, 4), dtype=torch.float64, device=dev)
    feats = torch.stack([torch.ones_like(xs), xs, ys, bnd], dim=2)
    sums.scatter_add_(1, row[..., None].expand(-1, -1, 4), feats)
    big = 1e9
    lo = torch.full((b, k + 2, 2), big, dtype=torch.float32, device=dev)
    hi = torch.full((b, k + 2, 2), -big, dtype=torch.float32, device=dev)
    xy = torch.stack([xs, ys], dim=2).to(torch.float32)
    lo.scatter_reduce_(1, row[..., None].expand(-1, -1, 2), xy, "amin", include_self=True)
    hi.scatter_reduce_(1, row[..., None].expand(-1, -1, 2), xy, "amax", include_self=True)

    src = torch.where(valid, slot, k)
    agg = sums.gather(1, src[..., None].expand(-1, -1, 4)).to(torch.float32)
    area = agg[..., 0]
    safe_area = torch.clamp(area, min=1.0)
    centroid = torch.stack([agg[..., 1] / safe_area, agg[..., 2] / safe_area], dim=-1)
    boundary_count = agg[..., 3]
    bbox = torch.cat([lo.gather(1, src[..., None].expand(-1, -1, 2)),
                      hi.gather(1, src[..., None].expand(-1, -1, 2))], dim=-1)
    contour_area = torch.clamp(area - boundary_count / 2.0 - 1.0, min=0.0)
    out = LabelStats(labels=uniq.to(torch.int32), valid=valid, area=area,
                     contour_area=contour_area, centroid=centroid, bbox=bbox,
                     boundary_count=boundary_count)
    if single:
        out = LabelStats(**{f.name: getattr(out, f.name)[0] for f in dataclasses.fields(out)})
    return out


def connected_components(mask: torch.Tensor, max_labels: int = 64, max_iters: int = 64
                         ) -> tuple[torch.Tensor, LabelStats]:
    """Label + stats in one call (JAX :256). Returns (label image, stats)."""
    labels = label_components(mask, max_iters=max_iters)
    return labels, label_stats(labels, max_labels=max_labels)


def label_image(mask: np.ndarray) -> np.ndarray:
    """The fixpoint label image of an (H, W) numpy raster, computed on the
    host with scipy: 8-connected components, each foreground pixel
    labelled with the linear index of its component's raster-first
    pixel, background carrying the sentinel H·W. The single-image node
    stage returns it beside the node graph."""
    fg = np.asarray(mask).astype(bool)
    h, w = fg.shape
    lab, n = ndimage.label(fg, structure=np.ones((3, 3), np.int32))
    root = np.full(n + 1, h * w, np.int32)
    flat = lab.ravel()
    idx = np.flatnonzero(flat)
    ids = flat[idx]
    # scipy numbers components 1, 2, … in raster order of their first
    # pixel, so a component's first pixel is where the running maximum of
    # the labels met so far rises to its label
    rises = np.empty(len(ids), bool)
    rises[:1] = True
    rises[1:] = ids[1:] > np.maximum.accumulate(ids)[:-1]
    root[ids[rises]] = idx[rises]
    return root[lab]
