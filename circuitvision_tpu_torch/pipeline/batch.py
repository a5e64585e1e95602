"""Batched multi-image analysis on one CUDA device.

Counterpart of the JAX package's `pipeline/batch.py` (`BatchedPipeline`,
`analyze_many` at :633), the throughput path, with `analyze()`'s stage
semantics (reference ordering src/analysis_pipeline.py:97-326):

  detect (YOLO per image, one fetch per chunk) → host confidence-NMS
  and cluster crop → SAM2 on the CROPS (one batch) → per-crop logit
  resize + threshold + bit-pack → topology stage A per image → host
  reclassify / direction reads (one client call a chunk; a client that
  reads one crop a call goes image by image on its thread pool) / node
  extraction / netlist and enumeration image → with `finalize=True`,
  the value reads of the chunk in one client call (image by image for
  a client with no batch read) and the merge.

Design on the card:
  * images upload once as uint8; letterboxing, crop slicing and SAM2
    preprocessing run on the device from those uploads;
  * the chunk's packed masks and packed analysis rasters come back with
    ONE device-to-host copy per chunk into pinned memory, queued behind
    the work that makes them; the host waits on its event;
  * one thread and one CUDA stream: the chunks go through the stages in
    order, and a chunk's host topology runs after the next chunk's
    device work is queued, so the two overlap. The JAX package runs the
    stages as three threads; here, where every YOLO forward is host
    dispatch, three threads sharing one interpreter ran slower than the
    same stages in order on one thread (PERF.md §6); threads wait for a
    CUDA graph of YOLO (ROADMAP Queue A 4).

Deliberate differences from the JAX path: no mesh and no shard_map (data
parallelism over cards is ROADMAP Queue A 13), no padding of a partial
last chunk (it existed for XLA's fixed-shape programs), no `run_batch`
(queued). As in `analyze()`, a SAM2 failure raises instead of switching
to the classical mask; the node-stage ladder falls back per image, and
no ladder swallows a kernel fault or a CUDA error.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Optional, Sequence

import numpy as np
import torch

from ..core import geometry
from ..core.config import BATCH_PER_DEVICE
from ..core.types import AnalysisResult, BBox
from ..enrich.directions import enrich_directions_many
from ..models.yolo.decode import decode_predictions, postprocess, unletterbox_boxes
from ..ops.image import crop_sam2_preprocess, letterbox, resize_linear
from ..topology.crop import crop_image_and_adjust_bboxes
from ..topology.nodes import (
    PackedFetch, PackedRaster, extract_nodes, finish_from_packed, pack_bits,
    prepare_packed_raster,
)
from ..topology.reclassify import reclassify_terminals, segment_classical
from ..ops.cuda.build import is_device_fault
from .analyzer import detections_to_bboxes

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class _Staged:
    """Per-image state carried from the device stages to the host stage."""

    image: np.ndarray
    crop: np.ndarray
    bboxes_orig_nms: list
    bboxes: list
    crop_info: object
    image_dev: Optional[torch.Tensor] = None  # the detect stage's uint8 upload
    mask: Optional[np.ndarray] = None  # (hc, wc) uint8 0/255 on the host
    mask_packed: Optional[torch.Tensor] = None  # bit-packed mask on the device
    packed_raster: Optional[PackedRaster] = None  # stage A's output


class BatchedPipeline:
    """Chunked detect → crop → segment → topology over many images on the
    analyzer's device, `batch_size` images per chunk (default
    BATCH_PER_DEVICE, the JAX MeshConfig.batch_per_device)."""

    def __init__(self, analyzer, batch_size: Optional[int] = None):
        self.analyzer = analyzer
        self.cfg = analyzer.cfg
        self.device = analyzer.device
        self.batch_size = batch_size or BATCH_PER_DEVICE
        if self.batch_size < 1:
            raise ValueError(f"batch_size must be positive, got {self.batch_size}")

    # -- device stages ----------------------------------------------------
    @torch.no_grad()
    def _detect_bboxes(self, chunk: Sequence[np.ndarray],
                       imgs_dev: Sequence[torch.Tensor]) -> list[list[BBox]]:
        """Stage [1] for a chunk (JAX batch.py:333-393): per image, the
        letterbox on the device from its uint8 upload, YOLO, decode and
        device NMS as `analyze()` runs them; one fetch for the chunk; then
        unletterbox in float32 as `analyze()` does (a float64 unletterbox
        can round a coordinate to the other integer at .5) and the
        confidence NMS.

        YOLO runs one forward per image: cuDNN picks its convolution
        algorithms by batch size, and in bf16 their other summation orders
        move boxes against analyze()'s batch-1 forward; per image, the
        boxes are analyze()'s."""
        det = self.cfg.detector
        per_image, frames = [], []
        for img, img_dev in zip(chunk, imgs_dev):
            canvas, scale, pads = letterbox(img_dev, det.img_size)
            boxes, scores = decode_predictions(self.analyzer.yolo((canvas / 255.0)[None]),
                                               det.reg_max, det.num_classes)
            per_image.append(postprocess(boxes[0], scores[0], max_detections=det.max_detections,
                                         conf_threshold=det.conf_threshold,
                                         iou_threshold=det.iou_threshold))
            frames.append((scale, pads, img.shape[1], img.shape[0]))
        b_all, s_all, c_all, v_all = (torch.stack(t).cpu() for t in zip(*per_image))
        nms = self.cfg.nms.iou_threshold
        return [geometry.nms_by_confidence(detections_to_bboxes(
                    unletterbox_boxes(b_all[i], scale, pads, w, h).numpy(),
                    s_all[i].numpy(), c_all[i].numpy(), v_all[i].numpy()), iou_threshold=nms)
                for i, (scale, pads, w, h) in enumerate(frames)]

    def _detect_crop_phase(self, chunk: Sequence[np.ndarray]) -> list[_Staged]:
        """Stages [1]-[2] for one chunk: upload each image once as uint8,
        detect, cluster crop."""
        imgs_dev = [torch.as_tensor(np.ascontiguousarray(img), device=self.device)
                    for img in chunk]
        per_image = self._detect_bboxes(chunk, imgs_dev)
        staged = []
        for img, img_dev, nms_boxes in zip(chunk, imgs_dev, per_image):
            crop, bboxes, info = crop_image_and_adjust_bboxes(img, nms_boxes, self.cfg.crop)
            staged.append(_Staged(img, crop, nms_boxes, bboxes, info, image_dev=img_dev))
        return staged

    @torch.no_grad()
    def _segment_phase(self, staged: list[_Staged]) -> tuple[list[_Staged], PackedFetch]:
        """Stage [2b] and topology stage A for one chunk (JAX batch.py:
        415-497): SAM2 on the chunk's crops in one batch, sliced and
        preprocessed from the uploads; per crop the logits resized to the
        crop, thresholded and bit-packed (JAX `_mask_program`, :256-286);
        stage A on each device mask; then the chunk's one fetch."""
        masks_dev: list[Optional[torch.Tensor]] = [None] * len(staged)
        if self.analyzer.sam2 is not None:
            res = self.cfg.sam2.resolution
            batch = []
            for st in staged:
                hc, wc = st.crop.shape[:2]
                info = st.crop_info
                x0, y0 = (info.window[0], info.window[1]) if info.applied else (0, 0)
                batch.append(crop_sam2_preprocess(st.image_dev, y0, x0, hc, wc, res))
            high, _low, _iou = self.analyzer.sam2(torch.stack(batch))
            thr = self.cfg.sam2.mask_threshold
            for i, st in enumerate(staged):
                hc, wc = st.crop.shape[:2]
                logits = resize_linear(high[i:i + 1, ..., 0], (1, hc, wc), antialias=False)[0]
                fg = logits > thr
                st.mask_packed = pack_bits(fg)
                masks_dev[i] = fg.to(torch.uint8) * 255
        else:
            for i, st in enumerate(staged):
                st.mask = segment_classical(st.crop, self.cfg.topology, device=self.device)
        for st, mask in zip(staged, masks_dev):
            st.packed_raster = prepare_packed_raster(
                mask if mask is not None else st.mask, st.bboxes, self.cfg.topology, self.device)
        pending = [t for st in staged for t in (st.mask_packed, st.packed_raster.packed_dev)
                   if t is not None]
        return staged, PackedFetch(pending)

    # -- host stages ------------------------------------------------------
    @staticmethod
    def _unpack(staged: Sequence[_Staged], fetch: PackedFetch) -> list[np.ndarray]:
        """Wait for the chunk's fetch; materialise each SAM2 mask (JAX
        `_materialize_masks`, :499-513) and return each packed raster."""
        host = iter(fetch.get())
        rasters = []
        for st in staged:
            if st.mask_packed is not None:
                wc = st.crop.shape[1]
                st.mask = np.unpackbits(next(host), axis=1)[:, :wc].astype(np.uint8) * 255
            rasters.append(next(host))
        return rasters

    def _pre_topology(self, st: _Staged) -> AnalysisResult:
        """Stage [3] for one image: reclassification, with analyze()'s
        ladder (JAX batch.py:521-540)."""
        result = AnalysisResult(original_image=st.image, image_for_analysis=st.crop,
                                bboxes_orig_nms=st.bboxes_orig_nms, bboxes=st.bboxes,
                                crop_info=st.crop_info, sam_mask=st.mask)
        try:
            result.bboxes = reclassify_terminals(st.crop, result.bboxes, self.cfg.topology,
                                                 device=self.device)
        except Exception as exc:
            if is_device_fault(exc):
                raise
            logger.exception("terminal reclassification failed; continuing")
        return result

    def _enrich_chunk(self, results: Sequence[AnalysisResult]) -> None:
        """Stage [4] for a chunk (JAX batch.py:542-562): every eligible
        crop of every image in one client call, or a crop a call."""
        try:
            enriched = enrich_directions_many(
                [r.image_for_analysis for r in results], [r.bboxes for r in results],
                self.analyzer.vlm_client, self.cfg.enrich,
                debug_stores=[r.vlm_direction_crops for r in results])
            for r, boxes in zip(results, enriched):
                r.bboxes = boxes
        except Exception as exc:
            if is_device_fault(exc):
                raise
            logger.exception("direction enrichment failed; continuing")

    def _extract_nodes_chunk(self, staged: Sequence[_Staged], rasters: Sequence[np.ndarray],
                             results: Sequence[AnalysisResult]) -> None:
        """Stage [5] for a chunk (JAX batch.py:565-623): the host half on
        each fetched raster; on a data error, per-image extraction, and on
        its error the components-only netlist follows."""
        try:
            for st, raster, r in zip(staged, rasters, results):
                r.nodes = finish_from_packed(raster, st.packed_raster, r.bboxes,
                                             self.cfg.topology).nodes
        except Exception as exc:
            if is_device_fault(exc):
                raise
            logger.exception("batched node analysis failed; per-image fallback")
            for r in results:
                try:
                    r.nodes = extract_nodes(r.sam_mask, r.bboxes, self.cfg.topology,
                                            device=self.device, fetch_viz=False).nodes
                except Exception as exc2:
                    if is_device_fault(exc2):
                        raise
                    logger.exception("node analysis failed; continuing")

    def _post_topology(self, result: AnalysisResult) -> AnalysisResult:
        """Stage [6] through the analyzer's own netlist stage and stats, so
        the batched and per-image paths cannot drift."""
        self.analyzer.netlist_stage(result)
        result.component_stats = self.analyzer._component_stats(result.bboxes_orig_nms)
        return result

    # -- entry point ------------------------------------------------------
    def _host_stages(self, staged: list[_Staged], fetch: PackedFetch,
                     finalize: bool) -> list[AnalysisResult]:
        """Stages [3]-[6] of one chunk on the host, after its fetch, and
        with `finalize` stage [7]."""
        rasters = self._unpack(staged, fetch)
        results = [self._pre_topology(st) for st in staged]
        self._enrich_chunk(results)
        self._extract_nodes_chunk(staged, rasters, results)
        results = [self._post_topology(r) for r in results]
        if finalize:
            results = self.analyzer.finalize_netlists(results, chunk_size=self.batch_size)
        return results

    def analyze_many(self, images: Sequence[np.ndarray],
                     finalize: bool = False) -> list[AnalysisResult]:
        """Full pipeline over many images with analyze() semantics, chunk
        by chunk (JAX batch.py:633-748 runs the same stages as threads):

          detect+crop(N) → segment(N) queued → host stages(N − 1)

        `finalize=True` runs the value pass (analyzer.finalize_netlists)
        on each chunk after its host stages (JAX batch.py:736-739): the
        same netlists as analyze_many() and a trailing finalize_netlists.
        An exception in any stage raises here, with nothing left running."""
        images = list(images)
        results: list[AnalysisResult] = []
        pending = None
        for i in range(0, len(images), self.batch_size):
            segmented = self._segment_phase(self._detect_crop_phase(images[i:i + self.batch_size]))
            if pending is not None:
                results.extend(self._host_stages(*pending, finalize))
            pending = segmented
        if pending is not None:
            results.extend(self._host_stages(*pending, finalize))
        return results
