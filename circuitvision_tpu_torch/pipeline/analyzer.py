"""CircuitAnalyzerTorch — the image → netlist pipeline on one CUDA device.

Counterpart of `CircuitAnalyzerTPU.analyze()` in the JAX package
(pipeline/analyzer.py:275-353), stages [1]-[6], of its value pass,
`generate_final_netlist` and `finalize_netlists` (:417-498), and of
`simulate` (:500-520, sim/ on the host):

  [1] detect        — letterbox → YOLOv11 → DFL decode → class-aware NMS,
                      then the reference's confidence NMS at IoU 0.6
  [2] crop          — cluster crop (host box math)
  [2b] segment      — SAM2 forward (Hiera kernels, refinement kernel),
                      logits resized back like jax.image.resize linear
  [3] reclassify    — terminal→source reclassification (classical mask)
  [4] enrich        — component polarities from the VLM client (the
                      trained crop reader in one batch, or an HTTP
                      client a crop at a time on a thread pool); without
                      a client directions stay unset
  [5] nodes         — stage A on the device, contours on the host, and
                      the three debug images drawn as cv2 draws them
                      (core/viz.py; the batched path skips them)
  [6] netlist       — valueless netlist text, visual ids and the
                      enumeration image
  [7] final netlist — the client's {id, class, value} rows merged in
                      (fix_netlist), by generate_final_netlist

A client (`enrich.client.VLMClient`) reads values either box-driven —
handed the undrawn analysis image and the id'd boxes
(`get_labels_batch_boxes`, the trained crop reader) — or from the whole
image with the ids drawn beside the components (`get_labels`, the HTTP
clients; topology/enumerate_components.py draws it as cv2 does), and
directions in one batch (`get_directions_batch`) or a crop a call
(`get_direction`). A client with no way to read labels or none to read
directions is refused when the analyzer is built.

Degradation ladders stay for failures that come from the data: a
reclassification or node-analysis error is logged and the pipeline goes
on, no nodes gives the components-only netlist, a failed direction read
gives UNKNOWN, and a failed value read or merge keeps the valueless
netlist. They never swallow a kernel fault (`KernelError`) or a CUDA,
cuDNN or cuBLAS error (`is_device_fault`), and SAM2 is not guarded at all: given SAM2 weights, a failed
segmentation is an error, not a switch to the classical mask.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..core import geometry, taxonomy
from ..core.config import PipelineConfig, compute_dtype, resolve_device
from ..core.types import AnalysisResult, BBox, StageTimings
from ..enrich.client import VLMClient, default_client
from ..enrich.directions import enrich_directions
from ..models.layers import place
from ..models.sam2.hiera import refused_head_width
from ..models.sam2.wrapper import SAM2ImageSegmenter
from ..models.yolo.decode import decode_predictions, postprocess, unletterbox_boxes
from ..models.yolo.model import YOLOv11
from ..netlist.fix import fix_netlist
from ..netlist.generate import (
    generate_fallback_netlist,
    generate_netlist_from_nodes,
    stringify_netlist,
)
from ..netlist.values import detect_analysis_mode
from ..ops.cuda.build import KernelError, is_device_fault
from ..ops.image import letterbox, resize_linear, sam2_preprocess
from ..sim.engine import perform_ac_analysis, perform_ac_analysis_text, perform_dc_analysis
from ..topology.crop import crop_image_and_adjust_bboxes
from ..topology.enumerate_components import assign_visual_ids, enumerate_components
from ..topology.nodes import extract_nodes
from ..topology.reclassify import reclassify_terminals, segment_classical

logger = logging.getLogger(__name__)


def detections_to_bboxes(boxes: np.ndarray, scores: np.ndarray, classes: np.ndarray,
                         valid: np.ndarray) -> list[BBox]:
    """The valid rows of one image's decoded detections (boxes already in
    image pixels) as BBoxes with rounded coordinates."""
    return [BBox(class_name=taxonomy.ID_TO_NAME.get(int(classes[i]), "unknown"),
                 confidence=float(scores[i]),
                 xmin=round(float(boxes[i, 0])), ymin=round(float(boxes[i, 1])),
                 xmax=round(float(boxes[i, 2])), ymax=round(float(boxes[i, 3])),
                 class_id=int(classes[i]))
            for i in np.nonzero(valid)[0]]


class CircuitAnalyzerTorch:
    """Image-of-circuit → SPICE netlist with the PyTorch port.

    yolo_state / sam2_state are the models' state dicts (models/bridge.py
    makes them from a checkpoint's variables or from a seed). Without
    sam2_state the wire mask is the classical adaptive-threshold mask.
    `vlm_client` (default: the one CIRCUITVISION_VLM names,
    `enrich.client.default_client`, on this device) reads directions and
    values. Runs on the CUDA device unless `device="cpu"` is asked for; a
    missing CUDA device raises instead of moving to the CPU. A bfloat16 SAM2
    on the card whose heads are wider than its kernels take
    (`refused_head_width`: above 256) raises KernelError here, before any
    model is built.
    """

    def __init__(self, config: Optional[PipelineConfig] = None, yolo_state: Optional[dict] = None,
                 sam2_state: Optional[dict] = None, device="cuda",
                 vlm_client: Optional[VLMClient] = None):
        self.cfg = config or PipelineConfig()
        self.device = resolve_device(device, "CircuitAnalyzerTorch")
        self.vlm_client = vlm_client if vlm_client is not None \
            else default_client(self.cfg.enrich, self.device)
        missing = [" or ".join(hooks) for hooks in (("get_labels", "get_labels_batch_boxes"),
                                                     ("get_direction", "get_directions_batch"))
                   if self.vlm_client is not None
                   and all(getattr(self.vlm_client, h, None) is None for h in hooks)]
        if missing:
            raise TypeError(f"{type(self.vlm_client).__name__} is not a VLM client: it has "
                            f"no {' and no '.join(missing)}")
        scfg, sam2_dtype = self.cfg.sam2, compute_dtype(self.cfg.sam2.dtype)
        if sam2_state is not None and self.cfg.use_sam2 and self.device.type == "cuda" \
                and sam2_dtype == torch.bfloat16:
            hd = refused_head_width(scfg.embed_dim, scfg.num_heads)
            if hd is not None:
                raise KernelError(f"SAM2: the bfloat16 kernels take heads no wider than "
                                  f"flash_attn's widest instance; this configuration's "
                                  f"head width is {hd}")
        if yolo_state is None:
            raise ValueError("CircuitAnalyzerTorch needs YOLO weights (yolo_state)")
        det = self.cfg.detector
        self.yolo = YOLOv11(det.num_classes, det.scale, det.reg_max)
        self.yolo.load_state_dict(yolo_state, strict=True)
        place(self.yolo, self.device, compute_dtype(det.dtype)).eval()
        self.sam2 = None
        if sam2_state is not None and self.cfg.use_sam2:
            self.sam2 = SAM2ImageSegmenter(scfg)
            self.sam2.load_state_dict(sam2_state, strict=True)
            place(self.sam2, self.device, sam2_dtype).eval()

    # ------------------------------------------------------------------
    # Stages
    # ------------------------------------------------------------------
    @torch.no_grad()
    def yolo_heads(self, image_rgb: np.ndarray):
        """YOLO's raw per-scale head outputs, (1, H, W, 4·reg_max +
        num_classes) each, on the letterboxed image, with the letterbox
        scale and pads."""
        img = torch.as_tensor(np.ascontiguousarray(image_rgb), device=self.device)
        canvas, scale, pads = letterbox(img, self.cfg.detector.img_size)
        return self.yolo((canvas / 255.0)[None]), scale, pads

    def bboxes(self, image_rgb: np.ndarray) -> list[BBox]:
        """YOLO detections as BBoxes with rounded coords + persistent uids
        (reference CircuitAnalyzer.bboxes, src/circuit_analyzer.py:267-287)."""
        det = self.cfg.detector
        outs, scale, pads = self.yolo_heads(image_rgb)
        boxes, scores = decode_predictions(outs, det.reg_max, det.num_classes)
        boxes, scores, classes, valid = postprocess(
            boxes[0], scores[0], max_detections=det.max_detections,
            conf_threshold=det.conf_threshold, iou_threshold=det.iou_threshold,
        )
        h, w = image_rgb.shape[:2]
        boxes = unletterbox_boxes(boxes, scale, pads, w, h)
        return detections_to_bboxes(*(t.cpu().numpy() for t in (boxes, scores, classes, valid)))

    @torch.no_grad()
    def segment_logits(self, image_rgb: np.ndarray) -> torch.Tensor:
        """SAM2 logits at the image's resolution, (H, W) float32 on the
        device: the fixed-size forward, then a linear resize that matches
        jax.image.resize(..., "linear", antialias=False) both ways."""
        h, w = image_rgb.shape[:2]
        img = torch.as_tensor(np.ascontiguousarray(image_rgb), device=self.device)
        x = sam2_preprocess(img, self.cfg.sam2.resolution)[None]
        high, _low, _iou = self.sam2(x)
        return resize_linear(high[..., 0], (1, h, w), antialias=False)[0]

    def segment_with_sam2(self, image_rgb: np.ndarray):
        """Binary wire mask (0/255) + green display copy at the image's
        resolution (reference segment_with_sam2,
        src/circuit_analyzer.py:321-386)."""
        logits = self.segment_logits(image_rgb)
        mask = ((logits > self.cfg.sam2.mask_threshold).to(torch.uint8) * 255).cpu().numpy()
        display = np.zeros(mask.shape + (3,), np.uint8)
        display[:, :, 1] = mask
        return mask, display

    # ------------------------------------------------------------------
    # Full pipeline
    # ------------------------------------------------------------------
    def analyze(self, image_rgb: np.ndarray) -> AnalysisResult:
        result = AnalysisResult(original_image=image_rgb, timings=StageTimings())
        cfg = self.cfg
        sync = (lambda: torch.cuda.synchronize(self.device)) if self.device.type == "cuda" \
            else (lambda: None)

        # [1] Detection + confidence NMS (src/analysis_pipeline.py:97-115).
        t0 = time.time()
        raw = self.bboxes(image_rgb)
        result.bboxes_orig_nms = geometry.nms_by_confidence(raw, iou_threshold=cfg.nms.iou_threshold)
        result.timings.record("YOLO Component Detection", time.time() - t0)

        # [2] Cluster crop (src/analysis_pipeline.py:168-195).
        t0 = time.time()
        image_for_analysis, bboxes, crop_info = crop_image_and_adjust_bboxes(
            image_rgb, result.bboxes_orig_nms, cfg.crop
        )
        result.image_for_analysis = image_for_analysis
        result.bboxes = bboxes
        result.crop_info = crop_info
        result.timings.record("YOLO-based Image Cropping", time.time() - t0)

        # [2b] SAM2 segmentation on the cropped image (:197-221).
        t0 = time.time()
        if self.sam2 is not None:
            result.sam_mask, result.sam_mask_display = self.segment_with_sam2(image_for_analysis)
        else:
            result.sam_mask = segment_classical(image_for_analysis, cfg.topology,
                                                device=self.device)
        sync()
        result.timings.record("SAM2 Segmentation on YOLO-Cropped Image", time.time() - t0)

        # [3] Terminal reclassification (src/analysis_pipeline.py:117-137).
        t0 = time.time()
        try:
            result.bboxes = reclassify_terminals(image_for_analysis, result.bboxes,
                                                 cfg.topology, device=self.device)
        except Exception as exc:
            if is_device_fault(exc):
                raise
            logger.exception("terminal reclassification failed; continuing")
        result.timings.record("Terminal Reclassification", time.time() - t0)

        # [4] Direction enrichment (:139-166); no client leaves them unset.
        t0 = time.time()
        try:
            result.bboxes = enrich_directions(image_for_analysis, result.bboxes,
                                              self.vlm_client, cfg.enrich,
                                              debug_store=result.vlm_direction_crops)
        except Exception as exc:
            if is_device_fault(exc):
                raise
            logger.exception("direction enrichment failed; continuing")
        result.timings.record("VLM Direction Enrichment", time.time() - t0)

        # [5] Node analysis (:227-260).
        t0 = time.time()
        try:
            extraction = extract_nodes(result.sam_mask, result.bboxes, cfg.topology,
                                       device=self.device)
            result.nodes = extraction.nodes
            result.node_mask = extraction.emptied_mask
            result.enhanced_mask = extraction.enhanced_mask
            result.contour_visualization = extraction.contour_viz
            result.connection_points_visualization = extraction.connection_viz
            result.node_visualization = extraction.node_viz
        except Exception as exc:
            if is_device_fault(exc):
                raise
            logger.exception("node analysis failed; continuing")
        sync()
        result.timings.record("Node Analysis", time.time() - t0)

        # [6] Initial netlist (:262-326).
        t0 = time.time()
        self.netlist_stage(result)
        result.timings.record("Netlist Generation", time.time() - t0)

        result.component_stats = self._component_stats(result.bboxes_orig_nms)
        return result

    def analyze_batch(self, images, batch_size: Optional[int] = None,
                      finalize: bool = False) -> list[AnalysisResult]:
        """Batched analysis of many images on this analyzer's device (JAX
        pipeline/analyzer.py:398-415): chunks of `batch_size` (default 8),
        SAM2 batched over a chunk's crops, the host topology of each chunk
        overlapping the device work of the next (pipeline/batch.py). Same
        stages [1]-[6], the same netlist stage and the same boxes as
        analyze(); `finalize=True` runs the value pass chunk by chunk."""
        from .batch import BatchedPipeline

        return BatchedPipeline(self, batch_size=batch_size).analyze_many(
            list(images), finalize=finalize)

    def netlist_stage(self, result: AnalysisResult) -> None:
        """Stage [6]: initial netlist, the no-VLM-direction comparison
        netlist (:280-292), visual ids and the enumeration image, and the
        components-only fallback (:310-323). A box-driven client's input
        is the undrawn analysis image and the id'd boxes; any other
        client, or none, gets the ids drawn on a copy (:376-392)."""
        if result.nodes:
            result.netlist = generate_netlist_from_nodes(result.nodes)
            result.valueless_netlist_text = stringify_netlist(result.netlist)
            result.netlist_text = result.valueless_netlist_text
            nodes_unknown = [
                dataclasses.replace(n, components=[
                    dataclasses.replace(c, semantic_direction="UNKNOWN") for c in n.components
                ])
                for n in result.nodes
            ]
            result.valueless_netlist_text_no_vlm_dir = stringify_netlist(
                generate_netlist_from_nodes(nodes_unknown)
            )
            if getattr(self.vlm_client, "get_labels_batch_boxes", None) is not None:
                result.enum_image = np.asarray(result.image_for_analysis)
                result.enum_bboxes = assign_visual_ids(result.bboxes)
            else:
                result.enum_image, result.enum_bboxes = enumerate_components(
                    result.image_for_analysis, result.bboxes)
        else:
            logger.warning("no nodes; generating components-only fallback netlist")
            result.netlist = generate_fallback_netlist(result.bboxes)
            result.valueless_netlist_text = stringify_netlist(result.netlist)
            result.netlist_text = result.valueless_netlist_text

    def _merge(self, result: AnalysisResult, rows, what: str) -> None:
        """fix_netlist of one image's stage-2 rows, with the JAX ladder: a
        row that does not merge keeps that image's valueless netlist."""
        result.vlm_stage2_output = rows
        try:
            fix_netlist(result.netlist, rows, result.enum_bboxes)
            result.netlist_text = stringify_netlist(result.netlist)
        except Exception as exc:
            logger.error("VLM merge failed for %s: %s; keeping valueless netlist", what, exc)

    def generate_final_netlist(self, result: AnalysisResult) -> AnalysisResult:
        """Stage [7]: the client's value read and the fix_netlist merge
        (JAX :417-440; reference handle_final_netlist_generation,
        src/analysis_pipeline.py:349-393). A failed read or merge keeps
        the valueless netlist; a kernel fault or CUDA error raises."""
        t0 = time.time()
        if self.vlm_client is None or result.enum_image is None:
            logger.warning("no VLM client or enum image; keeping valueless netlist")
            return result
        boxes_fn = getattr(self.vlm_client, "get_labels_batch_boxes", None)
        try:
            if boxes_fn is not None and result.enum_bboxes is not None:
                rows = boxes_fn([result.enum_image], [result.enum_bboxes])[0]
            else:
                rows = self.vlm_client.get_labels(result.enum_image)
        except Exception as exc:
            if is_device_fault(exc):
                raise
            logger.error("VLM labeling failed: %s; keeping valueless netlist", exc)
        else:
            self._merge(result, rows, "the image")
        result.timings.record("Final Netlist Generation", time.time() - t0)
        return result

    def finalize_netlists(self, results: Sequence[AnalysisResult],
                          chunk_size: Optional[int] = None) -> list[AnalysisResult]:
        """Stage [7] over many results (JAX :441-498): the value reads of
        `chunk_size` images (default 8) in one client call
        (get_labels_batch_boxes, else get_labels_batch), then the merge
        image by image, with generate_final_netlist's ladder per image; a
        client with neither hook goes image by image."""
        results = list(results)
        boxes_fn = getattr(self.vlm_client, "get_labels_batch_boxes", None)
        batch_fn = getattr(self.vlm_client, "get_labels_batch", None)
        if boxes_fn is None and batch_fn is None:
            return [self.generate_final_netlist(r) for r in results]
        chunk = chunk_size or 8
        idx = [i for i, r in enumerate(results) if r.enum_image is not None]
        for i, r in enumerate(results):
            if r.enum_image is None:
                logger.warning("no enum image for result %d; keeping valueless netlist", i)
        for base in range(0, len(idx), chunk):
            sel = idx[base:base + chunk]
            t0 = time.time()
            try:
                if boxes_fn is not None:
                    outs = boxes_fn([results[i].enum_image for i in sel],
                                    [results[i].enum_bboxes for i in sel])
                else:
                    outs = batch_fn([results[i].enum_image for i in sel])
            except Exception as exc:
                if is_device_fault(exc):
                    raise
                logger.error("batched VLM labeling failed: %s; keeping valueless netlists", exc)
                outs = [None] * len(sel)
            dt = (time.time() - t0) / max(len(sel), 1)
            for i, rows in zip(sel, outs):
                if rows is not None:
                    self._merge(results[i], rows, f"result {i}")
                results[i].timings.record("Final Netlist Generation", dt)
        return results

    def simulate(self, result_or_text, frequency_hz: Optional[float] = None):
        """Auto-detected DC/AC simulation (JAX :500-520; reference
        app.py:839-874 + its simulator calls) on the host: an
        AnalysisResult's structured netlist lines take the AC path that
        rewrites source phasors ("4:-45") and C/L reactances, netlist text
        the text path. AC runs at `frequency_hz`, by default
        cfg.sim.default_ac_frequency_hz."""
        if isinstance(result_or_text, AnalysisResult):
            text, netlist = result_or_text.netlist_text, result_or_text.netlist
        else:
            text, netlist = str(result_or_text), None
        if detect_analysis_mode(text) == "AC":
            freq = frequency_hz or self.cfg.sim.default_ac_frequency_hz
            if netlist is not None:
                return perform_ac_analysis(netlist, freq, self.cfg.sim)
            return perform_ac_analysis_text(text, freq, self.cfg.sim)
        return perform_dc_analysis(text, self.cfg.sim)

    @staticmethod
    def _component_stats(bboxes: list[BBox]) -> dict:
        """Per-class counts + confidence totals (src/utils.py:410-430)."""
        stats: dict[str, dict] = {}
        for b in bboxes:
            entry = stats.setdefault(b.class_name, {"count": 0, "total_conf": 0.0})
            entry["count"] += 1
            entry["total_conf"] += b.confidence
        return stats
