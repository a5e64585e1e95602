"""Typed result structures.

Host-side dataclasses (`BBox`, `Node`, `NetlistLine`, `AnalysisResult`)
of the PyTorch port, field-for-field copies of the JAX package's
`core/types.py` without its jit-side `Detections` pytree.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np


@dataclasses.dataclass
class BBox:
    """Host-side bounding box, mirroring the reference bbox dict
    (src/circuit_analyzer.py:276-287). Coordinates are rounded ints.
    """

    class_name: str
    confidence: float
    xmin: int
    ymin: int
    xmax: int
    ymax: int
    class_id: int = -1  # reference '_yolo_class_id_temp'
    persistent_uid: str = ""
    semantic_direction: Optional[str] = None
    semantic_reason: Optional[str] = None
    visual_id: Optional[int] = None  # red enumeration id for the VLM image
    original_class_if_reclassified: Optional[str] = None
    was_reclassified_from_terminal: bool = False

    def __post_init__(self):
        if not self.persistent_uid:
            # uid scheme: f"{class}_{xmin}_{ymin}_{xmax}_{ymax}"
            # (src/circuit_analyzer.py:285)
            self.persistent_uid = (
                f"{self.class_name}_{self.xmin}_{self.ymin}_{self.xmax}_{self.ymax}"
            )

    # -- geometry helpers -------------------------------------------------
    @property
    def width(self) -> int:
        return self.xmax - self.xmin

    @property
    def height(self) -> int:
        return self.ymax - self.ymin

    @property
    def area(self) -> int:
        return max(0, self.width) * max(0, self.height)

    @property
    def center(self) -> tuple[float, float]:
        return (self.xmin + self.width / 2.0, self.ymin + self.height / 2.0)

    def scaled(self, wx: float, wy: float) -> "BBox":
        """Scale coordinates (int-truncating like src/circuit_analyzer.py:466-469),
        preserving every other field including the persistent uid."""
        b = dataclasses.replace(
            self,
            xmin=int(self.xmin * wx),
            ymin=int(self.ymin * wy),
            xmax=int(self.xmax * wx),
            ymax=int(self.ymax * wy),
        )
        return b

    def shifted_clipped(self, dx: int, dy: int, w: int, h: int) -> Optional["BBox"]:
        """Shift by (-dx, -dy) and clip to (w, h); None if degenerate
        (src/circuit_analyzer.py:1262-1277)."""
        nxmin = max(0, self.xmin - dx)
        nymin = max(0, self.ymin - dy)
        nxmax = min(w, self.xmax - dx)
        nymax = min(h, self.ymax - dy)
        if nxmax > nxmin and nymax > nymin:
            return dataclasses.replace(self, xmin=nxmin, ymin=nymin, xmax=nxmax, ymax=nymax)
        return None

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["class"] = d.pop("class_name")
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "BBox":
        return cls(
            class_name=d.get("class", d.get("class_name", "unknown")),
            confidence=float(d.get("confidence", 0.0)),
            xmin=int(d["xmin"]),
            ymin=int(d["ymin"]),
            xmax=int(d["xmax"]),
            ymax=int(d["ymax"]),
            class_id=int(d.get("_yolo_class_id_temp", d.get("class_id", -1))),
            persistent_uid=d.get("persistent_uid", ""),
            semantic_direction=d.get("semantic_direction"),
            semantic_reason=d.get("semantic_reason"),
            visual_id=d.get("id", d.get("visual_id")),
        )


@dataclasses.dataclass
class Node:
    """Electrical node: a wire region and the components touching it
    (reference node dict, src/circuit_analyzer.py:1374,1547-1582)."""

    id: int
    components: list[BBox]
    centroid: tuple[float, float]  # (x, y) in analysis (resized) space
    area: float = 0.0
    label: int = -1  # connected-component label this node came from

    def component_uids(self) -> list[str]:
        return [c.persistent_uid for c in self.components]


@dataclasses.dataclass
class NetlistLine:
    """One netlist entry (reference line dict, src/circuit_analyzer.py:1751-1761)."""

    component_type: str
    component_num: Optional[int]
    node_1: Any
    node_2: Any
    value: Any
    class_name: str = ""
    persistent_uid: str = ""
    visual_id: Optional[int] = None
    semantic_direction: Optional[str] = None
    semantic_reason: Optional[str] = None
    source: Optional[BBox] = None

    def stringify(self) -> str:
        """SPICE text form (src/circuit_analyzer.py:1909-1927)."""
        if self.class_name == "gnd" or not self.component_type:
            return ""
        if self.component_num is None or self.node_1 is None or self.node_2 is None:
            return ""
        return f"{self.component_type}{self.component_num} {self.node_1} {self.node_2} {self.value}"


@dataclasses.dataclass
class CropInfo:
    """Crop decision record (reference crop_debug_info,
    src/circuit_analyzer.py:954-971)."""

    applied: bool = False
    reason_for_no_crop: Optional[str] = None
    original_dims: tuple[int, int] = (0, 0)  # (w, h)
    cropped_dims: tuple[int, int] = (0, 0)
    window: Optional[tuple[int, int, int, int]] = None  # xmin,ymin,xmax,ymax
    num_clusters: Optional[int] = None
    decision_source: str = "unknown"
    clustering_threshold: Optional[int] = None
    basis_bbox: Optional[tuple[int, int, int, int]] = None
    text_expansions: list = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class StageTimings:
    """Per-stage wall-clock (reference detailed_timings,
    src/analysis_pipeline.py:99-385)."""

    timings: dict = dataclasses.field(default_factory=dict)

    def record(self, stage: str, seconds: float) -> None:
        self.timings[stage] = seconds

    def total(self) -> float:
        return sum(self.timings.values())


@dataclasses.dataclass
class AnalysisResult:
    """Full pipeline output — the typed replacement for the reference's
    `active_results` session dict (src/analysis_pipeline.py:25-45)."""

    original_image: Optional[np.ndarray] = None
    image_for_analysis: Optional[np.ndarray] = None
    bboxes_orig_nms: list[BBox] = dataclasses.field(default_factory=list)
    bboxes: list[BBox] = dataclasses.field(default_factory=list)
    crop_info: Optional[CropInfo] = None
    sam_mask: Optional[np.ndarray] = None  # uint8 0/255 at analysis-image resolution
    sam_mask_display: Optional[np.ndarray] = None
    nodes: list[Node] = dataclasses.field(default_factory=list)
    netlist: list[NetlistLine] = dataclasses.field(default_factory=list)
    netlist_text: str = ""
    valueless_netlist_text: str = ""
    valueless_netlist_text_no_vlm_dir: str = ""
    enum_image: Optional[np.ndarray] = None
    enum_bboxes: list[BBox] = dataclasses.field(default_factory=list)
    annotated_image: Optional[np.ndarray] = None
    component_stats: dict = dataclasses.field(default_factory=dict)
    vlm_stage2_output: Optional[list] = None
    node_mask: Optional[np.ndarray] = None
    enhanced_mask: Optional[np.ndarray] = None
    node_visualization: Optional[np.ndarray] = None
    #: colored wire-contour outlines (reference src/circuit_analyzer.py:405-458)
    contour_visualization: Optional[np.ndarray] = None
    #: contour viz + cyan terminal contact points (reference :1598-1601)
    connection_points_visualization: Optional[np.ndarray] = None
    #: persistent_uid → padded crop sent to the direction VLM (the
    #: reference's analyzer.last_vlm_input_images debug store,
    #: app.py:643-683)
    vlm_direction_crops: dict = dataclasses.field(default_factory=dict)
    timings: StageTimings = dataclasses.field(default_factory=StageTimings)
