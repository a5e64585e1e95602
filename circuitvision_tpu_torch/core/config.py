"""Typed configuration tree of the PyTorch port: the JAX package's
`core/config.py` without JAX and without the fields the port never reads
(MXU channel padding). `MeshConfig` lays the ranks of a
torch.distributed run out as a (data, model) grid (parallel/mesh.py).

Every magic number that is inlined in the reference implementation
(src/circuit_analyzer.py and src/analysis_pipeline.py of the reference
app) is promoted to a named, typed field here so the whole pipeline is
configurable and testable.

Reference provenance (file:line in the reference app):
  - NMS IoU 0.6                      src/analysis_pipeline.py:106
  - crop padding 80                  src/analysis_pipeline.py:181
  - cluster multipliers 2.0 / 2.5    src/circuit_analyzer.py:1009,1017
  - cluster minima 30 / 20           src/circuit_analyzer.py:1009,1017
  - skip-crop area fraction 0.90     src/circuit_analyzer.py:1177
  - text inclusion padding 20        src/circuit_analyzer.py:1194
  - text far-check padding 150       src/circuit_analyzer.py:1203
  - analysis resize height 600       src/circuit_analyzer.py:787
  - contour area threshold 4e-4      src/circuit_analyzer.py:388
  - prelim contour threshold 1e-4    src/circuit_analyzer.py:2254
  - terminal pixel thresholds 6/8/20 src/circuit_analyzer.py:1407-1415
  - reclass threshold 10             src/circuit_analyzer.py:2277
  - VLM crop padding 15              src/circuit_analyzer.py:2176
  - LoRA r=4 alpha=16 dropout=0.3    src/circuit_analyzer.py:209-211
  - SAM2 resolution 1024             models/configs/sam2.1_hiera_l.yaml:89
  - loss weights                     src/circuit_analyzer.py:218-222
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch


@dataclasses.dataclass(frozen=True)
class DetectorConfig:
    """YOLOv11 detector configuration (reference: ultralytics YOLOv11-L)."""

    num_classes: int = 62
    img_size: int = 640
    # 'n' | 's' | 'm' | 'l' | 'x' compound-scaling preset.
    scale: str = "l"
    reg_max: int = 16  # DFL bins per box side.
    conf_threshold: float = 0.25
    iou_threshold: float = 0.7  # device NMS inside decode (ultralytics default)
    max_detections: int = 128  # static padding bound under jit
    dtype: str = "bfloat16"


@dataclasses.dataclass(frozen=True)
class SAM2Config:
    """SAM 2.1 Hiera-Large image-path configuration.

    Mirrors models/configs/sam2.1_hiera_l.yaml in the reference (the
    memory attention/encoder sections of that config are bypassed by the
    image-only wrapper, src/sam2_infer.py:191-275, and are not built).
    """

    resolution: int = 1024
    # Hiera trunk (yaml:10-16)
    embed_dim: int = 144
    num_heads: int = 2
    stages: Sequence[int] = (2, 6, 36, 4)
    global_att_blocks: Sequence[int] = (23, 33, 43)
    window_pos_embed_bkg_spatial_size: Sequence[int] = (7, 7)
    window_spec: Sequence[int] = (8, 4, 16, 8)
    # FPN neck (yaml:17-28)
    d_model: int = 256
    backbone_channel_list: Sequence[int] = (1152, 576, 288, 144)
    fpn_top_down_levels: Sequence[int] = (2, 3)
    scalp: int = 1
    # Mask decoder
    decoder_mlp_dim: int = 2048
    num_multimask_outputs: int = 3
    iou_head_depth: int = 3
    iou_head_hidden_dim: int = 256
    pred_obj_scores: bool = True
    pred_obj_scores_mlp: bool = True
    use_high_res_features: bool = True
    dynamic_multimask_via_stability: bool = True
    dynamic_multimask_stability_delta: float = 0.05
    dynamic_multimask_stability_thresh: float = 0.98
    # Prompt-free wrapper extras (src/sam2_infer.py:206-218)
    trainable_embedding_r: int = 4
    sparse_embedding_len: int = 32
    use_refinement: bool = True
    refinement_kernels: Sequence[int] = (3, 5, 7, 11)
    refinement_channels: int = 4
    mask_threshold: float = 0.0
    dtype: str = "bfloat16"


# Hiera family presets, from the published facebookresearch/sam2
# sam2.1_hiera_{t,s,b+,l}.yaml configs (the reference ships only the L
# yaml, models/configs/sam2.1_hiera_l.yaml — it is the default above).
# The whole trunk is parametric, so the other family members are pure
# config: non-divisible window specs (14 over a 64-wide stage-3 map)
# route through window_partition's padding path, and the fused-kernel
# gates fall back to the module path where their preconditions fail.
_SAM2_HIERA_PRESETS: dict[str, dict] = {
    "t": dict(
        embed_dim=96, num_heads=1, stages=(1, 2, 7, 2),
        global_att_blocks=(5, 7, 9), window_spec=(8, 4, 14, 7),
        window_pos_embed_bkg_spatial_size=(7, 7),
        backbone_channel_list=(768, 384, 192, 96),
    ),
    "s": dict(
        embed_dim=96, num_heads=1, stages=(1, 2, 11, 2),
        global_att_blocks=(7, 10, 13), window_spec=(8, 4, 14, 7),
        window_pos_embed_bkg_spatial_size=(7, 7),
        backbone_channel_list=(768, 384, 192, 96),
    ),
    "b+": dict(
        embed_dim=112, num_heads=2, stages=(2, 3, 16, 3),
        global_att_blocks=(12, 16, 20), window_spec=(8, 4, 14, 7),
        window_pos_embed_bkg_spatial_size=(14, 14),
        backbone_channel_list=(896, 448, 224, 112),
    ),
    "l": dict(),  # the dataclass defaults ARE the L config
}


def sam2_hiera_preset(size: str, **overrides) -> "SAM2Config":
    """SAM2Config for a Hiera family member: 't', 's', 'b+', or 'l'."""
    if size not in _SAM2_HIERA_PRESETS:
        raise ValueError(
            f"unknown Hiera size {size!r}; choose from "
            f"{sorted(_SAM2_HIERA_PRESETS)}"
        )
    return SAM2Config(**{**_SAM2_HIERA_PRESETS[size], **overrides})


@dataclasses.dataclass(frozen=True)
class CropConfig:
    """YOLO-cluster intelligent crop (src/circuit_analyzer.py:937-1284)."""

    padding: int = 80  # src/analysis_pipeline.py:181
    cluster_multiplier: float = 2.0  # non-junction avg-diag multiplier
    cluster_multiplier_junction_only: float = 2.5
    cluster_min_threshold: int = 30
    cluster_min_threshold_junction_only: int = 20
    text_assoc_multiplier: float = 0.75
    text_assoc_min: int = 25
    skip_crop_area_fraction: float = 0.90
    text_inclusion_padding: int = 20
    text_far_check_padding: int = 150


@dataclasses.dataclass(frozen=True)
class TopologyConfig:
    """Node extraction (src/circuit_analyzer.py:1286-1605)."""

    resize_height: int = 600  # analysis runs in resized space (:787)
    contour_area_threshold: float = 4.0e-4  # :388
    prelim_contour_area_threshold: float = 1.0e-4  # :2254
    pixel_threshold_default: int = 6  # :1407
    pixel_threshold_source: int = 20  # :1412
    pixel_threshold_diode: int = 8  # :1415
    reclass_pixel_threshold: int = 10  # :2277
    reclass_min_connections: int = 2  # :2293
    # enhance_lines (src/circuit_analyzer.py:289-311)
    blur_kernel: int = 5
    blur_sigma: float = 1.0
    morph_kernel: int = 3
    morph_iterations: int = 2
    # segment_circuit adaptive threshold (src/circuit_analyzer.py:313-319)
    adaptive_block: int = 31
    adaptive_c: int = 21
    # connected-component labels carried through the device node stage
    # (JAX core/config.py:184)
    max_labels: int = 64
    # Run enhance_lines as the one-pass `enhance_lines_fused` kernel
    # (ops/cuda/morphology.py) at the default blur/morphology parameters
    # on a CUDA raster; off, or on the CPU, the reference enhance_lines
    # runs (JAX core/config.py:187, gate topology/nodes.py:99-109).
    use_fused_morphology: bool = False


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """The (data, model) grid of ranks for batched inference and training
    (JAX core/config.py:222-231); one rank holds one device."""

    data_axis: str = "data"
    model_axis: str = "model"
    data_parallel: int = -1  # -1: all ranks
    model_parallel: int = 1
    #: images per chunk of the batched path when the caller names none
    batch_per_device: int = 8


#: images per chunk of the batched path when the caller names none (the
#: JAX package's MeshConfig.batch_per_device, on one card)
BATCH_PER_DEVICE = MeshConfig().batch_per_device


@dataclasses.dataclass(frozen=True)
class NMSConfig:
    iou_threshold: float = 0.6  # src/analysis_pipeline.py:106


@dataclasses.dataclass(frozen=True)
class EnrichConfig:
    """Polarity/value enrichment (JAX core/config.py:196-205): the padding
    of the direction crops, the HTTP clients' models and direction-call
    generation parameters (enrich/client.default_client), and the
    workers of the per-crop direction reads (enrich/directions.py)."""

    crop_padding: int = 15  # src/circuit_analyzer.py:2176
    direction_model: str = "gemini-2.5-flash-lite-preview-06-17"
    labels_model: str = "google/gemini-2.5-flash-preview"
    temperature: float = 0.1
    top_p: float = 0.98
    max_output_tokens: int = 1024
    max_concurrency: int = 8  # reference loops serially; the port reads on a pool


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """SPICE analysis (src/spice_simulator.py:69-76 tolerances); the JAX
    package's SimConfig (core/config.py:209-218) without `temperature_c`,
    which nothing reads."""

    gmin: float = 1e-12
    abstol: float = 1e-12
    reltol: float = 1e-6
    max_newton_iters: int = 100
    default_ac_frequency_hz: float = 60.0
    #: the C++ solver, built with g++ at first use (a failed build raises);
    #: False: the numpy solver (sim/engine.py)
    prefer_native: bool = True


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """SAM2 LoRA fine-tune hyper-params (src/sam2_infer.py:297-304); the
    JAX package's TrainConfig (core/config.py:235-279), field for field."""

    weight_dice: float = 0.5
    weight_focal: float = 0.4
    weight_iou: float = 0.3
    weight_freq: float = 0.1
    focal_alpha: float = 0.25
    focal_gamma: float = 2.0
    dice_smooth: float = 1e-5
    iou_smooth: float = 1e-5
    learning_rate: float = 1e-3
    #: LR schedule: "constant" (reference-parity default) or "cosine"
    #: (linear warmup → cosine decay to min_lr_ratio·learning_rate over
    #: total_steps — the standard production fine-tune shape).
    schedule: str = "constant"
    warmup_steps: int = 0
    total_steps: int = 0
    min_lr_ratio: float = 0.0
    #: average gradients over k micro-batches before each optimizer
    #: update (train/train_step.py; optax.MultiSteps in the JAX package —
    #: the accumulation buffer costs one copy of the TRAINABLE leaves, not
    #: the frozen ~78% of SAM2-L). Effective batch = k × device batch;
    #: total_steps/warmup_steps count optimizer UPDATES, not micro-steps.
    grad_accum_steps: int = 1
    #: exponential-moving-average decay for an eval-weights shadow of the
    #: trainable leaves (0 = off); train_step.init_ema/update_ema/ema_params.
    ema_decay: float = 0.0
    #: rank-r LoRA adapters on the reference's 36 target modules
    #: (src/circuit_analyzer.py:209-211: r=4, alpha=16; lora_dropout=0.3
    #: is a training-time activation regularizer PEFT applies before
    #: lora_A — the weight-space adapters here omit it, documented in
    #: train/lora.py).
    lora_rank: int = 4
    lora_alpha: float = 16.0

    def __post_init__(self):
        # grad_accum_steps < 1 would silently disable accumulation in
        # make_optimizer (its `> 1` gate) while callers still divide or
        # modulo by it (ZeroDivisionError at 0, nonsense at negatives).
        if self.grad_accum_steps < 1:
            raise ValueError(
                f"grad_accum_steps must be >= 1, got {self.grad_accum_steps}"
            )


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Top-level config tree."""

    detector: DetectorConfig = dataclasses.field(default_factory=DetectorConfig)
    sam2: SAM2Config = dataclasses.field(default_factory=SAM2Config)
    crop: CropConfig = dataclasses.field(default_factory=CropConfig)
    topology: TopologyConfig = dataclasses.field(default_factory=TopologyConfig)
    nms: NMSConfig = dataclasses.field(default_factory=NMSConfig)
    enrich: EnrichConfig = dataclasses.field(default_factory=EnrichConfig)
    sim: SimConfig = dataclasses.field(default_factory=SimConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    use_sam2: bool = True


def compute_dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}[name]


def resolve_device(device, who: str) -> torch.device:
    """The device an entry point runs on: CUDA unless another device (such
    as "cpu") is asked for. A missing CUDA device raises instead of moving
    the work to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{who}: CUDA is not available; pass device='cpu' to run on the CPU")
    return dev
