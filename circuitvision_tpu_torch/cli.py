"""Command-line interface of the PyTorch port.

    python -m circuitvision_tpu_torch.cli analyze circuit.jpg --netlist out.cir \\
        --yolo-checkpoint ckpt/yolo --sam2-checkpoint ckpt/sam2 --simulate dc
    python -m circuitvision_tpu_torch.cli analyze-batch imgs/ --out-dir netlists/ --final
    python -m circuitvision_tpu_torch.cli simulate netlist.cir
    python -m circuitvision_tpu_torch.cli serve --port 8501 \\
        --yolo-checkpoint ckpt/yolo --sam2-checkpoint ckpt/sam2
    python -m circuitvision_tpu_torch.cli serve-batch --port 8600 --final \\
        --yolo-checkpoint ckpt/yolo --sam2-checkpoint ckpt/sam2

The JAX package's `cli.py` with its subcommands and flags, on the port:
checkpoints are read by the port's orbax reader
(`models/checkpoint.load_model_checkpoint`), and a checkpoint's
meta.json gives its model config (`models/bridge.detector_config`,
`sam2_config`); without a YOLO checkpoint the detector gets seeded random
weights at `--scale` (and `--det-size`), as the JAX CLI initialises
random ones. The directions and, with `--final`, the values come from the
client the environment names (`enrich/client.default_client`):
CIRCUITVISION_VLM=reader:ckpt/reader is the trained crop reader;
otherwise GEMINI_API_KEY or OPENROUTER_API_KEY gives that service's
client, which reads the drawn enumeration image. Images are PNG, JPEG,
BMP, WebP, GIF, TIFF, PNM, ICO/CUR or TGA (`io/image_io`; `analyze-batch`
takes the JAX CLI's five extensions), decoded as the JAX package's PIL
decodes them; a file the reader refuses (JPEG 2000, AVIF, ROADMAP Queue
A 19) fails `analyze`, and `analyze-batch` skips it and says which it
skipped. `serve` is the web
UI (webapp.py), `serve-batch` the micro-batching endpoint; both print
`serving on port N` (port 0: an ephemeral one).

`--device` (default cuda) takes the place of the JAX CLI's `--platform`:
every command but `simulate` (host only) runs on the card unless `--device
cpu` is given, and fails without one; `cuda:K` names card K.

`analyze-batch --distributed` is one rank of a torch.distributed run (one
process per rank, started by torchrun or with its environment:
MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK, LOCAL_RANK, LOCAL_WORLD_SIZE;
parallel/multihost.py). Each rank decodes and analyzes its share of the
images on its own device — cuda:LOCAL_RANK, or the card `--device cuda:K`
names — and rank 0 writes every netlist. `--backend` picks the collective
library: nccl (the default on the card; one rank per card) or gloo (the
CPU, and ranks that share one card):

    torchrun --nproc-per-node 2 -m circuitvision_tpu_torch.cli analyze-batch \\
        --distributed --device cpu imgs/ --out-dir netlists/
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

#: seed of the random weights given to a model that has no checkpoint
SEED = 0


def _detector(args, meta):
    """The detector config: a checkpoint's meta when it has one (a flag
    that contradicts it is an error), else the flags."""
    from .core.config import DetectorConfig
    from .models.bridge import detector_config

    det_size = getattr(args, "det_size", None)
    if "detector" not in meta:
        return DetectorConfig(scale=args.scale or "l", img_size=det_size or 640)
    det = detector_config(meta)
    for flag, given, have in (("--scale", args.scale, det.scale),
                              ("--det-size", det_size, det.img_size)):
        if given is not None and given != have:
            raise SystemExit(f"{flag} {given} contradicts the YOLO checkpoint's {have}")
    return det


def _analyzer(args):
    """CircuitAnalyzerTorch of the checkpoint flags on `--device`."""
    from .core.config import PipelineConfig, SAM2Config
    from .models import bridge
    from .models.checkpoint import load_model_checkpoint
    from .pipeline.analyzer import CircuitAnalyzerTorch

    if args.yolo_checkpoint:
        yv, ymeta = load_model_checkpoint(args.yolo_checkpoint)
        det = _detector(args, ymeta)
        ystate = bridge.state_dict_from_variables(yv)
    else:
        det = _detector(args, {})
        ystate = bridge.seeded_state("yolo", {"detector": {
            "scale": det.scale, "img_size": det.img_size, "num_classes": det.num_classes,
            "reg_max": det.reg_max}}, SEED)
    sam2, sstate = SAM2Config(), None
    if args.sam2_checkpoint:
        sv, smeta = load_model_checkpoint(args.sam2_checkpoint)
        sam2, sstate = bridge.sam2_config(smeta), bridge.state_dict_from_variables(sv)
    elif args.force_sam2:
        sstate = bridge.seeded_state("sam2", {"sam2": {"preset": "l"}}, SEED)
    cfg = PipelineConfig(detector=det, sam2=sam2, use_sam2=sstate is not None)
    return CircuitAnalyzerTorch(cfg, ystate, sstate, device=args.device)


def _cmd_analyze(args) -> int:
    from .io.image_io import load_image

    image = load_image(args.image)
    analyzer = _analyzer(args)
    result = analyzer.analyze(image)
    if args.final:
        result = analyzer.generate_final_netlist(result)

    print("=== detections ===")
    for b in result.bboxes_orig_nms:
        print(f"  {b.class_name:28s} conf={b.confidence:.2f} "
              f"[{b.xmin},{b.ymin},{b.xmax},{b.ymax}]")
    print(f"=== nodes: {len(result.nodes)} ===")
    print("=== netlist ===")
    print(result.netlist_text or "(empty)")
    print("=== timings ===")
    for stage, sec in result.timings.timings.items():
        print(f"  {stage:42s} {sec*1000:9.1f} ms")

    if args.netlist:
        with open(args.netlist, "w") as f:
            f.write(result.netlist_text + "\n")
        print(f"netlist written to {args.netlist}")

    if args.simulate:
        _print_sim(analyzer.simulate(result, frequency_hz=args.frequency))
    return 0


def _print_sim(sim) -> None:
    if not sim.ok:
        print(f"simulation failed: {sim.error}")
        return
    print("=== node voltages ===")
    print(json.dumps(sim.node_voltages, indent=2, ensure_ascii=False))
    print("=== branch currents ===")
    print(json.dumps(sim.branch_currents, indent=2, ensure_ascii=False))


def _image_paths(args_images) -> list:
    """The image files of the arguments: files as given, a directory's
    images sorted by name."""
    exts = (".png", ".jpg", ".jpeg", ".bmp", ".webp")
    paths = []
    for p in args_images:
        if os.path.isdir(p):
            paths.extend(sorted(
                os.path.join(p, f) for f in os.listdir(p)
                if f.lower().endswith(exts)
            ))
        else:
            paths.append(p)
    return paths


def _cmd_analyze_batch(args) -> int:
    """Batched multi-image analysis (pipeline/batch.py), the throughput
    path, with per-image netlist output."""
    from .io.image_io import ImageFormatError, load_image

    if args.distributed:
        # before any CUDA work: the rank's device and the process group
        from .parallel import multihost

        if multihost.initialize(backend=args.backend, device=args.device):
            args.device = str(multihost.device())
        try:
            return _run_distributed(args, _image_paths(args.images))
        finally:
            multihost.shutdown()
    paths = _image_paths(args.images)
    if not paths:
        print("no images found", file=sys.stderr)
        return 1

    images, kept = [], []
    for p in paths:
        try:
            images.append(load_image(p))
            kept.append(p)
        except ImageFormatError as exc:
            print(f"skipped {p}: {exc}", file=sys.stderr)
    if len(kept) < len(paths):
        print(f"skipped {len(paths) - len(kept)} of {len(paths)} images", file=sys.stderr)
    if not images:
        print("no readable images", file=sys.stderr)
        return 1
    paths = kept
    analyzer = _analyzer(args)
    t0 = time.time()
    results = analyzer.analyze_batch(images, batch_size=args.batch_size, finalize=args.final)
    dt = time.time() - t0

    if args.out_dir:
        os.makedirs(args.out_dir, exist_ok=True)
    for path, res in zip(paths, results):
        name = os.path.splitext(os.path.basename(path))[0]
        n_lines = len((res.netlist_text or "").splitlines())
        print(f"{name}: {len(res.bboxes_orig_nms)} detections, "
              f"{len(res.nodes)} nodes, {n_lines} netlist lines")
        if args.out_dir:
            with open(os.path.join(args.out_dir, f"{name}.cir"), "w") as f:
                f.write((res.netlist_text or "") + "\n")
    print(f"{len(images)} images in {dt:.2f}s ({len(images) / dt:.2f} images/s, "
          f"first-call set-up included)")
    return 0


class _LazyImages:
    """A len/getitem view over image paths that decodes on access, so each
    rank of a distributed run decodes only its own span."""

    def __init__(self, paths):
        from .io.image_io import load_image

        self._paths = paths
        self._load = load_image

    def __len__(self):
        return len(self._paths)

    def __getitem__(self, i):
        return self._load(self._paths[i])


def _run_distributed(args, paths) -> int:
    """analyze-batch over ranks: each analyzes its balanced span of the
    image list on its own device; rank 0 writes the gathered netlists and
    prints images/s. Without a launcher's environment it is one rank over
    every image. An image kind the reader refuses fails its rank."""
    from .parallel import multihost

    if not paths:
        print("no images found", file=sys.stderr)
        return 1
    analyzer = _analyzer(args)
    multihost.sync("analyze-batch")  # every rank starts the clock together
    t0 = time.time()
    local_results, netlists = multihost.analyze_many_distributed(
        analyzer, _LazyImages(paths), batch_size=args.batch_size, final=args.final)
    dt = time.time() - t0

    pid, nproc = multihost.process_index(), multihost.process_count()
    span = multihost.balanced_span(len(paths))
    print(f"[rank {pid}] images {span.start}:{span.stop} of {len(paths)} on {args.device}")
    for gi, res in zip(span, local_results):
        name = os.path.splitext(os.path.basename(paths[gi]))[0]
        print(f"[rank {pid}] {name}: {len(res.bboxes_orig_nms)} detections, "
              f"{len(res.nodes)} nodes")
    if pid == 0:
        if args.out_dir:
            os.makedirs(args.out_dir, exist_ok=True)
            for path, net in zip(paths, netlists):
                name = os.path.splitext(os.path.basename(path))[0]
                with open(os.path.join(args.out_dir, f"{name}.cir"), "w") as f:
                    f.write((net["netlist"] or net["valueless"] or "") + "\n")
        # the window holds each rank's decoding of its span and its first
        # call's set-up
        print(f"{len(paths)} images over {nproc} rank(s) in {dt:.2f}s "
              f"({len(paths) / dt:.2f} images/s incl. decode and set-up)")
    return 0


def _cmd_serve(args) -> int:
    """The interactive web UI (webapp.py), one analysis at a time, with
    the analyzer of the checkpoint flags."""
    from .webapp import serve

    serve(_analyzer(args), port=args.port)
    print("server stopped", flush=True)
    return 0


def _cmd_serve_batch(args) -> int:
    """Production serving: the micro-batching HTTP endpoint
    (pipeline/server.py), which groups concurrent POST /analyze requests
    into device batches."""
    from .pipeline.server import serve

    serve(_analyzer(args), port=args.port, batch_size=args.batch_size,
          max_wait_ms=args.max_wait_ms, final=args.final)
    print("server stopped; in-flight batches drained", flush=True)
    return 0


def _cmd_simulate(args) -> int:
    from .core.config import SimConfig
    from .netlist.values import detect_analysis_mode
    from .sim.engine import perform_ac_analysis_text, perform_dc_analysis

    with open(args.netlist) as f:
        text = f.read()
    mode = args.mode or ("ac" if detect_analysis_mode(text) == "AC" else "dc")
    if mode == "ac":
        sim = perform_ac_analysis_text(text, args.frequency, SimConfig())
    else:
        sim = perform_dc_analysis(text, SimConfig())
    _print_sim(sim)
    return 0 if sim.ok else 1


def _device_arg(value: str) -> str:
    """cuda, cuda:K or cpu."""
    kind, _, index = value.partition(":")
    if value not in ("cuda", "cpu") and not (kind == "cuda" and index.isdigit()):
        raise argparse.ArgumentTypeError(f"{value!r}: expected cuda, cuda:K or cpu")
    return value


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="circuitvision_tpu_torch")
    device = argparse.ArgumentParser(add_help=False)
    device.add_argument("--device", type=_device_arg, default="cuda",
                        help="where the models run: cuda (default: the card), cuda:K or cpu")
    sub = parser.add_subparsers(dest="cmd", required=True)

    pa = sub.add_parser("analyze", parents=[device], help="image → netlist (± simulation)")
    pa.add_argument("image")
    pa.add_argument("--netlist", help="write netlist text to this path")
    pa.add_argument("--simulate", choices=["dc", "ac"], default=None,
                    help="simulate the netlist (DC or AC is detected from it)")
    pa.add_argument("--frequency", type=float, default=60.0)
    pa.add_argument("--final", action="store_true", help="run the VLM value pass")
    pa.add_argument("--scale", default=None, choices=list("nsmlx"),
                    help="YOLO size without a checkpoint (default l)")
    pa.add_argument("--yolo-checkpoint")
    pa.add_argument("--sam2-checkpoint")
    pa.add_argument("--force-sam2", action="store_true",
                    help="use SAM2 with random weights (debug)")

    pb = sub.add_parser("analyze-batch", parents=[device],
                        help="batched analysis of many images (throughput path)")
    pb.add_argument("images", nargs="+", help="image paths, or a single directory of images")
    pb.add_argument("--out-dir", help="write per-image netlists here")
    pb.add_argument("--batch-size", type=int, default=None)
    pb.add_argument("--final", action="store_true",
                    help="run the VLM value pass, one client call per chunk")
    pb.add_argument("--scale", default=None, choices=list("nsmlx"))
    pb.add_argument("--det-size", type=int, default=None,
                    help="detector input size without a checkpoint (default 640)")
    pb.add_argument("--yolo-checkpoint")
    pb.add_argument("--sam2-checkpoint")
    pb.add_argument("--force-sam2", action="store_true")
    pb.add_argument("--distributed", action="store_true",
                    help="one rank of a torch.distributed run (torchrun's environment: "
                    "MASTER_ADDR/MASTER_PORT/WORLD_SIZE/RANK/LOCAL_RANK/LOCAL_WORLD_SIZE): "
                    "split the image list across ranks (parallel/multihost.py); rank 0 "
                    "writes the netlists")
    pb.add_argument("--backend", choices=["nccl", "gloo"], default=None,
                    help="with --distributed: nccl (the default on the card, one rank per "
                    "card) or gloo (the CPU, and ranks that share one card)")

    ps = sub.add_parser("simulate", help="simulate an existing netlist file")
    ps.add_argument("netlist")
    ps.add_argument("--mode", choices=["dc", "ac"], default=None)
    ps.add_argument("--frequency", type=float, default=60.0)

    pv = sub.add_parser("serve", parents=[device],
                        help="the web UI (one analysis at a time)")
    pv.add_argument("--port", type=int, default=8501, help="0: an ephemeral port (printed)")
    pv.add_argument("--scale", default=None, choices=list("nsmlx"))
    pv.add_argument("--det-size", type=int, default=None)
    pv.add_argument("--yolo-checkpoint")
    pv.add_argument("--sam2-checkpoint")
    pv.add_argument("--force-sam2", action="store_true")

    pp = sub.add_parser("serve-batch", parents=[device],
                        help="production serving: micro-batching HTTP endpoint "
                        "(groups concurrent requests into device batches)")
    pp.add_argument("--port", type=int, default=8600, help="0: an ephemeral port (printed)")
    pp.add_argument("--batch-size", type=int, default=None)
    pp.add_argument("--max-wait-ms", type=float, default=25.0,
                    help="flush a non-full batch once its oldest request has waited this long")
    pp.add_argument("--final", action="store_true",
                    help="run the batched VLM value pass per served batch")
    pp.add_argument("--scale", default=None, choices=list("nsmlx"))
    pp.add_argument("--det-size", type=int, default=None)
    pp.add_argument("--yolo-checkpoint")
    pp.add_argument("--sam2-checkpoint")
    pp.add_argument("--force-sam2", action="store_true")
    return parser


def main(argv=None) -> int:
    from .io.image_io import ImageFormatError

    args = _parser().parse_args(argv)
    commands = {"analyze": _cmd_analyze, "analyze-batch": _cmd_analyze_batch,
                "simulate": _cmd_simulate, "serve": _cmd_serve,
                "serve-batch": _cmd_serve_batch}
    try:
        return commands[args.cmd](args)
    except ImageFormatError as exc:
        # an image kind the reader refuses (Queue A 19)
        print(f"{args.cmd}: {exc}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
