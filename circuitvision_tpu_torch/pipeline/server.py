"""Micro-batching inference server: concurrent requests → device batches.

Counterpart of the JAX package's `pipeline/server.py`. The reference
serves one request at a time from a single Streamlit session
(`app.py:327-438`); this layer groups concurrent requests into the
micro-batches of `BatchedPipeline`, whose SAM2 forward takes a chunk's
crops in one batch:

- :class:`BatchingExecutor` — requests queue up and group into
  micro-batches of up to ``pipeline.batch_size``. A batch is flushed when
  full or when its first request has waited ``max_wait_ms``; the deadline
  bounds only the wait for requests that have not arrived yet, so a
  backlog still fills batches. The queue is bounded (``submit`` blocks
  when it is full: backpressure). A batch that fails fails only its own
  requests, and the executor keeps serving.
- :func:`make_server` / :func:`serve` — a stdlib HTTP front end:
  ``POST /analyze`` (PNG or JPEG bytes → netlist JSON), ``GET /healthz``,
  ``GET /stats``, ``GET /metrics`` (Prometheus text).

Design on the card, and why it differs from the JAX executor. The JAX
executor runs three stage threads (detect+crop, segment, host topology).
On the card, three threads sharing one interpreter ran 25–40 % slower
than the same stages in order on one thread, all of them waiting on
YOLO's host dispatch (pipeline/batch.py). So one worker thread runs
`BatchedPipeline`'s own phases on one CUDA stream — the stream that was
current when the executor was made, which is the one `analyze_many`
would use there — pipelined as `analyze_many` is: batch N's device work
(`_detect_crop_phase`, `_segment_phase`) is queued before batch N−1's
host stages (`_host_stages`) run, so they overlap. While batch N−1 is
pending, the worker does not wait for more requests: it takes only what
is already queued, and with nothing queued it runs N−1's host stages at
once, so a lone request never waits for a second one. Every kernel
launch, launch counter and kernel workspace is touched by that one
thread; the HTTP threads only decode and enqueue.

Device faults. A kernel fault or a CUDA, cuDNN or cuBLAS error
(`ops.cuda.build.is_device_fault`) fails its batch (and the pending one,
whose results share the faulted context) and breaks the executor: every
queued and later request fails with that fault, and ``/healthz`` answers
503. A CUDA context that has faulted cannot serve correct results; no
ladder of the port hides a device fault.
"""
from __future__ import annotations

import contextlib
import json
import logging
import queue
import socket
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Sequence

import numpy as np
import torch

from ..core.types import AnalysisResult
from ..io.image_io import decode_image
from ..ops.cuda.build import is_device_fault
from .batch import BatchedPipeline

logger = logging.getLogger(__name__)


@dataclass
class _Request:
    image: np.ndarray
    future: Future
    t_submit: float


@dataclass
class _Stats:
    """Lock-protected serving counters."""

    lock: threading.Lock = field(default_factory=threading.Lock)
    requests: int = 0
    completed: int = 0
    failed: int = 0
    batches: int = 0
    batch_size_sum: int = 0
    # rolling latency window (seconds, last 512 completions)
    latencies: list = field(default_factory=list)

    def record_batch(self, n: int) -> None:
        with self.lock:
            self.batches += 1
            self.batch_size_sum += n

    def record_done(self, t_submit: float, ok: bool) -> None:
        with self.lock:
            if ok:
                self.completed += 1
            else:
                self.failed += 1
            self.latencies.append(time.perf_counter() - t_submit)
            if len(self.latencies) > 512:
                del self.latencies[: len(self.latencies) - 512]

    def snapshot(self, queue_depth: int) -> dict:
        with self.lock:
            lat = sorted(self.latencies)
            n = len(lat)

            def pct(p: float) -> Optional[float]:
                return lat[min(n - 1, int(p * n))] if n else None

            return {
                "requests": self.requests,
                "completed": self.completed,
                "failed": self.failed,
                "batches": self.batches,
                "mean_batch_size": (
                    self.batch_size_sum / self.batches if self.batches else None
                ),
                "queue_depth": queue_depth,
                "latency_s": {"p50": pct(0.50), "p90": pct(0.90), "p99": pct(0.99)},
            }


class BatchingExecutor:
    """Groups concurrent analyze() requests into device micro-batches.

    Parameters
    ----------
    pipeline:
        The :class:`BatchedPipeline` to execute on. Its ``batch_size``
        is the micro-batch ceiling (requests beyond it wait for the
        next batch).
    max_wait_ms:
        Flush deadline: a non-full batch launches once its first
        request has waited this long. 0 disables *waiting* for requests
        that have not arrived yet (latency-optimal under light load);
        already-queued requests still join the batch at zero latency
        cost, so a backlog never collapses to size-1 batches.
    queue_depth:
        Backpressure bound on queued requests; ``submit`` blocks when
        full (callers see it as latency, never unbounded memory).
    final:
        Run the value pass (``analyzer.finalize_netlists``) on each
        served batch, as ``analyze_many(finalize=True)`` does per chunk.
    """

    def __init__(
        self,
        pipeline: BatchedPipeline,
        max_wait_ms: float = 25.0,
        queue_depth: int = 256,
        final: bool = False,
    ):
        self.pipeline = pipeline
        self.max_wait_ms = float(max_wait_ms)
        self.final = bool(final)
        self._requests: "queue.Queue" = queue.Queue(maxsize=queue_depth)
        self._stats = _Stats()
        self._closed = False
        #: the device fault that broke the executor, once one has
        self._fault: Optional[BaseException] = None
        # Serializes the closed-check+enqueue in submit() against close()'s
        # closed-set+sentinel: without it a request could land BEHIND the
        # shutdown sentinel and its Future would never resolve.
        self._submit_lock = threading.Lock()
        device = pipeline.device
        self._stream = torch.cuda.current_stream(device) if device.type == "cuda" else None
        self._thread = threading.Thread(target=self._run, daemon=True, name="cv-serve")
        self._thread.start()

    # -- public API -------------------------------------------------------
    def submit(self, image: np.ndarray) -> "Future[AnalysisResult]":
        """Enqueue one image; returns a Future resolving to its
        AnalysisResult (full ``analyze()`` semantics). On a broken
        executor the Future holds the device fault."""
        with self._submit_lock:
            if self._closed:
                raise RuntimeError("executor is closed")
            fut: Future = Future()
            with self._stats.lock:
                self._stats.requests += 1
            if self._fault is not None:
                fut.set_exception(self._fault)
                self._stats.record_done(time.perf_counter(), ok=False)
                return fut
            self._requests.put(_Request(image, fut, time.perf_counter()))
        return fut

    def map(self, images: Sequence[np.ndarray]) -> list[AnalysisResult]:
        """Submit many images and wait for all results (in order)."""
        futs = [self.submit(img) for img in images]
        return [f.result() for f in futs]

    def stats(self) -> dict:
        return self._stats.snapshot(self._requests.qsize())

    @property
    def fault(self) -> Optional[BaseException]:
        """The device fault that broke the executor, or None."""
        return self._fault

    def close(self) -> None:
        """Drain in-flight work and stop the worker."""
        with self._submit_lock:
            if self._closed:
                return
            self._closed = True
            self._requests.put(None)
        self._thread.join(timeout=60)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- worker -----------------------------------------------------------
    def _next_batch(self, wait: bool = True) -> Optional[list[_Request]]:
        """With `wait`, block for the first request, then coalesce until
        the batch is full or max_wait_ms has elapsed since that first
        request. Without it, take only requests already queued ([] when
        there are none). None: shutdown, nothing taken."""
        try:
            first = self._requests.get() if wait else self._requests.get_nowait()
        except queue.Empty:
            return []
        if first is None:
            return None
        batch = [first]
        deadline = first.t_submit + self.max_wait_ms / 1e3
        while len(batch) < self.pipeline.batch_size:
            remaining = deadline - time.perf_counter() if wait else 0.0
            try:
                # The deadline only bounds waiting for requests that have
                # NOT arrived yet: once it passes (e.g. the first request
                # aged in a backlog), already-queued requests still join
                # at zero latency cost — without this, any backlog would
                # collapse every batch to size 1 exactly when batching
                # matters most.
                item = (
                    self._requests.get_nowait()
                    if remaining <= 0
                    else self._requests.get(timeout=remaining)
                )
            except queue.Empty:
                break
            if item is None:
                # propagate shutdown after this batch completes
                self._requests.put(None)
                break
            batch.append(item)
        return batch

    def _fail(self, batch: list[_Request], exc: BaseException) -> None:
        if self._fault is None:
            logger.error("serving batch of %d failed", len(batch), exc_info=exc)
        for r in batch:
            if not r.future.done():
                r.future.set_exception(exc)
                self._stats.record_done(r.t_submit, ok=False)

    def _broken(self, exc: BaseException, *batches) -> None:
        """Fail `batches` with the device fault `exc` and break the
        executor."""
        logger.error("device fault; the executor fails every request from now on",
                     exc_info=exc)
        self._fault = exc
        for batch in batches:
            self._fail(batch, exc)

    def _finish(self, pending) -> None:
        """Host stages of a batch whose device work is queued; its futures
        get their results."""
        batch, staged, fetch = pending
        try:
            results = self.pipeline._host_stages(staged, fetch, self.final)
        except Exception as exc:
            if is_device_fault(exc):
                return self._broken(exc, batch)
            return self._fail(batch, exc)
        for req, res in zip(batch, results):
            req.future.set_result(res)
            self._stats.record_done(req.t_submit, ok=True)

    def _run(self) -> None:
        stream = torch.cuda.stream(self._stream) if self._stream is not None \
            else contextlib.nullcontext()
        with stream:
            self._serve()

    def _serve(self) -> None:
        pending = None  # (batch, staged, fetch) whose host stages have not run
        while True:
            batch = self._next_batch(wait=pending is None)
            if batch is None:
                break
            if self._fault is not None:
                self._fail(batch, self._fault)
                continue
            queued = None
            if batch:
                self._stats.record_batch(len(batch))
                try:
                    queued = (batch, *self.pipeline._segment_phase(
                        self.pipeline._detect_crop_phase([r.image for r in batch])))
                except Exception as exc:
                    if is_device_fault(exc):
                        self._broken(exc, batch, *([pending[0]] if pending else []))
                        pending = None
                        continue
                    self._fail(batch, exc)
            if pending is not None:
                self._finish(pending)
            if queued is not None and self._fault is not None:  # pending's host stages faulted
                self._fail(queued[0], self._fault)
                queued = None
            pending = queued
        if pending is not None:
            self._finish(pending)


# -- HTTP front end --------------------------------------------------------

def _prometheus_text(stats: dict) -> str:
    """The /stats snapshot in Prometheus text exposition format
    (counters + gauges + latency-quantile gauges), so the serving layer
    plugs into standard scrape-based monitoring without an adapter."""
    lines = []

    def metric(name, kind, value, help_text, labels=""):
        if value is None:
            return
        lines.append(f"# HELP {name} {help_text}")
        lines.append(f"# TYPE {name} {kind}")
        lines.append(f"{name}{labels} {value}")

    metric("circuitvision_requests_total", "counter", stats["requests"],
           "Analyze requests received")
    metric("circuitvision_completed_total", "counter", stats["completed"],
           "Requests completed successfully")
    metric("circuitvision_failed_total", "counter", stats["failed"],
           "Requests failed")
    metric("circuitvision_batches_total", "counter", stats["batches"],
           "Device micro-batches executed")
    metric("circuitvision_mean_batch_size", "gauge",
           stats["mean_batch_size"], "Mean micro-batch occupancy")
    metric("circuitvision_queue_depth", "gauge", stats["queue_depth"],
           "Requests waiting for a batch slot")
    lat = {
        k: v for k, v in (stats.get("latency_s") or {}).items() if v is not None
    }
    if lat:
        lines.append(
            "# HELP circuitvision_request_latency_seconds "
            "End-to-end request latency (rolling window)"
        )
        lines.append("# TYPE circuitvision_request_latency_seconds summary")
        for q, v in lat.items():
            # p50/p90/p99 → the conventional quantile label 0.5/0.9/0.99
            frac = int(q[1:]) / 100.0
            lines.append(
                "circuitvision_request_latency_seconds"
                f'{{quantile="{frac:g}"}} {v}'
            )
    return "\n".join(lines) + "\n"


def _result_json(result: AnalysisResult) -> dict:
    """Serving response: the structural outputs, no debug rasters."""
    return {
        "netlist_text": result.netlist_text or "",
        "netlist_no_dir": result.valueless_netlist_text_no_vlm_dir,
        "bboxes": [b.to_dict() for b in result.bboxes_orig_nms],
        "nodes": len(result.nodes),
        "timings": result.timings.timings if result.timings else {},
    }


class _HTTPServer(ThreadingHTTPServer):
    #: listen backlog. socketserver's default of 5 overflows when more
    #: clients than that connect at once while the accept loop waits for
    #: the interpreter lock, and each connection dropped there gets in
    #: only after a TCP retransmission, a second later.
    request_queue_size = socket.SOMAXCONN


def make_server(
    executor: BatchingExecutor,
    port: int = 8600,
    request_timeout_s: float = 120.0,
) -> ThreadingHTTPServer:
    """Build (but do not start) the batching HTTP server; port 0 binds an
    ephemeral port (`server.server_address[1]`).

    ThreadingHTTPServer gives one thread per in-flight request; they all
    funnel into the executor's queue, which is where batching happens.
    ``POST /analyze`` takes PNG, JPEG, BMP or WebP bytes
    (io/image_io.decode_image); any failure, a body of another kind
    included, answers 500 with the error.
    """

    class Handler(BaseHTTPRequestHandler):
        def _json(self, obj, code=200):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                fault = executor.fault
                if fault is None:
                    self._json({"ok": True})
                else:
                    self._json({"ok": False, "error": f"device fault: {fault}"}, 503)
            elif self.path == "/stats":
                self._json(executor.stats())
            elif self.path == "/metrics":
                body = _prometheus_text(executor.stats()).encode()
                self.send_response(200)
                self.send_header(
                    "Content-Type", "text/plain; version=0.0.4"
                )
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self.send_error(404)

        def do_POST(self):
            if self.path != "/analyze":
                return self.send_error(404)
            try:
                n = int(self.headers.get("Content-Length", 0))
                image = decode_image(self.rfile.read(n))
                result = executor.submit(image).result(timeout=request_timeout_s)
                self._json(_result_json(result))
            except Exception as e:
                self._json({"ok": False, "error": str(e)}, 500)

        def log_message(self, *args):
            logger.debug("http: %s", args)

    return _HTTPServer(("0.0.0.0", port), Handler)


def _sigterm_to_exit(signum, frame):
    """SIGTERM → SystemExit so serve()'s finally/with blocks run.

    Production stops (docker stop, kubelet, systemd) send SIGTERM;
    Python's default action kills the process mid-flight — in-flight
    futures never resolve and the process dies inside a device call.
    Raising SystemExit instead unwinds through serve(): the HTTP loop
    stops, then the executor's __exit__ drains in-flight batches before
    the process exits."""
    raise SystemExit(0)


def serve(
    analyzer,
    port: int = 8600,
    batch_size: Optional[int] = None,
    max_wait_ms: float = 25.0,
    final: bool = False,
) -> None:
    """Start the micro-batching server (blocks); prints the address it
    listens on (port 0: an ephemeral one). SIGINT and SIGTERM both shut
    down gracefully: stop accepting, drain in-flight work, then return."""
    import signal

    pipeline = BatchedPipeline(analyzer, batch_size=batch_size)
    with BatchingExecutor(pipeline, max_wait_ms=max_wait_ms, final=final) as ex:
        server = make_server(ex, port=port)
        print(f"serving on port {server.server_address[1]} (batch={pipeline.batch_size}, "
              f"max_wait={max_wait_ms:g} ms, device={pipeline.device})", flush=True)
        old_term = signal.signal(signal.SIGTERM, _sigterm_to_exit)
        try:
            server.serve_forever()
        except (KeyboardInterrupt, SystemExit):
            logger.info("shutdown signal; draining in-flight batches")
        finally:
            signal.signal(signal.SIGTERM, old_term)
            server.shutdown()
            server.server_close()
