"""HTTP serving for the OCR pipeline, stdlib only (counterpart of
``manuscript_tpu/serve.py``).

* **Micro-batching**: concurrent requests coalesce into batches of up to
  ``Pipeline.batch_pages`` pages, one chunk of the pipeline's device passes.
* **Pipelined batches**: with a pipeline that has ``start_batch`` and
  ``finish_batch`` (the port's ``Pipeline`` has), a batcher thread assembles
  and starts batches (host prep and phase A's launch) while a finisher
  thread completes the one before (crops, phase B, pages); other pipelines
  are run one batch at a time through ``predict``/``process_batch``.
* **Back-pressure**: a bounded admission queue (429 when full, abandoned
  jobs purged first), a per-request timeout (504, and a job whose caller
  left is skipped before it reaches the device).
* **Endpoints**: ``POST /ocr`` (an image body: ``.npy`` uint8 H×W[×3|4], or
  any format PIL reads → JSON page and text), ``GET /healthz`` (liveness,
  torch device and its name), ``GET /metrics`` (Prometheus-style counters).

Usage::

    python -m manuscript_tpu_torch serve --port 8000
    OCRServer(pipeline, port=8000).serve_forever()

The handler is pipeline-agnostic: anything with ``predict``,
``process_batch`` and ``get_text`` serves.
"""

from __future__ import annotations

import io
import json
import queue
import threading
import time
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Optional

import numpy as np
import torch


@dataclass
class _Job:
    image: np.ndarray
    done: threading.Event = field(default_factory=threading.Event)
    result: Any = None
    error: Optional[str] = None
    # set by the HTTP thread when its request timed out: the batcher drops
    # the job instead of spending device time on it
    abandoned: bool = False


class _Metrics:
    def __init__(self):
        self.lock = threading.Lock()
        self.requests_total = 0
        self.pages_total = 0
        self.errors_total = 0
        self.rejected_total = 0
        self.timeouts_total = 0
        self.batch_count = 0
        self.busy_seconds = 0.0
        self.started = time.time()

    def render(self) -> str:
        with self.lock:
            fill = self.pages_total / self.batch_count if self.batch_count else 0.0
            values = [
                ("ocr_requests_total", "counter", self.requests_total),
                ("ocr_pages_total", "counter", self.pages_total),
                ("ocr_errors_total", "counter", self.errors_total),
                ("ocr_rejected_total", "counter", self.rejected_total),
                ("ocr_timeouts_total", "counter", self.timeouts_total),
                ("ocr_batches_total", "counter", self.batch_count),
                ("ocr_device_busy_seconds", "counter", f"{self.busy_seconds:.3f}"),
                ("ocr_mean_batch_fill", "gauge", f"{fill:.3f}"),
                ("ocr_uptime_seconds", "gauge", f"{time.time() - self.started:.1f}"),
            ]
        return "".join(f"# TYPE {name} {kind}\n{name} {value}\n" for name, kind, value in values)


class OCRServer:
    """HTTP front end with micro-batching over a Pipeline-contract object.

    ``batch_wait_ms`` bounds the extra latency a lone request waits for
    batch-mates; a full batch goes at once. ``max_queue`` bounds the
    admission queue (429 with Retry-After beyond it); ``request_timeout_s``
    bounds a request end to end (504, and the job is abandoned)."""

    def __init__(
        self,
        pipeline,
        host: str = "0.0.0.0",
        port: int = 8000,
        batch_pages: Optional[int] = None,
        batch_wait_ms: float = 25.0,
        max_body_bytes: int = 64 * 1024 * 1024,
        max_queue: int = 64,
        request_timeout_s: float = 120.0,
    ):
        self.pipeline = pipeline
        self.batch_pages = int(
            batch_pages if batch_pages is not None else getattr(pipeline, "batch_pages", None) or 4
        )
        self.batch_wait_s = batch_wait_ms / 1e3
        self.max_body_bytes = max_body_bytes
        self.request_timeout_s = request_timeout_s
        self.metrics = _Metrics()
        self._queue: "queue.Queue[_Job]" = queue.Queue(maxsize=max_queue)
        self._submit_lock = threading.Lock()
        self._stop = threading.Event()
        self._worker = threading.Thread(target=self._drain_loop, name="ocr-batcher", daemon=True)
        # one started batch waits while one finishes: a bounded device queue
        self._pipelined = hasattr(pipeline, "start_batch") and hasattr(pipeline, "finish_batch")
        self._inflight: "queue.Queue[tuple]" = queue.Queue(maxsize=1)
        self._finisher = threading.Thread(target=self._finish_loop, name="ocr-finisher", daemon=True)
        self._httpd = ThreadingHTTPServer((host, port), self._handler())
        self.port = self._httpd.server_address[1]

    def _handler(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # noqa: D102 (metrics carry the counts)
                pass

            def _send(self, code: int, body: bytes, ctype: str, headers=None):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def _send_json(self, code: int, obj, headers=None) -> None:
                self._send(code, json.dumps(obj).encode("utf-8"), "application/json", headers)

            def do_GET(self):  # noqa: N802
                if self.path.startswith("/healthz"):
                    self._send_json(200, server.health())
                elif self.path.startswith("/metrics"):
                    self._send(200, server.metrics.render().encode("utf-8"),
                               "text/plain; version=0.0.4")
                else:
                    self._send_json(404, {"error": "not found"})

            def do_POST(self):  # noqa: N802
                if not self.path.startswith("/ocr"):
                    self._send_json(404, {"error": "not found"})
                    return
                length = int(self.headers.get("Content-Length") or 0)
                if length <= 0:
                    self._send_json(400, {"error": "empty body"})
                    return
                if length > server.max_body_bytes:
                    self._send_json(413, {"error": "body too large"})
                    return
                body = self.rfile.read(length)
                try:
                    img = server.decode_image(body)
                except Exception as exc:  # any undecodable body is the client's fault
                    server._count_error()
                    self._send_json(400, {"error": f"bad image: {exc}"})
                    return
                t0 = time.time()
                try:
                    job = server.submit(img)
                except queue.Full:
                    with server.metrics.lock:
                        server.metrics.rejected_total += 1
                    self._send_json(429, {"error": "queue full, retry later"},
                                    headers={"Retry-After": "1"})
                    return
                if not job.done.wait(server.request_timeout_s):
                    job.abandoned = True
                    with server.metrics.lock:
                        server.metrics.timeouts_total += 1
                    self._send_json(504, {"error": "request timed out in queue/inference"})
                    return
                if job.error is not None:
                    server._count_error()
                    self._send_json(500, {"error": job.error})
                    return
                page = job.result
                self._send_json(200, {
                    "seconds": round(time.time() - t0, 4),
                    "text": server.pipeline.get_text(page),
                    "page": page.model_dump(),
                })

        return Handler

    # ------------------------------------------------------------------

    @staticmethod
    def decode_image(body: bytes) -> np.ndarray:
        """A request body → RGB uint8 array. A raw ``.npy`` array (uint8,
        H×W, H×W×3 or H×W×4) costs the host nothing to decode; any other
        body is opened with PIL, imported here and only here."""
        if body[:6] == b"\x93NUMPY":
            arr = np.load(io.BytesIO(body), allow_pickle=False)
            if arr.dtype != np.uint8 or arr.ndim not in (2, 3):
                raise ValueError(f"npy body must be uint8 HxW[x3], got {arr.dtype} ndim={arr.ndim}")
            if arr.ndim == 2:
                arr = np.repeat(arr[:, :, None], 3, axis=2)
            elif arr.shape[2] == 4:
                arr = arr[:, :, :3]
            elif arr.shape[2] != 3:
                raise ValueError(f"npy body has {arr.shape[2]} channels")
            return np.ascontiguousarray(arr)
        from PIL import Image

        return np.asarray(Image.open(io.BytesIO(body)).convert("RGB"))

    def health(self) -> dict:
        """Liveness, and the torch device the pipeline runs on with its name
        ("unknown" for a pipeline that names none)."""
        dev = getattr(self.pipeline, "device", None)
        backend, name = "unknown", "unknown"
        if isinstance(dev, torch.device):
            backend = dev.type
            name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type
        return {
            "status": "ok",
            "backend": backend,
            "device": name,
            "batch_pages": self.batch_pages,
            "queue_depth": self._queue.qsize(),
        }

    def submit(self, image: np.ndarray) -> _Job:
        """Enqueue one page; ``queue.Full`` when the bounded admission queue
        is at capacity (the HTTP layer answers 429)."""
        job = _Job(image=image)
        with self._submit_lock:
            try:
                self._queue.put_nowait(job)
            except queue.Full:
                # the backlog may be all abandoned jobs (a timeout burst during
                # a long batch): purge them before refusing with a spurious
                # 429. The lock serialises submitters, so the retry cannot
                # race another admission.
                self._purge_abandoned()
                self._queue.put_nowait(job)  # queue.Full propagates if real
        with self.metrics.lock:
            self.metrics.requests_total += 1
        return job

    def _purge_abandoned(self):
        """Drop abandoned jobs from the admission queue, keeping FIFO order
        (callers hold ``_submit_lock``)."""
        live = []
        while True:
            try:
                job = self._queue.get_nowait()
            except queue.Empty:
                break
            if not job.abandoned:
                live.append(job)
        for job in live:
            self._queue.put_nowait(job)

    def _count_error(self):
        with self.metrics.lock:
            self.metrics.errors_total += 1

    # ------------------------------------------------------------------

    def _complete(self, batch, pages=None, exc=None, seconds: float = 0.0) -> None:
        """Hand each job its page or the batch's error; count the batch."""
        for i, job in enumerate(batch):
            if exc is not None:
                job.error = f"{type(exc).__name__}: {exc}"
            else:
                job.result = pages[i]
        with self.metrics.lock:
            self.metrics.pages_total += len(batch)
            self.metrics.batch_count += 1
            self.metrics.busy_seconds += seconds
        for job in batch:
            job.done.set()

    def _drain_loop(self):
        """Batcher thread: block for one job, then wait up to
        ``batch_wait_s`` for batch-mates (a full batch goes at once)."""
        while not self._stop.is_set():
            try:
                first = self._queue.get(timeout=0.2)
            except queue.Empty:
                continue
            batch = [first]
            deadline = time.time() + self.batch_wait_s
            while len(batch) < self.batch_pages:
                remaining = deadline - time.time()
                if remaining <= 0:
                    break
                try:
                    batch.append(self._queue.get(timeout=remaining))
                except queue.Empty:
                    break
            batch = [j for j in batch if not j.abandoned]  # callers that left get no device time
            if not batch:
                continue
            if not self._pipelined:
                self._run_batch(batch)
                continue
            t0, started = time.time(), False
            try:
                handle = self.pipeline.start_batch([j.image for j in batch])
                started = True
            except Exception as exc:  # surfaced per job; the batcher keeps running
                for job in batch:
                    job.error = f"{type(exc).__name__}: {exc}"
            with self.metrics.lock:
                self.metrics.busy_seconds += time.time() - t0
            if not started:  # a batch that never started is not counted
                for job in batch:
                    job.done.set()
                continue
            while not self._stop.is_set():
                try:
                    self._inflight.put((batch, handle), timeout=0.2)
                    break
                except queue.Full:
                    continue
            else:
                # shutdown raced a started batch: finish it here so that its
                # clients get their pages rather than a timeout
                self._finish(batch, handle)

    def _finish(self, batch, handle) -> None:
        t0 = time.time()
        try:
            pages = self.pipeline.finish_batch(handle)
        except Exception as exc:  # surfaced per job; the finisher keeps running
            self._complete(batch, exc=exc, seconds=time.time() - t0)
        else:
            self._complete(batch, pages, seconds=time.time() - t0)

    def _finish_loop(self):
        """Finisher thread: complete each started batch while the batcher
        assembles and starts the next."""
        while not (self._stop.is_set() and self._inflight.empty()):
            try:
                batch, handle = self._inflight.get(timeout=0.2)
            except queue.Empty:
                continue
            self._finish(batch, handle)
            self._warm_capacity()

    def _warm_capacity(self):
        """Between batches, let the fused engine run phase B at its next
        capacity bucket (``FusedOCR.warm_next_bucket``), so that a denser
        page later does not pay the first pass at a new shape."""
        fused = getattr(self.pipeline, "_fused", None)
        if fused is not None and hasattr(fused, "warm_next_bucket"):
            try:
                fused.warm_next_bucket()
            except Exception as exc:  # a failed warm must not stop serving
                print(f"[OCRServer] bucket warm failed: {exc!r}")

    def _run_batch(self, batch):
        t0 = time.time()
        try:
            if len(batch) == 1:
                pages = [self.pipeline.predict(batch[0].image)]
            else:
                pages = self.pipeline.process_batch([j.image for j in batch])
        except Exception as exc:  # surfaced per job; the batcher keeps running
            self._complete(batch, exc=exc, seconds=time.time() - t0)
        else:
            self._complete(batch, pages, seconds=time.time() - t0)
        self._warm_capacity()

    # ------------------------------------------------------------------

    def _start_workers(self):
        self._worker.start()
        if self._pipelined:
            self._finisher.start()

    def serve_forever(self):
        self._start_workers()
        try:
            self._httpd.serve_forever()
        finally:
            self.shutdown()

    def start_background(self):
        """Start the worker and HTTP threads and return (tests, embedding)."""
        self._start_workers()
        self._http_thread = threading.Thread(
            target=self._httpd.serve_forever, name="ocr-http", daemon=True
        )
        self._http_thread.start()

    def shutdown(self):
        self._stop.set()
        self._httpd.shutdown()
        self._httpd.server_close()
