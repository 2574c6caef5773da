"""The port's OCRServer: the cases of ``tests/test_serve.py`` (micro-batching,
back-pressure, timeouts, errors, endpoints, ``.npy`` and PNG bodies, the
pipelined start/finish worker) against the port's server over stub
pipelines, and the port's real micro pipeline on the CPU served over HTTP:
each served text equals ``Pipeline.predict``'s for the same page."""

import io
import json
import queue
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from manuscript_tpu_torch.serve import OCRServer
from manuscript_tpu_torch.types import Block, Page, Word


class StubPipeline:
    """Duck-typed Pipeline contract: predict/process_batch/get_text."""

    batch_pages = 4

    def __init__(self, delay_s: float = 0.0, fail_on: str | None = None):
        self.delay_s = delay_s
        self.fail_on = fail_on
        self.calls = []  # list of batch sizes, in dispatch order
        self.lock = threading.Lock()

    def _page(self, image) -> Page:
        h, w = image.shape[:2]
        word = Word(
            polygon=[(0.0, 0.0), (w, 0.0), (w, h), (0.0, h)],
            detection_confidence=1.0,
            text=f"{w}x{h}",
        )
        return Page(blocks=[Block(words=[word])])

    def predict(self, image):
        with self.lock:
            self.calls.append(1)
        if self.delay_s:
            time.sleep(self.delay_s)
        if self.fail_on == "predict":
            raise ValueError("boom")
        return self._page(image)

    def process_batch(self, images):
        with self.lock:
            self.calls.append(len(images))
        if self.delay_s:
            time.sleep(self.delay_s)
        if self.fail_on == "batch":
            raise ValueError("boom")
        return [self._page(im) for im in images]

    def get_text(self, page) -> str:
        return " ".join(
            w.text for b in page.blocks for w in b.words if w.text
        )


def make_png(w=32, h=24) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(
        np.zeros((h, w, 3), np.uint8)
    ).save(buf, format="PNG")
    return buf.getvalue()


@pytest.fixture()
def server():
    pipe = StubPipeline()
    srv = OCRServer(pipe, host="127.0.0.1", port=0, batch_wait_ms=40.0)
    srv.start_background()
    yield srv, pipe
    srv.shutdown()


def _post(port: int, body: bytes, path="/ocr"):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=body, method="POST"
    )
    try:
        with urllib.request.urlopen(req, timeout=10) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(port: int, path: str):
    with urllib.request.urlopen(
        f"http://127.0.0.1:{port}{path}", timeout=10
    ) as resp:
        return resp.status, resp.read().decode()


def test_single_request_roundtrip(server):
    srv, pipe = server
    status, body = _post(srv.port, make_png(40, 30))
    assert status == 200
    assert body["text"] == "40x30"
    assert body["page"]["blocks"][0]["words"][0]["text"] == "40x30"
    assert pipe.calls == [1]  # lone request rides predict()


def test_concurrent_requests_coalesce(server):
    srv, pipe = server
    pipe.delay_s = 0.05
    png = make_png()
    results = []

    def hit():
        results.append(_post(srv.port, png))

    threads = [threading.Thread(target=hit) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert all(s == 200 for s, _ in results)
    # 4 requests inside the 40 ms window -> fewer dispatches than requests
    assert sum(pipe.calls) == 4
    assert len(pipe.calls) < 4
    assert max(pipe.calls) > 1  # at least one true batch via process_batch


def test_eight_concurrent_requests_coalesce_into_batches(server):
    """≥8 concurrent requests must ride the batched program (micro-batch
    coalescing), not 8 single-page dispatches (VERDICT r3 task 8)."""
    srv, pipe = server
    pipe.delay_s = 0.06
    png = make_png()
    results = []
    lock = threading.Lock()

    def hit():
        r = _post(srv.port, png)
        with lock:
            results.append(r)

    threads = [threading.Thread(target=hit) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert all(s == 200 for s, _ in results)
    assert sum(pipe.calls) == 8  # every page served exactly once
    # batched dispatches, not 8 singles: strictly fewer calls than requests
    # and at least one call that was a true process_batch batch
    assert len(pipe.calls) <= 5, pipe.calls
    assert max(pipe.calls) > 1, pipe.calls


def test_bounded_queue_backpressure_429():
    """When the admission queue is full, new requests get 429 with
    Retry-After instead of an unbounded backlog."""
    pipe = StubPipeline(delay_s=0.5)
    srv = OCRServer(
        pipe, host="127.0.0.1", port=0, batch_wait_ms=1.0,
        batch_pages=1, max_queue=1,
    )
    srv.start_background()
    try:
        png = make_png()
        results = []
        lock = threading.Lock()

        def hit():
            r = _post(srv.port, png)
            with lock:
                results.append(r)

        threads = [threading.Thread(target=hit) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        codes = sorted(s for s, _ in results)
        assert 429 in codes, codes  # backpressure engaged
        assert 200 in codes, codes  # and the served path still works
        _, metrics = _get(srv.port, "/metrics")
        line = next(
            ln for ln in metrics.splitlines()
            if ln.startswith("ocr_rejected_total")
        )
        assert int(line.split()[1]) == codes.count(429)
    finally:
        srv.shutdown()


def test_request_timeout_504_and_abandoned_job_skipped():
    """A request that outlives request_timeout_s gets 504; its queued job
    is dropped by the batcher (no device time for a caller that left)."""
    pipe = StubPipeline(delay_s=0.5)
    srv = OCRServer(
        pipe, host="127.0.0.1", port=0, batch_wait_ms=1.0,
        batch_pages=1, request_timeout_s=0.2,
    )
    srv.start_background()
    try:
        png = make_png()
        results = []
        lock = threading.Lock()

        def hit():
            r = _post(srv.port, png)
            with lock:
                results.append(r)

        # request 1 occupies the worker for 0.5s and its caller gives up at
        # 0.2s (504, but the inference was already running); request 2 times
        # out while still QUEUED and must never reach the pipeline
        threads = [threading.Thread(target=hit) for _ in range(2)]
        threads[0].start()
        time.sleep(0.05)
        threads[1].start()
        for t in threads:
            t.join()
        codes = sorted(s for s, _ in results)
        assert codes == [504, 504], codes
        time.sleep(0.6)  # batcher drains; abandoned queued job is skipped
        assert sum(pipe.calls) == 1, pipe.calls
        _, metrics = _get(srv.port, "/metrics")
        assert "ocr_timeouts_total 2" in metrics
        # worker is alive and fast requests succeed after the timeouts
        pipe.delay_s = 0.0
        status, _ = _post(srv.port, png)
        assert status == 200
    finally:
        srv.shutdown()


def test_bad_image_is_400_and_counted(server):
    srv, _ = server
    status, body = _post(srv.port, b"not an image")
    assert status == 400
    assert "bad image" in body["error"]
    _, metrics = _get(srv.port, "/metrics")
    assert "ocr_errors_total 1" in metrics


def test_pipeline_error_is_500_worker_survives(server):
    srv, pipe = server
    pipe.fail_on = "predict"
    status, body = _post(srv.port, make_png())
    assert status == 500
    assert "boom" in body["error"]
    pipe.fail_on = None  # worker must still be alive
    status, _ = _post(srv.port, make_png())
    assert status == 200


def test_healthz_and_metrics(server):
    srv, _ = server
    status, body = _get(srv.port, "/healthz")
    assert status == 200
    health = json.loads(body)
    assert health["status"] == "ok"
    assert health["batch_pages"] == 4
    _post(srv.port, make_png())
    status, metrics = _get(srv.port, "/metrics")
    assert status == 200
    assert "ocr_requests_total 1" in metrics
    assert "ocr_pages_total 1" in metrics


def test_oversized_body_rejected():
    pipe = StubPipeline()
    srv = OCRServer(
        pipe, host="127.0.0.1", port=0, max_body_bytes=100
    )
    srv.start_background()
    try:
        status, body = _post(srv.port, b"x" * 200)
        assert status == 413
    finally:
        srv.shutdown()


def test_cli_serve_parser_wires_defaults(monkeypatch):
    """`serve` subcommand parses and constructs the server (no real models)."""
    import manuscript_tpu_torch.__main__ as cli

    captured = {}

    class FakeServer:
        def __init__(
            self, pipe, host, port, batch_wait_ms,
            max_queue=64, request_timeout_s=120.0,
        ):
            captured.update(
                pipe=pipe, host=host, port=port, wait=batch_wait_ms,
                max_queue=max_queue, request_timeout_s=request_timeout_s,
            )
            self.port = port
            self.batch_pages = getattr(pipe, "batch_pages", 4)

        def serve_forever(self):
            captured["served"] = True

    monkeypatch.setattr(
        "manuscript_tpu_torch.serve.OCRServer", FakeServer
    )
    monkeypatch.setattr(
        "manuscript_tpu_torch.Pipeline", lambda **kw: StubPipeline()
    )
    cli.main(
        ["serve", "--host", "127.0.0.1", "--port", "8123",
         "--mode", "greedy", "--batch-wait-ms", "10"]
    )
    assert captured["served"]
    assert captured["port"] == 8123
    assert captured["wait"] == 10.0


def test_abandoned_jobs_do_not_hold_queue_slots():
    """A timeout burst leaves abandoned jobs in the bounded queue; a new
    submission must purge them instead of bouncing with a spurious 429
    (r4 review finding: capacity only recovered when the batcher cycled)."""
    import queue as _queue

    import numpy as np

    pipe = StubPipeline(delay_s=0.0)
    srv = OCRServer(
        pipe, host="127.0.0.1", port=0, batch_pages=1, max_queue=2,
    )
    # do NOT start the batcher: the queue can only drain via the purge
    img = np.zeros((4, 4, 3), np.uint8)
    j1 = srv.submit(img)
    j2 = srv.submit(img)
    with pytest.raises(_queue.Full):
        srv.submit(img)  # genuinely full: live jobs keep their slots
    j1.abandoned = True
    j2.abandoned = True
    j3 = srv.submit(img)  # purge frees both slots
    assert not j3.abandoned
    assert srv._queue.qsize() == 1  # only the live job remains


def make_npy(arr: "np.ndarray") -> bytes:
    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


def test_npy_body_rgb_roundtrip(server):
    """Raw .npy bodies ride the production fast path (no PIL decode)."""
    srv, pipe = server
    status, body = _post(
        srv.port, make_npy(np.zeros((30, 40, 3), np.uint8))
    )
    assert status == 200
    assert body["text"] == "40x30"


def test_npy_body_grayscale_and_rgba_normalized(server):
    srv, _ = server
    status, body = _post(
        srv.port, make_npy(np.zeros((24, 32), np.uint8))
    )
    assert status == 200
    assert body["text"] == "32x24"
    status, body = _post(
        srv.port, make_npy(np.zeros((24, 32, 4), np.uint8))
    )
    assert status == 200
    assert body["text"] == "32x24"


def test_npy_body_bad_dtype_rejected_400(server):
    srv, _ = server
    status, body = _post(
        srv.port, make_npy(np.zeros((8, 8, 3), np.float32))
    )
    assert status == 400
    assert "uint8" in body["error"]


class PipelinedStub(StubPipeline):
    """Stub exposing the async start_batch/finish_batch pair so the server
    runs its two-stage (assembler + finisher) pipelined worker."""

    def __init__(self, start_s: float = 0.0, finish_s: float = 0.0,
                 fail_on: str | None = None):
        super().__init__()
        self.start_s = start_s
        self.finish_s = finish_s
        self.fail_on = fail_on
        self.events = []  # ("start"/"finish", batch_size, t)

    def start_batch(self, images):
        with self.lock:
            self.events.append(("start", len(images), time.time()))
        if self.fail_on == "start":
            raise ValueError("boom-start")
        if self.start_s:
            time.sleep(self.start_s)
        return list(images)

    def finish_batch(self, handle):
        if self.fail_on == "finish":
            raise ValueError("boom-finish")
        if self.finish_s:
            time.sleep(self.finish_s)
        pages = [self._page(im) for im in handle]
        with self.lock:
            self.events.append(("finish", len(handle), time.time()))
        return pages


def test_pipelined_worker_used_and_correct():
    pipe = PipelinedStub()
    srv = OCRServer(pipe, host="127.0.0.1", port=0, batch_wait_ms=5.0)
    assert srv._pipelined
    srv.start_background()
    try:
        code, body = _post(srv.port, make_png(40, 20))
        assert code == 200
        assert body["text"] == "40x20"
        # the batch went through start/finish, not _run_batch
        kinds = [e[0] for e in pipe.events]
        assert "start" in kinds and "finish" in kinds
        assert pipe.calls == []  # predict/process_batch untouched
    finally:
        srv.shutdown()


def test_pipelined_overlap_next_batch_starts_before_finish():
    """Batch N+1's start_batch (host prep + dispatch) must run while batch
    N is still inside finish_batch — the overlap that hides prep/upload
    behind device compute."""
    pipe = PipelinedStub(finish_s=0.25)
    srv = OCRServer(
        pipe, host="127.0.0.1", port=0, batch_pages=1, batch_wait_ms=1.0
    )
    srv.start_background()
    try:
        results = []

        def post():
            results.append(_post(srv.port, make_png()))

        threads = [threading.Thread(target=post) for _ in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert all(code == 200 for code, _ in results)
        with pipe.lock:
            events = list(pipe.events)
        starts = [t for k, _, t in events if k == "start"]
        finishes = [t for k, _, t in events if k == "finish"]
        assert len(starts) == 3 and len(finishes) == 3
        # the 2nd start happened before the 1st finish completed
        assert starts[1] < finishes[0]
    finally:
        srv.shutdown()


@pytest.mark.parametrize("stage", ["start", "finish"])
def test_pipelined_errors_are_500_and_worker_survives(stage):
    pipe = PipelinedStub(fail_on=stage)
    srv = OCRServer(pipe, host="127.0.0.1", port=0, batch_wait_ms=5.0)
    srv.start_background()
    try:
        code, body = _post(srv.port, make_png())
        assert code == 500
        assert "boom" in body["error"]
        pipe.fail_on = None  # worker must still be alive
        code, body = _post(srv.port, make_png())
        assert code == 200
    finally:
        srv.shutdown()


def test_stop_between_the_check_and_the_put_strands_no_batch():
    """A stop that lands after the batcher's stop check and before its put of
    a started batch, once the finisher has left: ``shutdown()`` finishes the
    batch, so that each client gets its page within a second, and finishes
    it once; a second ``shutdown()`` does nothing."""
    pipe = PipelinedStub()
    finished = []
    finish_batch = pipe.finish_batch
    pipe.finish_batch = lambda handle: finished.append(handle) or finish_batch(handle)
    srv = OCRServer(pipe, host="127.0.0.1", port=0, batch_pages=2, batch_wait_ms=200.0)
    put = threading.Event()

    class StopBeforePut(queue.Queue):
        def put(self, item, block=True, timeout=None):
            srv._stop.set()
            srv._finisher.join(timeout=5)  # stop set, nothing in flight: it leaves
            super().put(item, block, timeout)
            put.set()

    srv._inflight = StopBeforePut(maxsize=1)
    srv.start_background()
    jobs = [srv.submit(np.zeros((24, 32, 3), np.uint8)) for _ in range(2)]
    assert put.wait(10) and not srv._finisher.is_alive()
    t0 = time.time()
    srv.shutdown()
    assert all(job.done.wait(max(0.0, t0 + 1.0 - time.time())) for job in jobs)
    assert [job.result.blocks[0].words[0].text for job in jobs] == ["32x24", "32x24"]
    assert len(finished) == 1 and [e[0] for e in pipe.events].count("finish") == 1
    srv.shutdown()
    assert len(finished) == 1 and not srv._worker.is_alive()


def test_healthz_names_the_torch_device():
    pipe = StubPipeline()
    pipe.device = torch.device("cpu")
    srv = OCRServer(pipe, host="127.0.0.1", port=0)
    bare = OCRServer(StubPipeline(), host="127.0.0.1", port=0)
    try:
        health = srv.health()
        assert health["backend"] == "cpu" and health["device"] == "cpu"
        assert bare.health()["backend"] == "unknown"
    finally:
        srv._httpd.server_close()
        bare._httpd.server_close()


@pytest.fixture(scope="module")
def micro_pipeline():
    from manuscript_tpu_torch import Pipeline
    from manuscript_tpu_torch.utils.quality import load_quality_models

    torch.backends.cudnn.allow_tf32 = False
    return Pipeline(*load_quality_models("cpu"), device="cpu", mode="greedy", max_words=32,
                    batch_pages=2)


def test_real_pipeline_served_text_equals_predict(micro_pipeline):
    """Three concurrent pages through the port's fused pipeline behind the
    server (start_batch on the batcher thread, finish_batch on the finisher
    thread): each served text and page equal ``predict``'s."""
    from manuscript_tpu_torch.utils.synthetic import eval_pages

    pages = [p for p, _ in eval_pages(3, seed=9100)]
    srv = OCRServer(micro_pipeline, host="127.0.0.1", port=0, batch_wait_ms=200.0)
    assert srv._pipelined
    srv.start_background()
    try:
        results = [None] * len(pages)

        def hit(i):
            results[i] = _post(srv.port, make_npy(pages[i]))

        threads = [threading.Thread(target=hit, args=(i,)) for i in range(len(pages))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in threads)
        _, metrics = _get(srv.port, "/metrics")
    finally:
        srv.shutdown()
    for page, (status, body) in zip(pages, results):
        assert status == 200
        ref = micro_pipeline.predict(page)
        assert body["text"] == micro_pipeline.get_text(ref) and body["text"]
        assert body["page"] == json.loads(json.dumps(ref.model_dump()))
    assert "ocr_pages_total 3" in metrics
    # a pinned capacity never grows: nothing to warm
    assert micro_pipeline._fused.warm_next_bucket() is None


def test_warm_next_bucket_runs_each_bucket_once():
    """Auto capacity: the warm runs phase B at every bucket up to the one
    above the capacity, for each chunk size, on the calling thread; then
    there is nothing left to warm."""
    from manuscript_tpu_torch.fused import FusedOCR
    from manuscript_tpu_torch.utils.quality import load_quality_models

    fused = FusedOCR(*load_quality_models("cpu"), max_words="auto", mode="greedy", batch_pages=1)
    assert fused.warm_next_bucket() is None  # capacity not known yet
    fused._apply_capacity(20)
    assert fused.max_words == 32
    calls = []
    rec = fused.recognizer
    real = rec.recognize_tensor
    rec.recognize_tensor = lambda x, *a: calls.append(x.shape[0]) or real(x, *a)
    try:
        assert fused.warm_next_bucket(block=True) == [32, 64]
        assert calls == [32, 64]
        assert fused.warm_next_bucket() is None
    finally:
        del rec.recognize_tensor
    assert FusedOCR(*load_quality_models("cpu"), max_words="auto",
                    crop_source="device").warm_next_bucket() is None
