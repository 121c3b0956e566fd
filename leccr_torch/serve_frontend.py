"""Online serving frontend: dynamic micro-batching + a stdlib HTTP server.

The port of `leccr_tpu/serve_frontend.py` (stdlib only).
`Embedder.search_texts` pads any query batch of at most batch_size to ONE
shape, so a batch of 8 costs about what a batch of 1 does; a frontend
that dispatches one request at a time leaves up to batch_size × the
throughput unused whenever requests arrive together.

`DynamicBatcher` closes that gap: the first request into an empty queue
waits at most `max_delay` for followers, then a single worker thread
drains every compatible pending request (same k/fusion/alpha/nprobe
signature) into ONE `Embedder.search_texts` (or
`serve_ann.search_texts_ivf`) call and fans the rows back out to the
callers.  Under concurrent load the cost per query approaches
wall/batch_size; a lone request pays at most `max_delay` extra latency.

`ServingFrontend` wraps a batcher in `http.server` with a threaded server,
so concurrent POSTs overlap inside the batcher:

    POST /search   {"queries": [...], "k": 10, "fusion": "none",
                    "alpha": 0.9, "nprobe": 8 (IVF indexes only)}
                                         -> {"results": [[[id, score]..]..]}
    GET  /healthz                        -> {"ok": true, "index_size": N}
    GET  /stats                          -> batching counters, latency
                                            percentiles

The reference has no serving story (its entry points stop at offline
eval, image_Retrieval_caption.py:83-163).
"""

from __future__ import annotations

import collections
import json
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Sequence, Tuple


class BatcherOverloaded(RuntimeError):
    """Raised by search() when the pending-query queue is full (the HTTP
    frontend maps it to 503 so load-balancers can shed/retry elsewhere
    instead of piling latency onto an already-saturated device)."""


@dataclass
class _Request:
    queries: List[str]
    future: Future
    t_enqueue: float


@dataclass
class BatcherStats:
    """Counters for observing coalescing behavior (exposed at /stats)."""
    requests: int = 0
    queries: int = 0
    dispatches: int = 0
    dispatched_queries: int = 0
    errors: int = 0
    rejected: int = 0  # requests shed with BatcherOverloaded
    # wall time spent inside Embedder.search_texts, summed
    search_seconds: float = 0.0

    def as_dict(self) -> Dict[str, Any]:
        d = dict(self.__dict__)
        d["mean_batch"] = (self.dispatched_queries / self.dispatches
                           if self.dispatches else 0.0)
        return d


class DynamicBatcher:
    """Coalesces concurrent search requests into shared device dispatches.

    One worker thread owns the Embedder; callers block on a Future.
    Requests are grouped by search signature (k, fusion, alpha, nprobe):
    one search call serves one signature, so they never mix in a
    dispatch.
    A request larger than max_batch is dispatched alone (search_texts
    already chunks internally above batch_size).
    """

    def __init__(self, embedder, index, max_batch: Optional[int] = None,
                 max_delay: float = 0.005,
                 max_pending: Optional[int] = None):
        self.embedder = embedder
        self.index = index
        self.max_batch = int(max_batch or embedder.batch_size)
        self.max_delay = float(max_delay)
        # admission bound in QUERIES (not requests) across all signatures;
        # None = unbounded.  Beyond it search() raises BatcherOverloaded
        # immediately instead of growing the queue — queue latency past a
        # few dispatch walls helps nobody, shedding lets the client retry
        # against another replica
        self.max_pending = None if max_pending is None else int(max_pending)
        self.stats = BatcherStats()
        # recent end-to-end request latencies (enqueue -> result), seconds;
        # bounded so /stats percentile snapshots stay O(1) memory
        self._latencies: "collections.deque[float]" = collections.deque(
            maxlen=2048)
        self._pending_queries = 0
        self._cv = threading.Condition()
        # signature -> FIFO of _Request; OrderedDict keeps arrival order of
        # signatures so no signature starves behind a hot one
        self._pending: "collections.OrderedDict[Tuple, collections.deque]" \
            = collections.OrderedDict()
        self._closed = False
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="leccr-serve-batcher")
        self._worker.start()

    # ---------------------------------------------------------------- API

    def search(self, queries: Sequence[str], k: int = 10,
               fusion: str = "none", alpha: float = 0.9,
               nprobe: Optional[int] = None,
               timeout: Optional[float] = None
               ) -> List[List[Tuple[str, float]]]:
        """Blocking search; safe to call from many threads concurrently.
        `nprobe` applies only when the batcher serves an IVF index
        (serve_ann) — it selects the recall/cost point per request and is
        part of the coalescing signature."""
        queries = list(queries)
        if not queries:
            return []
        fut: Future = Future()
        key = (int(k), str(fusion), round(float(alpha), 9),
               None if nprobe is None else int(nprobe))
        req = _Request(queries=queries, future=fut, t_enqueue=time.monotonic())
        with self._cv:
            if self._closed:
                raise RuntimeError("batcher is closed")
            if (self.max_pending is not None
                    and self._pending_queries + len(queries)
                    > self.max_pending):
                self.stats.rejected += 1
                raise BatcherOverloaded(
                    f"{self._pending_queries} queries pending >= "
                    f"max_pending={self.max_pending}")
            self._pending.setdefault(key, collections.deque()).append(req)
            self._pending_queries += len(queries)
            self.stats.requests += 1
            self.stats.queries += len(queries)
            self._cv.notify_all()
        return fut.result(timeout=timeout)

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        self._worker.join(timeout=10)
        with self._cv:
            for dq in self._pending.values():
                for r in dq:
                    r.future.set_exception(RuntimeError("batcher closed"))
            self._pending.clear()

    def __enter__(self) -> "DynamicBatcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------- worker

    def _run(self) -> None:
        while True:
            batch = self._collect()
            if batch is None:
                return
            key, reqs = batch
            self._dispatch(key, reqs)

    def _collect(self):
        """Wait for work, give followers max_delay to pile on, then drain
        up to max_batch queries of the oldest signature."""
        with self._cv:
            while not self._pending and not self._closed:
                self._cv.wait()
            if not self._pending:
                return None  # closed and drained
            key = next(iter(self._pending))
            dq = self._pending[key]
            deadline = dq[0].t_enqueue + self.max_delay
            while (sum(len(r.queries) for r in dq) < self.max_batch
                   and not self._closed):
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._cv.wait(timeout=remaining)
                dq = self._pending.get(key)
                if dq is None:  # defensive; only this thread removes keys
                    return self._collect()
            reqs, n = [], 0
            while dq and (not reqs or n + len(dq[0].queries) <= self.max_batch):
                r = dq.popleft()
                reqs.append(r)
                n += len(r.queries)
            self._pending_queries -= n
            if not dq:
                del self._pending[key]
            return key, reqs

    def _dispatch(self, key, reqs: List[_Request]) -> None:
        k, fusion, alpha, nprobe = key
        queries = [q for r in reqs for q in r.queries]
        t0 = time.monotonic()
        try:
            from leccr_torch.serve_ann import IVFIndex, search_texts_ivf

            if isinstance(self.index, IVFIndex):
                if fusion != "none":
                    raise ValueError(
                        "an IVF index carries no slot bank; "
                        f"fusion={fusion!r} is exact-index only")
                results = search_texts_ivf(
                    self.embedder, queries, self.index, k=k, nprobe=nprobe)
            elif nprobe is not None:
                raise ValueError("nprobe applies to IVF indexes only")
            else:
                results = self.embedder.search_texts(
                    queries, self.index, k=k, fusion=fusion, alpha=alpha)
        except Exception as e:  # propagate to every caller in the batch
            with self._cv:
                self.stats.errors += len(reqs)
            for r in reqs:
                r.future.set_exception(e)
            return
        t1 = time.monotonic()
        with self._cv:
            self.stats.dispatches += 1
            self.stats.dispatched_queries += len(queries)
            self.stats.search_seconds += t1 - t0
            self._latencies.extend(t1 - r.t_enqueue for r in reqs)
        off = 0
        for r in reqs:
            r.future.set_result(results[off: off + len(r.queries)])
            off += len(r.queries)

    # -------------------------------------------------------------- stats

    def stats_dict(self) -> Dict[str, Any]:
        """Counters + recent end-to-end latency percentiles (seconds)."""
        with self._cv:
            d = self.stats.as_dict()
            lats = sorted(self._latencies)
            d["pending_queries"] = self._pending_queries
        if lats:
            d["latency_p50_s"] = lats[len(lats) // 2]
            d["latency_p95_s"] = lats[min(len(lats) - 1,
                                          int(len(lats) * 0.95))]
        return d


class _Handler(BaseHTTPRequestHandler):
    # the server instance carries the batcher (set by ServingFrontend)

    def _reply(self, code: int, payload: Dict[str, Any]) -> None:
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self) -> None:  # noqa: N802 (stdlib API name)
        batcher: DynamicBatcher = self.server.batcher  # type: ignore
        if self.path == "/healthz":
            self._reply(200, {"ok": True,
                              "index_size": batcher.index.n_valid})
        elif self.path == "/stats":
            self._reply(200, batcher.stats_dict())
        else:
            self._reply(404, {"error": f"unknown path {self.path}"})

    def do_POST(self) -> None:  # noqa: N802
        batcher: DynamicBatcher = self.server.batcher  # type: ignore
        if self.path != "/search":
            self._reply(404, {"error": f"unknown path {self.path}"})
            return
        try:
            length = int(self.headers.get("Content-Length", "0"))
            req = json.loads(self.rfile.read(length) or b"{}")
            queries = req.get("queries")
            if not isinstance(queries, list) or \
                    not all(isinstance(q, str) for q in queries):
                raise ValueError('"queries" must be a list of strings')
            nprobe = req.get("nprobe")
            results = batcher.search(
                queries, k=int(req.get("k", 10)),
                fusion=str(req.get("fusion", "none")),
                alpha=float(req.get("alpha", 0.9)),
                nprobe=None if nprobe is None else int(nprobe))
        except ValueError as e:
            self._reply(400, {"error": str(e)})
        except BatcherOverloaded as e:  # shed load; client should retry
            self._reply(503, {"error": str(e)})
        except Exception as e:  # index/embedder faults -> 500, not a hang
            self._reply(500, {"error": f"{type(e).__name__}: {e}"})
        else:
            self._reply(200, {"results": results})

    def log_message(self, fmt, *args):  # quiet: JSONL logs live trainer-side
        pass


class _Server(ThreadingHTTPServer):
    # listen backlog: socketserver's default of 5 resets connections when
    # a burst of concurrent clients connects at once
    request_queue_size = 128


class ServingFrontend:
    """HTTP frontend over a DynamicBatcher.  Binds host:port (port 0 picks
    a free one — read `.port` after construction), serves on a background
    thread until close()."""

    def __init__(self, batcher: DynamicBatcher, host: str = "127.0.0.1",
                 port: int = 0):
        self.batcher = batcher
        self._server = _Server((host, port), _Handler)
        self._server.batcher = batcher  # type: ignore[attr-defined]
        self.host, self.port = self._server.server_address[:2]
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name="leccr-serve-http")
        self._thread.start()

    def close(self, close_batcher: bool = True) -> None:
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=10)
        if close_batcher:
            self.batcher.close()

    def __enter__(self) -> "ServingFrontend":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
