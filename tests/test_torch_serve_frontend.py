"""The port's dynamic-batching frontend (`leccr_torch/serve_frontend.py`):
the seven cases of tests/test_serve_frontend.py on the port's classes with
the same fake embedder, and a real tiny CPU Embedder behind the HTTP
frontend, whose answers equal a direct `search_texts` (and, on an IVF
index, `search_texts_ivf`).  Every wait here has a timeout, so a hang
fails the test instead of stalling the run."""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from leccr_torch import serve_ann
from leccr_torch.serve_frontend import (
    BatcherOverloaded,
    DynamicBatcher,
    ServingFrontend,
)
from test_serve_frontend import FakeEmbedder, FakeIndex
from test_torch_serve import (  # noqa: F401  (embedders is a fixture)
    CAPTIONS,
    QUERIES,
    embedders,
)

WAIT = 30  # seconds: the longest any step here may block


def _until(cond, what):
    deadline = time.monotonic() + WAIT
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.001)


def _join(threads):
    for t in threads:
        t.join(timeout=WAIT)
        assert not t.is_alive()


def _get(url):
    with urllib.request.urlopen(url, timeout=WAIT) as r:
        return json.loads(r.read())


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type":
                                          "application/json"})
    with urllib.request.urlopen(req, timeout=WAIT) as r:
        return json.loads(r.read())


def test_batcher_coalesces_concurrent_requests():
    """While the worker is busy with request A, requests B/C/D pile up and
    go out as one dispatch (the fake blocks call 1)."""
    emb = FakeEmbedder()
    with DynamicBatcher(emb, FakeIndex(), max_delay=0.001) as b:
        results = {}

        def call(name):
            results[name] = b.search([name], k=3, timeout=WAIT)

        ta = threading.Thread(target=call, args=("a",))
        ta.start()
        assert emb.entered_first.wait(timeout=WAIT)
        rest = [threading.Thread(target=call, args=(n,))
                for n in ("b", "c", "d")]
        for t in rest:
            t.start()
        _until(lambda: b.stats.queries >= 4, "b, c and d to queue")
        emb.block_first.set()
        _join([ta] + rest)

    assert results == {n: [[(n, 3.0)]] for n in "abcd"}
    assert len(emb.calls) == 2
    assert sorted(emb.calls[1][0]) == ["b", "c", "d"]
    assert b.stats.dispatches == 2 and b.stats.dispatched_queries == 4


def test_batcher_signature_isolation_and_caps():
    """Different (k, fusion, alpha) never share a dispatch; a dispatch
    never exceeds max_batch queries; an oversized request goes alone."""
    emb = FakeEmbedder(batch_size=4)
    emb.block_first.set()
    with DynamicBatcher(emb, FakeIndex(), max_batch=4, max_delay=0.05) as b:
        outs = []
        threads = [
            threading.Thread(target=lambda: outs.append(
                b.search([f"k3_{i}"], k=3, timeout=WAIT))) for i in range(3)
        ] + [
            threading.Thread(target=lambda: outs.append(
                b.search(["k5"], k=5, timeout=WAIT))),
            threading.Thread(target=lambda: outs.append(
                b.search([f"big{i}" for i in range(6)], k=3,
                         timeout=WAIT))),
        ]
        for t in threads:
            t.start()
        _join(threads)
    assert len(outs) == 5
    for queries, k, _, _ in emb.calls:
        ks = {3.0 if q.startswith(("k3", "big")) else 5.0 for q in queries}
        assert ks == {float(k)}, (queries, k)
        assert len(queries) <= 4 or all(q.startswith("big") for q in queries)


def test_batcher_error_propagates_and_empty_ok():
    class Boom(FakeEmbedder):
        def search_texts(self, *a, **kw):
            raise RuntimeError("index melted")

    with DynamicBatcher(Boom(), FakeIndex(), max_delay=0.001) as b:
        assert b.search([]) == []
        with pytest.raises(RuntimeError, match="melted"):
            b.search(["q"], timeout=WAIT)
        assert b.stats.errors == 1


def test_http_frontend_roundtrip():
    emb = FakeEmbedder()
    emb.block_first.set()
    with DynamicBatcher(emb, FakeIndex(), max_delay=0.001) as b, \
            ServingFrontend(b) as fe:
        base = f"http://{fe.host}:{fe.port}"
        assert _get(base + "/healthz") == {"ok": True, "index_size": 7}
        out = _post(base + "/search", {"queries": ["red dog", "field"],
                                       "k": 2})
        assert out == {"results": [[["red dog", 2.0]], [["field", 2.0]]]}
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(base + "/search", {"queries": "nope"})
        assert ei.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(base + "/nowhere")
        assert ei.value.code == 404
        assert _get(base + "/stats")["dispatched_queries"] == 2


def test_batcher_overload_sheds_and_recovers():
    """Beyond max_pending queries, search() raises BatcherOverloaded at
    once; once the backlog drains, requests are admitted again."""
    emb = FakeEmbedder()
    with DynamicBatcher(emb, FakeIndex(), max_delay=0.001,
                        max_pending=2) as b:
        results = {}

        def call(name):
            results[name] = b.search([name], k=3, timeout=WAIT)

        ta = threading.Thread(target=call, args=("a",))
        ta.start()
        assert emb.entered_first.wait(timeout=WAIT)
        tb = threading.Thread(target=call, args=("b",))
        tc = threading.Thread(target=call, args=("c",))
        tb.start(), tc.start()
        _until(lambda: b.stats.queries >= 3, "b and c to queue")
        with pytest.raises(BatcherOverloaded):
            b.search(["d"], k=3, timeout=WAIT)
        assert b.stats.rejected == 1
        emb.block_first.set()
        _join((ta, tb, tc))
        assert b.search(["e"], k=3, timeout=WAIT) == [[("e", 3.0)]]
    assert results == {n: [[(n, 3.0)]] for n in "abc"}


def test_stats_latency_percentiles():
    emb = FakeEmbedder()
    emb.block_first.set()
    with DynamicBatcher(emb, FakeIndex(), max_delay=0.0) as b:
        for i in range(5):
            b.search([f"q{i}"], k=2, timeout=WAIT)
        d = b.stats_dict()
    assert d["pending_queries"] == 0 and d["rejected"] == 0
    assert 0 <= d["latency_p50_s"] <= d["latency_p95_s"] < 10
    assert d["dispatches"] == 5


def test_closed_batcher_refuses_work():
    emb = FakeEmbedder()
    emb.block_first.set()
    b = DynamicBatcher(emb, FakeIndex())
    b.close()
    with pytest.raises(RuntimeError, match="closed"):
        b.search(["q"], timeout=WAIT)


# ------------------------------------------- a real tiny Embedder (CPU)

@pytest.fixture(scope="module")
def served(embedders):
    """The port's tiny Embedder, an index of 6 images, and the same
    index's IVF."""
    _, emb, images = embedders
    index = emb.build_image_index(images, CAPTIONS,
                                  ids=[f"img{i}" for i in range(6)])
    ivf = serve_ann.build_ivf_index(index, n_clusters=2, iters=3,
                                    device="cpu")
    return emb, index, ivf


def test_http_frontend_real_embedder(served):
    """Concurrent HTTP clients through the batcher get what a direct
    search_texts returns, query for query."""
    emb, index, _ = served
    want = emb.search_texts(QUERIES, index, k=3)
    got = [None] * len(QUERIES)
    with DynamicBatcher(emb, index, max_delay=0.02) as b, \
            ServingFrontend(b) as fe:
        base = f"http://{fe.host}:{fe.port}"

        def call(i):
            got[i] = _post(base + "/search",
                           {"queries": [QUERIES[i]], "k": 3})["results"][0]

        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(len(QUERIES))]
        for t in threads:
            t.start()
        _join(threads)
        assert _get(base + "/healthz")["index_size"] == len(CAPTIONS)
        stats = _get(base + "/stats")
    for w, g in zip(want, got):
        assert [h[0] for h in w] == [h[0] for h in g]
        np.testing.assert_allclose([h[1] for h in w], [h[1] for h in g],
                                   rtol=0, atol=1e-6)
    assert stats["errors"] == 0 and stats["dispatches"] <= len(QUERIES)


def test_batcher_serves_ivf_index(served):
    """An IVF index goes through search_texts_ivf, nprobe is part of the
    signature, and fusion (no slot bank) or nprobe on an exact index is a
    client error."""
    emb, index, ivf = served
    with DynamicBatcher(emb, ivf) as b:
        r = b.search(["a man rides"], k=3, nprobe=2, timeout=WAIT)
        assert r == serve_ann.search_texts_ivf(emb, ["a man rides"], ivf,
                                               k=3, nprobe=2)
        assert [i for i, _ in r[0]] == [
            i for i, _ in emb.search_texts(["a man rides"], index, k=3)[0]]
        with pytest.raises(ValueError, match="slot bank"):
            b.search(["a man"], k=2, fusion="minmax", timeout=WAIT)
    with DynamicBatcher(emb, index) as b:
        with pytest.raises(ValueError, match="IVF indexes only"):
            b.search(["a man"], k=2, nprobe=2, timeout=WAIT)
