"""The port's ``BatchingFrontend`` and HTTP server on the CPU: the frontend
tests of tests/test_serving.py:476-700 with the same stub predictors (its
race and deadlock fixes), concurrent clients against direct ``predict``, and
``mgnns_tpu_torch.cli.serve`` over loopback."""

import json
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from mgnns_tpu_torch.cli import serve as pserve
from mgnns_tpu_torch.config import TextGraphConfig
from mgnns_tpu_torch.engine.checkpoint import Checkpointer
from mgnns_tpu_torch.graphs.pmi import cal_pmi
from mgnns_tpu_torch.graphs.vocab import build_vocab
from mgnns_tpu_torch.models.text_only import text_model_init
from mgnns_tpu_torch.serving import BatchingFrontend, Predictor, save_preproc
from tests.torch_train_common import few_torch_threads  # noqa: F401  (autouse fixture)
from tests.torch_train_common import CPU

CORPUS = ["happy joy smile great day", "sad cry tears bad day", "joy smile happy fun",
          "cry bad sad terrible", "great fun smile joy", "terrible tears bad cry"]
LABELS = {"neg": 0, "pos": 1, "other": 2}


class _StubPredictor:
    """The frontend's view of a Predictor: ``_encode_host`` on the encode
    thread, ``_forward`` / ``_readback`` / ``_format`` on the device thread.
    The 'batch' is the object array of record ids."""

    text_only = True

    def _encode_host(self, records):
        return np.array([r["id"] for r in records], dtype=object), len(records)

    @staticmethod
    def _readback(probs):
        return probs

    def _format(self, probs):
        return [{"id": i} for i in probs]


def _wait_until(cond, timeout=5.0):
    t0 = time.perf_counter()
    while not cond():
        if time.perf_counter() - t0 > timeout:
            raise AssertionError("condition not reached")
        time.sleep(0.01)


def test_frontend_drops_abandoned_requests():
    """A request whose client timed out while queued is never predicted."""
    release = threading.Event()
    calls = []

    class Pred(_StubPredictor):
        max_batch = 8

        def _forward(self, batch):
            calls.append(list(batch))
            if batch[0] == "A":
                release.wait(10)
            return batch

    fe = BatchingFrontend(Pred(), max_queue=4)
    result_a = {}
    ta = threading.Thread(target=lambda: result_a.update(out=fe.submit([{"id": "A"}], timeout=15)))
    ta.start()
    _wait_until(lambda: calls)
    assert calls[0] == ["A"]
    with pytest.raises(TimeoutError):
        fe.submit([{"id": "B"}], timeout=0.05)
    release.set()
    ta.join(15)
    assert not ta.is_alive() and result_a["out"] == [{"id": "A"}]
    assert fe.submit([{"id": "C"}], timeout=15) == [{"id": "C"}]
    assert all("B" not in c for c in calls)


def test_frontend_never_overflows_max_batch():
    """Coalescing stops before a group exceeds max_batch: 3 + 2 > 4 runs as
    two groups."""
    release = threading.Event()
    calls = []

    class Pred(_StubPredictor):
        max_batch = 4

        def _forward(self, batch):
            calls.append(len(batch))
            if batch[0] == "hold0":
                release.wait(10)
            return batch

    fe = BatchingFrontend(Pred(), max_queue=8)
    results = {}

    def client(name, n):
        results[name] = fe.submit([{"id": f"{name}{i}"} for i in range(n)], timeout=15)

    threads = [threading.Thread(target=client, args=("hold", 1))]
    threads[0].start()
    _wait_until(lambda: calls)
    assert calls == [1]
    threads.append(threading.Thread(target=client, args=("a", 3)))
    threads[1].start()
    _wait_until(lambda: fe._inflight >= 2)
    threads.append(threading.Thread(target=client, args=("b", 2)))
    threads[2].start()
    _wait_until(lambda: fe._q.qsize() == 0)
    time.sleep(0.05)
    release.set()
    for t in threads:
        t.join(15)
        assert not t.is_alive()
    assert calls == [1, 3, 2]
    assert [r["id"] for r in results["a"]] == ["a0", "a1", "a2"]
    assert [r["id"] for r in results["b"]] == ["b0", "b1"]


def test_frontend_coalesces_while_pipe_full():
    """With two chunks in flight, four concurrent 1-record requests run as
    one forward, not four."""
    release = threading.Event()
    calls = []

    class Pred(_StubPredictor):
        max_batch = 8

        def _forward(self, batch):
            calls.append(len(batch))
            if batch[0] == "hold0":
                release.wait(10)
            return batch

    fe = BatchingFrontend(Pred(), max_queue=32)
    results = {}

    def client(name, n):
        results[name] = fe.submit([{"id": f"{name}{i}"} for i in range(n)], timeout=15)

    threads = [threading.Thread(target=client, args=("hold", 1))]
    threads[0].start()
    _wait_until(lambda: calls)
    threads.append(threading.Thread(target=client, args=("a", 1)))
    threads[1].start()
    _wait_until(lambda: fe._inflight >= 2)
    threads += [threading.Thread(target=client, args=(f"c{i}", 1)) for i in range(4)]
    for t in threads[2:]:
        t.start()
    _wait_until(lambda: fe._q.qsize() == 0)
    time.sleep(0.05)
    release.set()
    for t in threads:
        t.join(15)
        assert not t.is_alive()
    assert calls[:2] == [1, 1]
    assert calls[2:] == [4], calls
    for i in range(4):
        assert [r["id"] for r in results[f"c{i}"]] == [f"c{i}0"]


def test_frontend_empty_submit_returns_at_once():
    class Pred(_StubPredictor):
        max_batch = 4

        def _forward(self, batch):
            return batch

    fe = BatchingFrontend(Pred(), max_queue=4)
    t0 = time.perf_counter()
    assert fe.submit([], timeout=5) == []
    assert time.perf_counter() - t0 < 1.0
    assert [r["id"] for r in fe.submit([{"id": "x"}], timeout=10)] == ["x"]


def test_frontend_inflight_counter_never_negative():
    """The in-flight counter goes up before a chunk is handed to the device
    thread; 32 concurrent clients, a short switch interval."""

    class Pred(_StubPredictor):
        max_batch = 2

        def _forward(self, batch):
            return batch

    fe = BatchingFrontend(Pred(), max_queue=64)
    seen = []

    def counting_item_done():
        with fe._lock:
            seen.append(fe._inflight)
            fe._inflight -= 1
            fe._wake.notify_all()

    fe._item_done = counting_item_done
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda i=i: fe.submit([{"id": f"r{i}"}], timeout=15))
                   for i in range(32)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(20)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(interval)
    assert seen and min(seen) >= 1, seen
    with fe._lock:
        assert fe._inflight == 0


def _text_predictor_parts(seed=0):
    vocab = build_vocab(CORPUS, 1)
    graph = cal_pmi(CORPUS, vocab, window_size=3, min_cooccurrence=1)
    params = text_model_init(len(vocab), len(LABELS), graph.num_edges, seed=seed, device=CPU)
    return vocab, graph, params


def _records(n, tag):
    words = " ".join(CORPUS).split()
    return [{"id": f"{tag}-{i}", "text": " ".join(words[(i * 7 + j * 3) % len(words)]
                                                 for j in range(2 + i % 5))} for i in range(n)]


def test_frontend_concurrent_clients_match_direct_predict():
    """8 clients x 4 requests of 1-5 records through a real Predictor equal
    a direct ``predict`` of the same records (probabilities within 1e-5:
    batch composition changes the shapes of the products)."""
    vocab, graph, params = _text_predictor_parts()
    pred = Predictor(vocab=vocab, graph=graph, graph_cfg=TextGraphConfig(ngram=2),
                     label_map=LABELS, params=params, text_only=True, max_batch=4, device=CPU)
    fe = BatchingFrontend(pred, max_queue=64)
    requests = {(c, k): _records(1 + (c + k) % 5, f"c{c}k{k}") for c in range(8) for k in range(4)}
    answers = {}

    def client(c):
        for k in range(4):
            answers[(c, k)] = fe.submit(requests[(c, k)], timeout=30)

    threads = [threading.Thread(target=client, args=(c,)) for c in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
        assert not t.is_alive()
    for key, recs in requests.items():
        want = pred.predict(recs)
        got = answers[key]
        assert [g["label"] for g in got] == [w["label"] for w in want]
        for g, w in zip(got, want):
            np.testing.assert_allclose(list(g["probs"].values()), list(w["probs"].values()),
                                       atol=1e-5)
    stats = fe.stats()
    assert stats["requests"] == 32 and stats["inflight_chunks"] == 0
    assert 0 < stats["latency_ms"]["p50"] <= stats["latency_ms"]["p99"] <= stats["latency_ms"]["max"]
    pred.close()


@pytest.fixture
def server(tmp_path):
    """``cli.serve.make_server`` on 127.0.0.1, a free port, serving a
    text-only checkpoint written here, with a request queue of one."""
    vocab, graph, params = _text_predictor_parts(seed=3)
    ckpt = tmp_path / "ckpt"
    Checkpointer(str(ckpt)).save(1, {"params": params, "batch_stats": {}})
    save_preproc(str(ckpt), vocab, graph, LABELS, TextGraphConfig())
    args = pserve.build_parser().parse_args([
        "--platform", "cpu", "--checkpoint", str(ckpt), "--data_root_path", str(tmp_path),
        "--text_only", "--port", "0", "--max_queue", "1", "--max_batch", "4"])
    srv = pserve.make_server(args)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield srv
    srv.shutdown()
    srv.server_close()
    srv.frontend.predictor.close()
    thread.join(10)


def _http(srv, method, path, body=None):
    host, port = srv.server_address[:2]
    req = urllib.request.Request(f"http://{host}:{port}{path}", data=body, method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_http_healthz_predict_and_errors(server):
    recs = _records(6, "h")
    code, out = _http(server, "POST", "/predict", json.dumps({"records": recs}).encode())
    assert code == 200
    want = server.frontend.predictor.predict(recs)
    assert [o["label"] for o in out["predictions"]] == [w["label"] for w in want]
    code, health = _http(server, "GET", "/healthz")
    assert code == 200 and health["status"] == "ok" and health["text_only"] is True
    assert health["model"].endswith("ckpt") and health["requests"] == 1
    assert _http(server, "POST", "/predict", b"{not json")[0] == 400
    assert _http(server, "POST", "/predict", json.dumps({"records": []}).encode())[0] == 400
    assert _http(server, "GET", "/nope")[0] == 404
    assert _http(server, "POST", "/nope", b"{}")[0] == 404


def test_http_full_queue_answers_503(server):
    """With the encoder held on one request and the queue of one taken, the
    next request is refused at once; the held ones then complete."""
    fe = server.frontend
    entered, release = threading.Event(), threading.Event()
    encode = fe.predictor._encode_host

    def held_encode(records):
        entered.set()
        release.wait(10)
        return encode(records)

    fe.predictor._encode_host = held_encode
    body = json.dumps([{"text": "happy joy"}]).encode()
    codes = []
    held = [threading.Thread(target=lambda: codes.append(_http(server, "POST", "/predict", body)[0]))
            for _ in range(2)]
    held[0].start()
    assert entered.wait(10)
    held[1].start()
    _wait_until(lambda: fe._q.qsize() == 1)
    code, out = _http(server, "POST", "/predict", body)
    assert code == 503 and "queue full" in out["error"]
    release.set()
    for t in held:
        t.join(20)
        assert not t.is_alive()
    assert codes == [200, 200]
