"""``cli.serve`` on a mesh, on the CPU: 2 gloo ranks of ``python -m
mgnns_tpu_torch.cli.serve --mesh_model 2`` (started as torchrun starts
them), rank 0 answering HTTP and handing each chunk to rank 1
(``serving.MeshLink``), held to one process's ``Predictor`` and to the JAX
package's ``Predictor(mesh=...)`` on the same weights; then the frontend's
side of the link with stub predictors: which chunks reach the other ranks,
in which order, and the stop."""

import dataclasses
import json
import os
import re
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from mgnns_tpu.config import TextGraphConfig as JTextGraphConfig
from mgnns_tpu.graphs.pmi import PmiGraph as JPmiGraph
from mgnns_tpu.models import text_model_apply as j_text_model_apply
from mgnns_tpu.parallel.mesh import create_mesh as j_create_mesh
from mgnns_tpu.serving import Predictor as JPredictor

from mgnns_tpu_torch.cli import main as pmain
from mgnns_tpu_torch.engine.checkpoint import Checkpointer
from mgnns_tpu_torch.serving import BatchingFrontend, Predictor, load_preproc
from tests.test_mvsa import _make_mvsa_tree
from tests.test_torch_parallel import _cli_args, _free_port
from tests.torch_train_common import CPU

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAX_BATCH = 4
WORDS = ["good", "great", "happy", "love", "wonderful", "bad", "sad", "awful", "hate",
         "terrible", "table", "walk", "city", "day", "photo", "unseenword"]


def _texts(r, n: int) -> list[dict]:
    return [{"id": f"r{r.integers(1 << 30)}", "text": " ".join(r.choice(WORDS, r.integers(1, 9)))}
            for _ in range(n)]


def _start_ranks(argv: list[str], logdir, n: int = 2) -> list[subprocess.Popen]:
    port = _free_port()
    procs = []
    for r in range(n):
        env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(r),
                   WORLD_SIZE=str(n), LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(n),
                   PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
        with open(logdir / f"rank{r}.log", "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "mgnns_tpu_torch.cli.serve", *argv], env=env, cwd=ROOT,
                stdout=log, stderr=subprocess.STDOUT))
    return procs


def _url(procs, logdir, timeout: float = 120) -> str:
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < timeout:
        m = re.search(r"serving on (http://\S+)", (logdir / "rank0.log").read_text())
        if m:
            return m.group(1)
        if any(p.poll() is not None for p in procs):
            break
        time.sleep(0.1)
    logs = "\n".join((logdir / f"rank{r}.log").read_text()[-3000:] for r in range(len(procs)))
    pytest.fail(f"rank 0 did not start serving:\n{logs}")


def _http(url: str, path: str, body: bytes | None = None):
    req = urllib.request.Request(url + path, data=body, method="POST" if body is not None
                                 else "GET", headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _probs(answers: list[dict]) -> np.ndarray:
    return np.array([list(a["probs"].values()) for a in answers])


def _jax_mesh_predictor(ckpt: str, data: int, model: int) -> JPredictor:
    """The JAX package's Predictor on a ``(data, model)`` mesh of the
    virtual devices, on the checkpoint's weights and preprocessing."""
    vocab, graph, label_map, gcfg = load_preproc(ckpt)
    params = Checkpointer(ckpt).restore(device=CPU)["params"]
    return JPredictor(
        vocab=vocab, graph=JPmiGraph(graph.vocab_size, graph.keys, graph.pmi),
        graph_cfg=JTextGraphConfig(**dataclasses.asdict(gcfg)), label_map=label_map,
        apply_fn=lambda p, bs, b: j_text_model_apply(p, b, ngram=gcfg.ngram),
        params=jax.tree.map(lambda t: jnp.asarray(t.numpy()), params), batch_stats={},
        text_only=True, max_batch=MAX_BATCH, mesh=j_create_mesh(data=data, model=model))


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """(data root, checkpoint) of a text-only CLI run on the MVSA-style tree."""
    tmp = tmp_path_factory.mktemp("serve_mesh")
    root = tmp / "data"
    _make_mvsa_tree(root)
    pmain.main(_cli_args(root, tmp / "run", True) + ["--epochs", "1"])
    return root, str(tmp / "run" / "ckpt" / "mgnns_tpu")


@pytest.mark.parametrize("data,model", [(1, 2), (2, 1)], ids=["model-2", "data-2"])
def test_cli_serve_on_a_mesh_answers_as_one_process_and_the_jax_mesh(trained, tmp_path,
                                                                      data, model):
    """On ``--mesh_model 2`` and on ``--mesh_data 2``, concurrent clients
    (requests of 1-5 records and one of 9, past ``--max_batch 4``) get one
    process's answers (labels equal, probabilities 1e-6) and the JAX mesh
    Predictor's (1e-5); a body that is not JSON answers 400 and a record
    without text 500, and the request after them is still answered; SIGTERM
    to rank 0 stops both ranks, each after the same number of chunks, with
    exit code 0."""
    root, ckpt = trained
    procs = _start_ranks(["--platform", "cpu", "--text_only", "--mesh_data", str(data),
                          "--mesh_model", str(model), "--port", "0",
                          "--data_root_path", str(root), "--checkpoint", ckpt,
                          "--max_batch", str(MAX_BATCH)], tmp_path)
    try:
        # the references while the ranks start
        one = Predictor.from_engine_artifacts(str(root), ckpt, text_only=True, device=CPU,
                                              max_batch=MAX_BATCH)
        jpred = _jax_mesh_predictor(ckpt, data, model)
        r = np.random.default_rng(0)
        requests = {(c, k): _texts(r, 9 if (c, k) == (0, 1) else 1 + (c + 2 * k) % 5)
                    for c in range(6) for k in range(2)}
        url = _url(procs, tmp_path)
        answers = {}

        def client(c):
            for k in range(2):
                answers[(c, k)] = _http(url, "/predict",
                                        json.dumps({"records": requests[(c, k)]}).encode())

        threads = [threading.Thread(target=client, args=(c,)) for c in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
            assert not t.is_alive()
        assert _http(url, "/predict", b"{not json")[0] == 400
        code, err = _http(url, "/predict", json.dumps([{"id": "no-text"}]).encode())
        assert code == 500 and "text" in err["error"]
        last = _texts(r, 3)
        answers["last"] = _http(url, "/predict", json.dumps(last).encode())
        requests["last"] = last
        code, health = _http(url, "/healthz")
        assert code == 200 and health["requests"] == len(requests) + 1
        procs[0].send_signal(signal.SIGTERM)
        codes = [p.wait(120) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    logs = [(tmp_path / f"rank{i}.log").read_text() for i in range(2)]
    assert codes == [0, 0], logs
    chunks = [int(re.search(rf"rank {i}: stopped after (\d+) chunks", logs[i]).group(1))
              for i in range(2)]
    assert chunks[0] == chunks[1] >= 1 + 9 // MAX_BATCH
    for key, recs in requests.items():
        code, out = answers[key]
        assert code == 200, (key, out)
        got = out["predictions"]
        want = one.predict(recs)
        jwant = jpred.predict(recs)
        assert [g["label"] for g in got] == [w["label"] for w in want] == \
            [w["label"] for w in jwant]
        np.testing.assert_allclose(_probs(got), _probs(want), atol=1e-6)
        np.testing.assert_allclose(_probs(got), _probs(jwant), atol=1e-5)
    one.close()


# ------------------------------------------------- the frontend's side of the link


class _StubPredictor:
    """The frontend's view of a Predictor; the 'batch' is the record ids."""

    text_only = True
    max_batch = 4

    def _encode_host(self, records):
        if any("text" not in r for r in records):
            raise KeyError("text")
        return np.array([r["id"] for r in records], dtype=object), len(records)

    @staticmethod
    def _readback(probs):
        return probs

    def _format(self, probs):
        return [{"id": i} for i in probs]


class _StubLink:
    """Records what rank 0 would send: each chunk's ids, then the stop."""

    def __init__(self, hold: threading.Event | None = None):
        self.sent: list = []
        self.hold = hold

    def forward(self, batch, n_real):
        if self.hold is not None:
            self.hold.wait(10)
        self.sent.append(list(batch[:n_real]))
        return batch

    def stop(self):
        self.sent.append("stop")


def test_frontend_link_sends_each_run_chunk_once_then_the_stop():
    """Chunks reach the link in the order the device thread runs them, each
    once; a request past ``max_batch`` is several chunks; close() answers
    what is queued and sends the stop last, once, and later submits raise."""
    link = _StubLink()
    fe = BatchingFrontend(_StubPredictor(), link=link)
    recs = [{"id": f"a{i}", "text": "x"} for i in range(9)]
    assert [o["id"] for o in fe.submit(recs, timeout=10)] == [r["id"] for r in recs]
    assert [o["id"] for o in fe.submit([{"id": "b", "text": "x"}], timeout=10)] == ["b"]
    fe.close()
    fe.close()  # a second close waits as the first and sends nothing
    assert link.sent == [[f"a{i}" for i in range(4)], [f"a{i}" for i in range(4, 8)], ["a8"],
                         ["b"], "stop"]
    with pytest.raises(RuntimeError, match="closed"):
        fe.submit([{"id": "c", "text": "x"}])


def test_frontend_link_never_sees_dropped_chunks():
    """A group whose encode fails and a request whose client gave up are
    dropped before the link: the other ranks never hear of them."""
    hold = threading.Event()
    link = _StubLink(hold)
    fe = BatchingFrontend(_StubPredictor(), link=link)
    first = threading.Thread(target=lambda: fe.submit([{"id": "first", "text": "x"}], timeout=20))
    first.start()
    time.sleep(0.2)  # 'first' now holds the device thread
    with pytest.raises(TimeoutError):
        fe.submit([{"id": "gone", "text": "x"}], timeout=0.3)
    errors = []

    def bad():
        try:
            fe.submit([{"id": "bad"}], timeout=20)
        except KeyError as e:
            errors.append(e)

    failing = threading.Thread(target=bad)
    failing.start()
    hold.set()
    for t in (first, failing):
        t.join(20)
        assert not t.is_alive()
    assert len(errors) == 1
    assert [o["id"] for o in fe.submit([{"id": "after", "text": "x"}], timeout=10)] == ["after"]
    fe.close()
    assert link.sent == [["first"], ["after"], "stop"]
