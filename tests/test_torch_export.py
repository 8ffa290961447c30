"""The port's serving artifacts on the CPU: K1 and K2 as ``torch.library``
operators (``opcheck``), ``mgnns_tpu_torch.export`` against the live
``Predictor`` (text-only, a 32 px fusion model, bf16 trunks), against the JAX
package's exported artifact, and through ``cli.predict --export_model`` /
``--from_exported`` (in a fresh process) and ``cli.serve --from_exported``,
as tests/test_serving.py:265-365,420-450 drive the JAX export."""

import json
import os
import subprocess
import sys
import threading
import urllib.request

import numpy as np
import pytest
import torch

import jax

from mgnns_tpu.config import TextGraphConfig as JTextGraphConfig
from mgnns_tpu.export import _flatten_with_paths as j_flatten_with_paths
from mgnns_tpu.export import export_predictor as j_export_predictor
from mgnns_tpu.export import load_exported as j_load_exported
from mgnns_tpu.graphs.pmi import cal_pmi as j_cal_pmi
from mgnns_tpu.models import text_model_apply as j_text_model_apply
from mgnns_tpu.models import text_model_init as j_text_model_init
from mgnns_tpu.serving import Predictor as JPredictor

from mgnns_tpu_torch import convert, export
from mgnns_tpu_torch import serving
from mgnns_tpu_torch.cli import predict as ppredict
from mgnns_tpu_torch.cli import serve as pserve
from mgnns_tpu_torch.config import ModelConfig, TextGraphConfig
from mgnns_tpu_torch.engine.checkpoint import Checkpointer
from mgnns_tpu_torch.graphs.cooccur import gen_A
from mgnns_tpu_torch.graphs.pmi import PmiGraph, cal_pmi
from mgnns_tpu_torch.graphs.vocab import build_vocab
from mgnns_tpu_torch.kernels import edge_max
from mgnns_tpu_torch.models import mgnns as mgnns_model
from mgnns_tpu_torch.models import text_only as text_only_model
from mgnns_tpu_torch.models.mgnns import mgnns_init
from mgnns_tpu_torch.models.text_only import text_model_init
from mgnns_tpu_torch.serving import Predictor
from tests.torch_train_common import CPU

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = ["the cat sat on the mat", "a dog met a cat", "the mat sat still",
          "dogs and cats and logs"]
LABELS = {f"l{i}": i for i in range(7)}
GRAPH_CFG = dict(ngram=2, max_len=10)
RECORDS = [{"id": f"r{i}", "text": t, "image": f"img/{i}.jpg"} for i, t in enumerate(
    CORPUS + ["the cat met a dog", "", "logs and mats sat", "unseen words only", "cat"])]
ARTIFACT_FILES = {"model.pt2", "params.npz", "params_tree.json", "preproc.npz",
                  "preproc.json", "meta.json"}


def _max_diff(got, want):
    assert [g["label"] for g in got] == [w["label"] for w in want]
    return max(abs(g["probs"][k] - w["probs"][k]) for g, w in zip(got, want) for k in w["probs"])


@pytest.fixture(scope="module")
def text_side():
    vocab = build_vocab(CORPUS, 1)
    return vocab, cal_pmi(CORPUS, vocab, GRAPH_CFG["ngram"] + 1, 1, max_len=GRAPH_CFG["max_len"])


def _text_predictor(text_side, seed=0, max_batch=4):
    vocab, graph = text_side
    params = text_model_init(len(vocab), len(LABELS), graph.num_edges, seed=seed, device=CPU)
    return Predictor(vocab=vocab, graph=graph, graph_cfg=TextGraphConfig(**GRAPH_CFG),
                     label_map=LABELS, params=params, text_only=True, max_batch=max_batch,
                     device=CPU)


def _fusion_predictor(text_side, compute_dtype="float32"):
    """The fusion model at 32 px (full-depth trunks), 5 / 6 label classes,
    L=10, ngram 2, random weights from a seed; max_batch 4."""
    vocab, graph = text_side
    r = np.random.default_rng(0)
    cfg = ModelConfig(vocab_size=len(vocab), edges_num=graph.num_edges, image_size=32,
                      object_num_classes=5, place_num_classes=6, compute_dtype=compute_dtype)
    oA, _ = gen_A(5, 0.4, {"nums": r.integers(1, 5, 5).astype(float),
                           "adj": r.integers(0, 4, (5, 5)).astype(float)})
    pA, _ = gen_A(6, 0.3, {"nums": r.integers(1, 5, 6).astype(float),
                           "adj": r.integers(0, 4, (6, 6)).astype(float)})
    params, stats, consts = mgnns_init(
        cfg, num_edges=graph.num_edges, label_embedding=r.standard_normal((7, 300)),
        object_A=oA, place_A=pA, object_inp=r.standard_normal((5, 300)),
        place_inp=r.standard_normal((6, 300)), device=CPU)
    return Predictor(vocab=vocab, graph=graph, graph_cfg=TextGraphConfig(**GRAPH_CFG),
                     label_map=LABELS, params=params, batch_stats=stats, consts=consts, cfg=cfg,
                     image_backend="synthetic", strict_images=False, max_batch=4, device=CPU)


@pytest.fixture(scope="module")
def artifacts(text_side, tmp_path_factory):
    """The text-only and the fusion Predictor, each exported once: (live
    Predictor, artifact directory, the saved program)."""
    tmp = tmp_path_factory.mktemp("export")
    out = {}
    for kind, make in (("text_only", _text_predictor), ("fusion", _fusion_predictor)):
        pred = make(text_side)
        out[kind] = (pred, str(tmp / kind), export.export_predictor(pred, str(tmp / kind)))
    yield out
    for pred, _, _ in out.values():
        pred.close()


# ------------------------------------------------------------- the operators


def _op_inputs(ngram, seed=0):
    """Three documents, the first empty, the last full, ties and negative
    weights; the gradient of the output."""
    r = np.random.default_rng(seed)
    B, L, D = 3, 9, 5
    emb = r.standard_normal((B, L, D)).astype(np.float32)
    w = r.standard_normal((B, L, 2 * ngram + 1)).astype(np.float32)
    emb[:, 2] = emb[:, 0]
    lens = np.array([0, 4, L], np.int32)
    g = r.standard_normal((B, L, D)).astype(np.float32)
    return [torch.from_numpy(a) for a in (emb, w, lens, g)]


@pytest.mark.parametrize("ngram", [0, 1, 4])
@pytest.mark.parametrize("op", ["edge_max_forward", "edge_max_backward"])
def test_opcheck(op, ngram):
    """``torch.library.opcheck`` (schema, fake tensors, autograd
    registration, AOT dispatch) on each operator at g = 0, 1, 4, with an
    empty document; the forward also with inputs that require gradients."""
    emb, w, lens, g = _op_inputs(ngram)
    if op == "edge_max_forward":
        torch.library.opcheck(torch.ops.mgnns.edge_max_forward.default, (emb, w, lens, ngram))
        torch.library.opcheck(torch.ops.mgnns.edge_max_forward.default,
                              (emb.requires_grad_(), w.requires_grad_(), lens, ngram))
    else:
        torch.library.opcheck(torch.ops.mgnns.edge_max_backward.default, (emb, w, lens, g, ngram))


@pytest.mark.parametrize("ngram", [0, 2])
def test_operators_are_the_plain_versions_on_the_cpu(ngram):
    """On CPU tensors the forward operator is the plain K1 and its autograd
    formula the plain K2, bit for bit."""
    emb, w, lens, g = _op_inputs(ngram, seed=1)
    emb.requires_grad_()
    w.requires_grad_()
    out = edge_max.window_max_aggregate(emb, w, lens, ngram)
    torch.testing.assert_close(out, edge_max.window_max_aggregate_plain(emb, w, lens, ngram),
                               rtol=0, atol=0)
    d_emb, d_w = torch.autograd.grad(out, (emb, w), g)
    want_e, want_w = edge_max.window_max_aggregate_backward_plain(
        emb.detach(), w.detach(), lens, g, ngram)
    torch.testing.assert_close(d_emb, want_e, rtol=0, atol=0)
    torch.testing.assert_close(d_w, want_w, rtol=0, atol=0)


def test_operators_refuse_other_backends():
    """Only the CPU, CUDA and fake registrations exist: a sparse tensor
    reaches none of them, and the checked entry refuses a device that is
    neither CPU nor CUDA."""
    emb, w, lens, _ = _op_inputs(1)
    with pytest.raises(NotImplementedError, match="SparseCPU"):
        torch.ops.mgnns.edge_max_forward(emb.to_sparse(), w, lens, 1)
    with pytest.raises(ValueError, match="cuda or cpu"):
        edge_max.window_max_aggregate(emb.to("meta"), w.to("meta"), lens.to("meta"), 1)


# ------------------------------------------------------------------- trees


def test_tree_flatten_round_trips_in_the_jax_format():
    tree = {"a": {"w": np.arange(6.0).reshape(2, 3), "b": np.zeros(3)},
            "layers": [{"k": np.ones(2)}, {"k": np.full(2, 7.0), "extra": (np.array(1.0),)}],
            "z": np.array(5, np.int32), "empty": {}}
    paths, leaves = export._flatten_with_paths(tree)
    assert json.dumps(paths) == json.dumps(j_flatten_with_paths(tree)[0])
    rebuilt = export._unflatten_from_paths(json.loads(json.dumps(paths)), leaves)
    assert list(rebuilt) == ["a", "layers", "z"]  # sorted; the empty dict is gone
    assert rebuilt["layers"][1]["extra"] == [np.array(1.0)]
    for a, b in zip(export._flatten_with_paths(rebuilt)[1], leaves):
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------------ export


@pytest.mark.parametrize("kind", ["text_only", "fusion"])
def test_exported_graph_calls_k1_once(artifacts, kind):
    ep = artifacts[kind][2]
    targets = [str(n.target) for n in ep.graph.nodes if n.op == "call_function"]
    assert targets.count("mgnns.edge_max_forward.default") == 1
    assert not any("edge_max_backward" in t for t in targets)


@pytest.mark.parametrize("kind", ["text_only", "fusion"])
def test_load_exported_serves_the_live_answers_without_the_model(artifacts, kind, monkeypatch):
    """The loaded artifact answers 9 records in 3 chunks as the live
    Predictor does (within 1e-5), with the model's apply functions made to
    raise: the program runs, not the model code.  K1 runs once a chunk."""
    live, path, _ = artifacts[kind]
    want = live.predict(RECORDS)
    pred = export.load_exported(path, strict_images=False, device=CPU)

    def boom(*a, **k):
        raise AssertionError("model code called")

    for mod, name in ((serving, "mgnns_apply"), (serving, "text_model_apply"),
                      (serving, "eval_probs"), (mgnns_model, "mgnns_apply"),
                      (text_only_model, "text_model_apply")):
        monkeypatch.setattr(mod, name, boom)
    calls = []
    plain = edge_max.window_max_aggregate_plain
    monkeypatch.setattr(edge_max, "window_max_aggregate_plain",
                        lambda *a: calls.append(1) or plain(*a))
    got = pred.predict(RECORDS)
    pred.close()
    assert _max_diff(got, want) <= 1e-5
    assert len(calls) == 3
    assert pred.batch_buckets == [4] and pred.image_size == live.image_size
    meta = json.load(open(os.path.join(path, "meta.json")))
    assert meta["devices"] == ["cpu", "cuda"] and meta["conv_fp32_precision"] == "ieee"
    assert meta["max_batch"] == 4 and meta["text_only"] is (kind == "text_only")
    assert set(os.listdir(path)) == ARTIFACT_FILES


def test_bf16_trunks_export_and_load(text_side, artifacts, tmp_path):
    """bf16 trunks: the loaded artifact gives the live bf16 answers, and both
    lie within the bf16 bound of tests/test_torch_precision.py (4e-2) of the
    float32 model's."""
    live = _fusion_predictor(text_side, compute_dtype="bfloat16")
    export.export_predictor(live, str(tmp_path / "bf16"))
    assert json.load(open(tmp_path / "bf16" / "meta.json"))["compute_dtype"] == "bfloat16"
    pred = export.load_exported(str(tmp_path / "bf16"), device=CPU)
    want = live.predict(RECORDS)
    got = pred.predict(RECORDS)
    f32 = artifacts["fusion"][0].predict(RECORDS)
    live.close()
    pred.close()
    assert _max_diff(got, want) <= 1e-5
    assert max(abs(a["probs"][k] - b["probs"][k])
               for a, b in zip(got, f32) for k in b["probs"]) <= 4e-2


def test_text_only_artifact_matches_the_jax_artifact(tmp_path):
    """The same text-only weights (the JAX initializer's, carried across by
    ``convert``) exported by both packages and loaded again on the CPU: the
    answers agree within 1e-5 and the ``params_tree.json`` files are equal."""
    jvocab = build_vocab(CORPUS, 1)
    jgraph = j_cal_pmi(CORPUS, jvocab, 3, 1, max_len=10)
    jparams = j_text_model_init(jax.random.key(3), len(jvocab), len(LABELS), jgraph.num_edges)
    common = dict(vocab=jvocab, label_map=LABELS, max_batch=4, text_only=True)
    jpred = JPredictor(graph=jgraph, graph_cfg=JTextGraphConfig(**GRAPH_CFG),
                       apply_fn=lambda p, bs, b: j_text_model_apply(p, b, ngram=2),
                       params=jparams, batch_stats={}, **common)
    j_export_predictor(jpred, str(tmp_path / "jax"), platforms=("cpu",))
    want = j_load_exported(str(tmp_path / "jax")).predict(RECORDS)

    pred = Predictor(graph=PmiGraph(jgraph.vocab_size, jgraph.keys, jgraph.pmi),
                     graph_cfg=TextGraphConfig(**GRAPH_CFG),
                     params=convert.text_model_from_jax_params(
                         jax.tree.map(np.asarray, jparams), device=CPU),
                     device=CPU, **common)
    export.export_predictor(pred, str(tmp_path / "port"))
    loaded = export.load_exported(str(tmp_path / "port"), device=CPU)
    got = loaded.predict(RECORDS)
    pred.close()
    loaded.close()
    assert _max_diff(got, want) <= 1e-5
    for name in ("params_tree.json", "preproc.json"):
        assert (tmp_path / "port" / name).read_text() == (tmp_path / "jax" / name).read_text()


def test_load_exported_refuses_a_jax_artifact(tmp_path):
    (tmp_path / "model.jaxexport").write_bytes(b"\0")
    with pytest.raises(FileNotFoundError, match="model.jaxexport.*JAX package"):
        export.load_exported(str(tmp_path), device=CPU)
    with pytest.raises(FileNotFoundError, match="model.pt2"):
        export.load_exported(str(tmp_path / "missing"), device=CPU)


def test_export_of_a_loaded_program_raises(artifacts, tmp_path):
    pred = export.load_exported(artifacts["text_only"][1], device=CPU)
    with pytest.raises(ValueError, match="loaded program"):
        export.export_predictor(pred, str(tmp_path / "again"))
    pred.close()


# --------------------------------------------------------------------- CLIs


@pytest.fixture(scope="module")
def text_ckpt(text_side, tmp_path_factory):
    """A text-only checkpoint directory with its preproc files, as the
    training CLI writes it."""
    vocab, graph = text_side
    ckpt = tmp_path_factory.mktemp("ckpt") / "mgnns_tpu"
    params = text_model_init(len(vocab), len(LABELS), graph.num_edges, seed=5, device=CPU)
    Checkpointer(str(ckpt)).save(1, {"params": params, "batch_stats": {}})
    serving.save_preproc(str(ckpt), vocab, graph, LABELS, TextGraphConfig(**GRAPH_CFG))
    return str(ckpt)


def test_predict_cli_export_model_writes_the_artifact(text_ckpt, tmp_path, capsys):
    """--export_model without --input writes the artifact and stops; with
    --input it also predicts."""
    art = tmp_path / "art"
    ppredict.main(["--platform", "cpu", "--data_root_path", str(tmp_path), "--checkpoint",
                   text_ckpt, "--text_only", "--max_batch", "4", "--export_model", str(art)])
    assert set(os.listdir(art)) == ARTIFACT_FILES
    assert f"exported serving artifact to {art}" in capsys.readouterr().out
    meta = json.load(open(art / "meta.json"))
    assert meta["max_batch"] == 4 and meta["text_only"] is True
    assert meta["batch_template"]["eids"] == [[4, 10, 5], "int32"]
    with pytest.raises(SystemExit, match="--input is required"):
        ppredict.main(["--platform", "cpu", "--from_exported", str(art)])
    with pytest.raises(SystemExit, match="need the live model.*single-device program"):
        ppredict.main(["--platform", "cpu", "--from_exported", str(art), "--input", "x",
                       "--mesh_data", "2"])


def test_predict_cli_from_exported_in_a_fresh_process(artifacts, text_ckpt, tmp_path):
    """``cli.predict --from_exported --platform cpu`` in a new interpreter
    where JAX cannot be imported and the model's apply functions raise: the
    fusion artifact's answers equal the live model's within 1e-5, and a
    text-only artifact written by ``--export_model`` answers as its
    checkpoint does."""
    src = tmp_path / "in.jsonl"
    src.write_text("".join(json.dumps(r) + "\n" for r in RECORDS))
    art = tmp_path / "text"
    ppredict.main(["--platform", "cpu", "--data_root_path", str(tmp_path), "--checkpoint",
                   text_ckpt, "--text_only", "--max_batch", "4", "--export_model", str(art)])
    ckpt_pred = Predictor.from_engine_artifacts(str(tmp_path), text_ckpt, text_only=True,
                                                max_batch=4, device=CPU)
    cases = {"fusion": (artifacts["fusion"][1], artifacts["fusion"][0].predict(RECORDS)),
             "text_only": (str(art), ckpt_pred.predict(RECORDS))}
    ckpt_pred.close()
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import torch\n"
        "torch.set_num_threads(2)\n"
        "from mgnns_tpu_torch import serving\n"
        "from mgnns_tpu_torch.models import mgnns, text_only\n"
        "def boom(*a, **k): raise AssertionError('model code called')\n"
        "serving.eval_probs = mgnns.mgnns_apply = text_only.text_model_apply = boom\n"
        "from mgnns_tpu_torch.cli import predict\n"
        "predict.main(sys.argv[1:])\n")
    for kind, (path, want) in cases.items():
        out = tmp_path / f"{kind}.jsonl"
        r = subprocess.run(
            [sys.executable, "-c", code, "--from_exported", path, "--platform", "cpu",
             "--image_backend", "synthetic", "--input", str(src), "--output", str(out)],
            cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True, text=True,
            timeout=300)
        assert r.returncode == 0, r.stderr[-3000:]
        got = [json.loads(line) for line in out.read_text().splitlines()]
        assert [g["id"] for g in got] == [rec["id"] for rec in RECORDS]
        assert _max_diff(got, want) <= 1e-5, kind


def test_serve_cli_from_exported_over_loopback(artifacts):
    """``cli.serve --from_exported`` answers /predict with the live answers
    and names the artifact in /healthz."""
    live, path, _ = artifacts["text_only"]
    args = pserve.build_parser().parse_args(["--platform", "cpu", "--from_exported", path,
                                             "--port", "0"])
    srv = pserve.make_server(args)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    host, port = srv.server_address[:2]
    try:
        req = urllib.request.Request(f"http://{host}:{port}/predict",
                                     data=json.dumps({"records": RECORDS[:6]}).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            got = json.loads(r.read())["predictions"]
        with urllib.request.urlopen(f"http://{host}:{port}/healthz", timeout=60) as r:
            health = json.loads(r.read())
    finally:
        srv.shutdown()
        srv.server_close()
        srv.frontend.predictor.close()
        thread.join(10)
    assert _max_diff(got, live.predict(RECORDS[:6])) <= 1e-5
    assert health["model"] == path and health["requests"] == 1 and health["text_only"] is True
