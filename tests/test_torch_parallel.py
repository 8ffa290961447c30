"""The port's data axis (``mgnns_tpu_torch.parallel``) on the CPU: 2 gloo
ranks in 2 processes (tests/torch_parallel_worker.py) against one rank of
the global batch, and the plan arithmetic against the JAX package's.

- ``parallel.input`` / ``parallel.multihost`` against ``mgnns_tpu.parallel``
  on fake device grids of several hosts (the JAX process functions
  monkeypatched, as tests/test_multihost.py does);
- the data-axis BatchNorm of 2 ranks against ``bn`` on the concatenated
  batch (output, running statistics, gradients of x, scale and bias),
  float32 and bf16, and at world 1 against ``F.batch_norm``;
- the toy fusion model (32 px, full-depth trunks, the label graphs and
  text of tests/torch_train_common.py's toy) trained 3 steps on 2 ranks at
  dropout 0.5 with Adam, and an eval epoch, against the port's 1-rank run
  of the same global batches, also on an uneven split (13 records); its
  global gradient at dropout 0 against the JAX package's single-device
  gradient of the global batch, from the same weights;
- the training CLI on 2 ranks (``--mesh_data 2``) against the 1-rank CLI,
  text-only and fusion; the checkpoint-directory probe; the flags that
  still raise.

Each spawn has a hard timeout; a hung collective fails the test.
"""

import json
import os
import socket
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mgnns_tpu.config import ModelConfig as JModelConfig
from mgnns_tpu.engine.train import cross_entropy as j_cross_entropy
from mgnns_tpu.graphs.cooccur import gen_A
from mgnns_tpu.graphs.pmi import cal_pmi, doc_window_edge_ids
from mgnns_tpu.graphs.vocab import build_vocab
from mgnns_tpu.models import mgnns_apply as j_mgnns_apply
from mgnns_tpu.parallel import input as jinput
from mgnns_tpu.parallel import multihost as jmultihost

from mgnns_tpu_torch import convert
from mgnns_tpu_torch.cli import main as pmain
from mgnns_tpu_torch.nn.resnet import bn
from mgnns_tpu_torch.parallel import input as pinput
from mgnns_tpu_torch.parallel import multihost as pmultihost
from mgnns_tpu_torch.utils import tree_leaves, tree_unflatten
from tests import torch_parallel_worker as W
from tests.test_mvsa import _make_mvsa_tree
from tests.test_torch_cli import _fusion_tree
from tests.torch_train_common import few_torch_threads  # noqa: F401  (autouse fixture)
from tests.torch_train_common import (
    AUX_W, CORPUS, CPU, compare_trees, frobenius_errors, np_tree,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMAGE = 64  # px of the toy fusion model's images
BF16_ULP = 2.0 ** -7  # one bf16 rounding step of the largest element, relative to it


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start(scenario: str, directory, n: int = 2, hosts: int = 1) -> list[subprocess.Popen]:
    """Start ``n`` ranks of the worker over ``hosts`` nodes, as torchrun
    would; the parent works on meanwhile and collects them with
    :func:`_finish`."""
    port = _free_port()
    local = n // hosts
    procs = []
    for r in range(n):
        env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(r),
                   WORLD_SIZE=str(n), LOCAL_RANK=str(r % local), LOCAL_WORLD_SIZE=str(local),
                   PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
        procs.append(subprocess.Popen([sys.executable, W.__file__, scenario, str(directory)],
                                      env=env, cwd=ROOT, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    return procs


def _finish(procs: list[subprocess.Popen], scenario: str, directory,
            timeout: float = 300) -> list[dict]:
    """Wait for the ranks (killing them all past ``timeout`` seconds); their
    results."""
    n = len(procs)
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    except subprocess.TimeoutExpired:
        pytest.fail(f"{scenario}: a rank did not finish in {timeout} s (a hung collective?)")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"{scenario} rank failed:\n{log[-4000:]}"
    return [torch.load(os.path.join(directory, f"{scenario}_rank{r}.pt"), weights_only=False)
            for r in range(n)]


# ------------------------------------------------------------ plan arithmetic


def _fake_mesh(D: int, nproc: int):
    """A ('data', 'model') mesh of D positions over ``nproc`` hosts as the
    JAX plan reads it: the device grid and each device's process index."""
    devs = np.array([types.SimpleNamespace(process_index=d // (D // nproc)) for d in range(D)],
                    dtype=object).reshape(D, 1)
    return types.SimpleNamespace(axis_names=("data", "model"), shape={"data": D, "model": 1},
                                 devices=devs)


# (D, hosts, global records, global batch)
PLAN_CASES = [(2, 1, 24, 8), (2, 1, 13, 8), (4, 1, 37, 8), (4, 2, 37, 8), (4, 4, 103, 16),
              (2, 2, 9, 4), (4, 2, 5, 8)]


@pytest.mark.parametrize("D,hosts,n,B", PLAN_CASES,
                         ids=[f"D{c[0]}-hosts{c[1]}-n{c[2]}-B{c[3]}" for c in PLAN_CASES])
def test_plan_arithmetic_equals_jax(monkeypatch, D, hosts, n, B):
    """Every host's input plan, epoch matrices (shuffle off and on, two
    epochs), weight sums, record slice and epoch length equal the JAX
    package's, so that global batch b holds the same records in both."""
    for host in range(hosts):
        monkeypatch.setattr(jmultihost.jax, "process_count", lambda: hosts)
        monkeypatch.setattr(jmultihost.jax, "process_index", lambda: host)
        monkeypatch.setattr(jinput.jax, "process_count", lambda: hosts)
        monkeypatch.setattr(jinput.jax, "process_index", lambda: host)
        monkeypatch.setattr(pmultihost, "process_count", lambda: hosts)
        monkeypatch.setattr(pmultihost, "process_index", lambda: host)
        start, stop, phb = jmultihost.process_batch_slice(n, B)
        assert pmultihost.process_batch_slice(n, B) == (start, stop, phb)
        assert pmultihost.epoch_num_batches(n, B) == jmultihost.epoch_num_batches(n, B)
        jp = jinput.make_input_plan(_fake_mesh(D, hosts), stop - start, phb, n_global=n)
        pp = pinput.make_input_plan(D, stop - start, phb, n_global=n, process_index=host,
                                    process_count=hosts)
        for k in ("D", "S", "Bd", "num_batches", "n_global", "batch_size", "table_rows"):
            assert getattr(pp, k) == getattr(jp, k), k
        for k in ("position_valid", "local_positions", "local_rows"):
            np.testing.assert_array_equal(getattr(pp, k), getattr(jp, k), err_msg=k)
        np.testing.assert_array_equal(pp.batch_weight_sums(), jp.batch_weight_sums())
        np.testing.assert_array_equal(pp.local_table_rows(), jp.local_table_rows())
        for shuffle in (False, True):
            for epoch in (0, 1):
                for a, b in zip(pinput.epoch_index_plan(pp, epoch, 4, shuffle),
                                jinput.epoch_index_plan(jp, epoch, 4, shuffle)):
                    assert a.dtype == b.dtype
                    np.testing.assert_array_equal(a, b)


def test_rank_views_of_a_plan_cover_the_global_batches():
    """One host, 2 ranks, 13 records: each rank's tables and columns come
    from the host plan, and the ranks' blocks of every global batch are its
    records, each once, with the global weight sums on both ranks."""
    plans = [pinput.make_input_plan(2, 13, 8, position=p, process_index=0, process_count=1)
             for p in (0, 1)]
    assert [p.slot for p in plans] == [0, 1] and plans[0].num_batches == 2
    np.testing.assert_array_equal(plans[1].rank_table_rows(), [1, 3, 5, 7, 9, 11, 0])
    seen = []
    for p in plans:
        idx, wt, rows = (p.rank_columns(a) for a in pinput.epoch_index_plan(p, 0, 3, True))
        assert idx.shape == (2, 4)
        np.testing.assert_array_equal(p.rank_table_rows()[idx], rows)
        seen += rows[wt > 0].tolist()
    assert sorted(seen) == list(range(13))
    np.testing.assert_array_equal(plans[0].batch_weight_sums(), [8, 5])
    with pytest.raises(ValueError, match="not one of this host's positions"):
        pinput.make_input_plan(4, 5, 4, n_global=10, position=3, process_index=0,
                               process_count=2)


# ----------------------------------------------------------- 2 ranks vs 1


def _records(toy, n: int) -> dict:
    """``n`` seeded records over the toy vocabulary and graph (L=10,
    ngram 2) with 32 px uint8 images and labels."""
    r = np.random.default_rng(1)
    L, V = 10, len(toy["vocab"])
    lens = r.integers(2, L + 1, n).astype(np.int32)
    ids = np.zeros((n, L), np.int32)
    for i, k in enumerate(lens):
        ids[i, :k] = r.integers(1, V, k)
    return {"ids": ids, "lens": lens,
            "mask": (np.arange(L)[None] < lens[:, None]).astype(np.float32),
            "eids": doc_window_edge_ids(ids, lens, 2, toy["graph"]),
            "label": r.integers(0, 7, n).astype(np.int32),
            "image": r.integers(0, 256, (n, IMAGE, IMAGE, 3)).astype(np.uint8)}


def _trunk_to_jax(tree: dict) -> dict:
    """A port trunk tree (parameters or statistics) in the JAX package's
    layout: OIHW convs as HWIO ``{"w"}``, each stage's blocks as ``first``
    and the stacked ``rest`` (the inverse of ``convert.resnet_from_jax``)."""
    def node(name, v):
        if "conv" in name:
            return {"w": v.numpy().transpose(2, 3, 1, 0)}
        return {k: t.numpy() for k, t in v.items()}

    def block(b):
        return {name: node(name, v) for name, v in b.items()}

    out = {name: node(name, v) for name, v in tree.items() if not name.startswith("layer")}
    for li in range(1, 5):
        blocks = [block(b) for b in tree[f"layer{li}"]]
        out[f"layer{li}"] = {"first": blocks[0],
                             "rest": jax.tree.map(lambda *xs: np.stack(xs), *blocks[1:])}
    return out


@pytest.fixture(scope="module")
def toy():
    """The toy fusion model of tests/torch_train_common.build_toy (its
    vocabulary, PMI graph, 5/6-class label graphs, L=10, ngram 2) at 32 px,
    drawn by the port's ``mgnns_init``, with the same weights in the JAX
    package's layout, and a 4-record batch whose last row is padding."""
    vocab = build_vocab(CORPUS, 1)
    graph = cal_pmi(CORPUS, vocab, 3, 1, max_len=10)
    r = np.random.default_rng(0)
    adj = {c: gen_A(c, t, {"nums": r.integers(1, 5, c).astype(float),
                           "adj": r.integers(0, 4, (c, c)).astype(float)})[0]
           for c, t in ((5, 0.4), (6, 0.3))}
    kw = dict(vocab_size=len(vocab), edges_num=graph.num_edges, image_size=IMAGE,
              object_num_classes=5, place_num_classes=6, dropout=0.0, text_dropout=0.0,
              is_regu=True)
    inputs = dict(label_embedding=r.standard_normal((7, 300)).astype(np.float32),
                  object_A=adj[5], place_A=adj[6],
                  object_inp=r.standard_normal((5, 300)).astype(np.float32),
                  place_inp=r.standard_normal((6, 300)).astype(np.float32))
    toy = dict(kw=kw, inputs=inputs, vocab=vocab, graph=graph)
    _, params, stats, consts = W.toy_model(toy)
    toy.update(params=params, stats=stats, consts=consts)
    batch = _records(toy, 4)
    batch["weight"] = np.array([1, 1, 1, 0], np.float32)
    trunks = ("object_trunk", "place_trunk")
    jparams = {k: jax.tree.map(lambda t: t.numpy(), v) for k, v in params.items()
               if k not in trunks}
    jparams.update({k: _trunk_to_jax(params[k]) for k in trunks})
    toy.update(batch=batch, jparams=jparams,
               jstate={k: _trunk_to_jax(stats[k]) for k in trunks},
               jconsts={"label_query": consts["label_query"].numpy()})
    return toy


@pytest.fixture(scope="module")
def core(toy, tmp_path_factory):
    """The ``core`` scenario on 2 ranks of one host."""
    d = tmp_path_factory.mktemp("core")
    torch.save({"kw": toy["kw"], "inputs": toy["inputs"], "batch": toy["batch"],
                "records": _records(toy, max(n for n, _ in W.SPLITS.values()))},
               d / "toy.pt")
    procs = _start("core", d)
    try:
        jax_step = _jax_step(toy)  # while the ranks run
    finally:
        ranks = _finish(procs, "core", d)
    grads = torch.load(d / "grad.pt", weights_only=False)
    os.remove(d / "grad.pt")  # 70M floats: not kept past the fixture
    return ranks, grads, jax_step


def test_ranks_see_one_host_and_agree(core):
    """Both ranks report one host, and after every run hold the same
    losses and the same state (the global gradient's checksum, the
    parameters, statistics and optimizer state)."""
    a, b = core[0]
    assert (a["rank"], b["rank"]) == (0, 1)
    assert a["hosts"] == b["hosts"] == 1 and a["host"] == b["host"] == 0
    assert a["grad"]["checksum"] == b["grad"]["checksum"]
    for name in W.SPLITS:
        assert a[name]["losses"] == b[name]["losses"]
        assert a[name]["checksum"] == b[name]["checksum"]


def _bn_reference(dtype):
    """``bn`` without an axis on the global batch: y, dx, dscale, dbias and
    the new statistics."""
    r = np.random.default_rng(7)
    B = W.GLOBAL_BATCH
    x = torch.from_numpy(r.standard_normal((B, 6, 5, 5)).astype(np.float32) * 3 + 1)
    g = torch.from_numpy(r.standard_normal((B, 6, 5, 5)).astype(np.float32))
    p = {"scale": torch.from_numpy(r.uniform(0.5, 1.5, 6).astype(np.float32)).requires_grad_(),
         "bias": torch.from_numpy(r.standard_normal(6).astype(np.float32)).requires_grad_()}
    s = {"mean": torch.zeros(6), "var": torch.ones(6)}
    xd = x.to(dtype).contiguous(memory_format=torch.channels_last).requires_grad_()
    y, new = bn(p, s, xd, train=True)
    (y.float() * g).sum().backward()
    return {"y": y.detach().float(), "dx": xd.grad.float(), "dscale": p["scale"].grad,
            "dbias": p["bias"].grad, "mean": new["mean"], "var": new["var"]}


def _rel(got, want) -> float:
    return float((got - want).abs().max() / max(float(want.abs().max()), 1e-12))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bf16"])
def test_data_axis_batch_norm_equals_batch_norm_of_the_global_batch(core, dtype):
    """2 ranks' BatchNorm equals ``bn`` on the concatenated batch: the
    float32 statistics within 1e-6 of scale; y, dx and the scale and bias
    gradients within 1e-6 at float32 and one bf16 step at bf16 (each side
    rounds its float32 y and dx once, and the CPU's ``F.batch_norm`` returns
    bf16-rounded scale and bias gradients for a bf16 input).  At world 1
    the data-axis function equals ``F.batch_norm`` to the same bounds."""
    want = _bn_reference(dtype)
    got = [r["bn"][str(dtype)] for r in core[0]]
    out_tol = 1e-6 if dtype == torch.float32 else BF16_ULP
    for key in ("y", "dx"):
        assert _rel(torch.cat([g[key] for g in got]), want[key]) <= out_tol, key
    for key, tol in (("dscale", out_tol), ("dbias", out_tol), ("mean", 1e-6), ("var", 1e-6)):
        for g in got:
            assert _rel(g[key], want[key]) <= tol, key
    for g in got:
        assert g["world1_err"] <= out_tol


@pytest.mark.parametrize("name", list(W.SPLITS), ids=["even-24-tables", "uneven-13-streamed"])
def test_two_ranks_train_and_evaluate_as_one_rank_of_the_global_batch(core, name):
    """3 (even, through device tables and the plan path) or 2 (uneven 7 + 6
    records, streamed, with padding rows) Adam steps at dropout 0.5 and an
    eval epoch, against the port's 1-rank run of the same global batches
    whose BatchNorm runs the same per-layer arithmetic (see
    ``torch_parallel_worker._SameArithmetic``): step and eval losses within
    1e-5 relative, the eval confusion matrix and every record's prediction
    equal, the BatchNorm statistics within 1e-4 of each leaf's scale.

    Parameters and Adam moments are held to the bounds with which
    tests/test_torch_train_models.py holds the port's train-mode gradients
    to the JAX package's: 5e-3 of scale outside the trunks, trunk leaves
    Frobenius-relative 0.15.  Two float32 runs of this 64 px toy part by
    that much whatever the data axis does: a ReLU at a kink flips one of a
    2x2 map's 32 positions of a batch, and moves a trunk gradient by
    percents (so does the 1-rank run with ``F.batch_norm`` in place of the
    same arithmetic, at a few layers by far more)."""
    ranks = core[0]
    rank = [r["reference"]["name"] for r in ranks].index(name)
    got, want = ranks[rank][name], ranks[rank]["reference"]
    assert got["num_batches"] == len(want["losses"]) == (3 if name == "even" else 2)
    assert got["fused"] == (name == "even")
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5, atol=0)
    assert got["eval_loss"] == pytest.approx(want["eval_loss"], rel=1e-5)
    np.testing.assert_array_equal(got["confusion"], want["confusion"])
    merged = {**ranks[0][name]["preds"], **ranks[1][name]["preds"]}
    assert merged == want["preds"] and len(merged) == W.SPLITS[name][0]
    errs = want["errors"]
    assert errs["stats"]["trunk_max_rel"] <= 1e-4, errs["stats"]
    for key in ("params", "mu", "nu"):
        assert errs[key]["other_max_rel"] <= 5e-3, (key, errs[key])
        assert errs[key]["trunk_frobenius"] <= 0.15, (key, errs[key])


def _jax_step(f: dict):
    """(loss, new statistics, gradients) of the JAX package's single-device
    train step on the toy batch, at dropout 0."""
    full = {k: jnp.asarray(v) for k, v in f["batch"].items() if k not in ("label", "weight")}
    full["object_inp"] = jnp.asarray(f["consts"]["object_inp"].numpy())
    full["place_inp"] = jnp.asarray(f["consts"]["place_inp"].numpy())
    jcfg = JModelConfig(**f["kw"])

    def jloss(p):
        logits, new_state, aux = j_mgnns_apply(p, f["jstate"], f["jconsts"], full, cfg=jcfg,
                                               train=True, rng=jax.random.key(0))
        loss = j_cross_entropy(logits, jnp.asarray(f["batch"]["label"]),
                               jnp.asarray(f["batch"]["weight"]))
        return loss + AUX_W * aux["head_diversity"], new_state

    (jl, jstate), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(f["jparams"])
    return float(jl), np_tree(jstate), np_tree(jgrads)


def _like(tree, like):
    """``tree`` with the dict key order of ``like``, recursively."""
    if isinstance(like, dict):
        return {k: _like(tree[k], v) for k, v in like.items()}
    if isinstance(like, list):
        return [_like(t, v) for t, v in zip(tree, like)]
    return tree


def test_two_ranks_match_the_jax_single_device_step_at_dropout_0(core, toy):
    """The global gradient of 2 ranks (each 2 of the toy batch's 4 rows, one
    a padding row) against the JAX package's single-device gradient of the
    whole batch, with tests/test_torch_train_models.py's train-mode bounds:
    the loss within 5e-4, the non-trunk leaves within 5e-3 of scale, the
    trunk leaves Frobenius-relative 0.15, the new statistics 1e-3."""
    f = toy
    ranks, rank0_grads, (jl, jstate, jgrads) = core
    got = ranks[0]["grad"]
    assert abs(got["loss"] - float(jl)) <= 5e-4 * abs(float(jl))
    # JAX sorts dict keys: put its trees in the port's key order
    want = _like(convert.params_from_jax(np_tree(jgrads), device=CPU), f["params"])
    grads = tree_unflatten(f["params"], [torch.zeros_like(p) if g is None else g
                                         for p, g in zip(tree_leaves(f["params"]), rank0_grads)])
    trunks = ("object_trunk", "place_trunk")
    compare_trees({k: v for k, v in grads.items() if k not in trunks},
                  {k: v for k, v in want.items() if k not in trunks}, lambda path: 5e-3)
    fro = frobenius_errors({k: grads[k] for k in trunks}, {k: want[k] for k in trunks})
    bad = sorted(((e, p) for p, e in fro.items() if e > 0.15), reverse=True)
    assert not bad, bad[:10]
    want_stats = _like({k: convert.resnet_from_jax(np_tree(jstate[k]), device=CPU)
                        for k in trunks}, f["stats"])
    stats = tree_unflatten(f["stats"], got["stats"])
    compare_trees(stats, want_stats, lambda path: 1e-3)


def test_prediction_gather_and_checkpoint_directory_probe(core, tmp_path):
    """The gather reassembles blocks of 3 and 2 records in rank order on
    both ranks; a checkpoint directory per rank raises on both ranks, a
    shared one passes, and rank 0's save is what every rank restores."""
    blocks = [[list(range(3 * 3))[i * 3:(i + 1) * 3] for i in range(3)],
              [[100 + v for v in list(range(6))[i * 2:(i + 1) * 2]] for i in range(3)]]
    for r in core[0]:
        assert r["gather"] == blocks
        assert r["unshared"] is not None and "not shared" in r["unshared"]
        assert r["restored"] == 0 and r["best"] == 7


# ------------------------------------------------------------------ the CLI


def _cli_args(root, out, text_only: bool) -> list[str]:
    """lr, weight decay and dropout 0 (the JAX package's 2-process CLI test):
    every metric is then an evaluation, the same whatever the composition of
    the batches, so the 1-rank run is the reference; the fusion model's
    trunks are frozen (BatchNorm on running statistics) and its train images
    take the eval transform (an augmentation draws per batch), for the same
    reason."""
    args = ["--platform", "cpu", "--data_root_path", str(root), "--num_labels", "3",
            "--text_min_count", "1", "--lr", "0", "--weight_decay", "0", "--dropout", "0",
            "-e", "-j", "1", "--save_model_path", str(out / "ckpt"),
            "--save_experiment_result_path", str(out / "exp"),
            "--save_pred_result_path", str(out / "pred"),
            "--metrics_path", str(out / "metrics.jsonl")]
    if text_only:
        return args + ["--dataset", "MVSA_simple", "--text_only", "--epochs", "2", "-b", "30",
                       "--device_text"]
    return args + ["--limit_samples", "8", "--epochs", "1", "-b", "4", "--image-size", "32",
                   "--freeze_trunks", "--no_augmentation"]


@pytest.mark.parametrize("text_only,hosts", [(True, 1), (False, 1), (True, 2)],
                         ids=["text_only", "fusion", "text_only-multihost-2-nodes"])
def test_cli_on_two_ranks_equals_the_one_rank_cli(tmp_path, text_only, hosts):
    """``cli.main --mesh_data 2`` on 2 gloo ranks of one node, or with
    ``--multihost`` on 2 nodes of one rank (each reads its own half of
    every split, and global record ids carry its offset): both ranks report
    the 1-rank run's epoch metrics, the test predictions of the two ranks
    together are the 1-rank run's, rank 0 alone writes one prediction file
    that holds every record, row for row the 1-rank file, and one metrics
    file.  The fusion model's train epochs are left out: its text-GCN
    dropout (``ModelConfig.text_dropout``, 0.5) has no flag, and its masks
    follow the composition of the batches."""
    root = tmp_path / "data"
    (_make_mvsa_tree if text_only else _fusion_tree)(root)
    two = tmp_path / "two"
    two.mkdir()
    (two / "cli_args.json").write_text(json.dumps(
        _cli_args(root, two, text_only) + ["--mesh_data", "2"]
        + (["--multihost"] if hosts > 1 else [])))
    procs = _start("cli", two, hosts=hosts)
    try:
        one = pmain.main(_cli_args(root, tmp_path / "one", text_only))  # while the ranks run
    finally:
        a, b = _finish(procs, "cli", two)
    assert a["nodes"] == b["nodes"] == hosts
    assert a["history"] == b["history"]
    for got, want in zip(a["history"], one["history"]):
        for split in ("train", "val") if text_only else ("val",):
            assert got[split]["accuracy"] == want[split]["accuracy"], split
            assert got[split]["loss"] == pytest.approx(want[split]["loss"], rel=1e-5), split
            assert got[split]["fused"] == bool(want[split].get("fused")) == text_only
    assert a["test_accuracy"] == one["test"]["accuracy"]
    assert a["test_loss"] == pytest.approx(one["test"]["loss"], rel=1e-5)
    want_preds = dict(zip(np.asarray(one["test"]["sample_index"]).tolist(),
                          np.asarray(one["test"]["preds"]).tolist()))
    assert {**a["preds"], **b["preds"]} == want_preds
    pred_files = [p for p in (two / "pred").rglob("*.txt")]
    assert len(pred_files) == 1
    want_rows = next((tmp_path / "one" / "pred").rglob("*.txt")).read_text().splitlines()
    assert pred_files[0].read_text().splitlines() == want_rows
    assert len(want_rows) == 1 + (90 if text_only else 8)
    assert len((two / "metrics.jsonl").read_text().splitlines()) == len(one["history"])


def test_cli_flags_that_still_raise():
    """``--mesh_model 2`` names item 6b; ``--mesh_data 2`` in a world of one
    process says how to start the ranks; a batch that does not split over
    the ranks is refused before any work."""
    with pytest.raises(SystemExit, match="ROADMAP.md queue 1 item 6b"):
        pmain.main(["--platform", "cpu", "--mesh_model", "2"])
    with pytest.raises(SystemExit, match="needs a world of 2 ranks.*torch.distributed.run"):
        pmain.main(["--platform", "cpu", "--mesh_data", "2"])
    with pytest.raises(SystemExit, match="must divide by --mesh_data=4"):
        pmain.main(["--platform", "cpu", "--mesh_data", "4", "-b", "6"])
