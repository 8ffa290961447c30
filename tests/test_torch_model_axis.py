"""The port's model axis (``mgnns_tpu_torch.parallel.sharding``, the model
axis's collectives, ``Engine``/``Predictor(mesh=...)`` and the CLIs'
``--mesh_model``) on the CPU: gloo ranks in processes
(tests/torch_model_axis_worker.py) against one rank, and the placements
against the JAX package's.

- placements: every leaf of the toy fusion and text-only trees at model 2
  and 4 (and a width where ``gc1``/``gc2`` fall back) resolves to the JAX
  ``shard_pytree``'s spec and padded shape on the 8-device virtual mesh;
  at model 8 the only difference is the port's head rule;
- 2 ranks on ``(data 1, model 2)`` and 4 on ``(2, 2)``: the forward
  against the 1-rank forward and the JAX package's, 2 train steps and an
  eval epoch against the 1-rank run, replicated leaves bit-equal across the
  ranks, the gather tables' padding rows zero, the checkpoint whole and
  restored at model 1, the reference export unpadded, and a 2x2
  ``Predictor(mesh=...)`` against one device with the ``dsize=2`` ladder;
- ``cli.main --mesh_model 2`` and ``cli.predict --mesh_model 2`` on 2 ranks
  against the 1-rank CLIs.

Each rank set starts once and serves several cases, one thread per rank;
each has a hard timeout.
"""

import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mgnns_tpu import serving as jserving
from mgnns_tpu.config import ModelConfig as JModelConfig
from mgnns_tpu.models import mgnns_apply as j_mgnns_apply
from mgnns_tpu.parallel import sharding as jsharding
from mgnns_tpu.parallel.mesh import create_mesh as j_create_mesh

from mgnns_tpu_torch import serving
from mgnns_tpu_torch.cli import main as pmain
from mgnns_tpu_torch.cli import predict as ppredict
from mgnns_tpu_torch.config import ModelConfig
from mgnns_tpu_torch.models.mgnns import mgnns_init
from mgnns_tpu_torch.models.text_only import text_model_init
from mgnns_tpu_torch.parallel import sharding
from mgnns_tpu_torch.utils import tree_leaves, tree_paths
from tests import torch_model_axis_worker as MW
from tests.test_mvsa import _make_mvsa_tree
from tests.test_torch_parallel import (  # noqa: F401  (toy: a module fixture)
    _cli_args, _finish, _free_port, _records, toy,
)
from tests.torch_train_common import CORPUS

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRUNKS = ("object_trunk", "place_trunk")


def _start(scenario: str, directory, n: int) -> list[subprocess.Popen]:
    """Start ``n`` ranks of the model-axis worker on one node, as torchrun
    would."""
    port = _free_port()
    procs = []
    for r in range(n):
        env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(r),
                   WORLD_SIZE=str(n), LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(n),
                   PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen([sys.executable, MW.__file__, scenario, str(directory)],
                                      env=env, cwd=ROOT, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    return procs


# ----------------------------------------------------------------- placements


def _fusion_tree(over: dict | None = None) -> tuple[dict, ModelConfig]:
    """The toy-width fusion parameters (vocabulary 15, 47 edges), trunks
    left out of the JAX side (no rule reaches them)."""
    cfg = ModelConfig(vocab_size=15, edges_num=47, object_num_classes=5, place_num_classes=6,
                      **(over or {}))
    r = np.random.default_rng(0)
    params, _, _ = mgnns_init(cfg, num_edges=47, label_embedding=r.standard_normal((7, 300)),
                              object_A=np.eye(5), place_A=np.eye(6),
                              object_inp=r.standard_normal((5, 300)),
                              place_inp=r.standard_normal((6, 300)),
                              include_dead_modules=True, device="cpu")
    return params, cfg


def _jax_placements(tree: dict, M: int, rules) -> dict:
    """{path: (spec, padded shape)} of the JAX package's ``shard_pytree`` on
    a ``(1, M)`` mesh of the virtual devices."""
    jtree = jax.tree.map(lambda t: t.numpy(), tree)
    out = jsharding.shard_pytree(jtree, j_create_mesh(data=1, model=M), rules)
    flat, _ = jax.tree_util.tree_flatten_with_path(out)
    return {jsharding._path_str(path): (tuple(leaf.sharding.spec), tuple(leaf.shape))
            for path, leaf in flat}


def _port_placements(tree: dict, M: int, rules, heads=None) -> dict:
    """{path: (spec, padded shape)} of the port's ``shard_tree``, from rank
    0's shards."""
    local, placements = sharding.shard_tree(tree, types.SimpleNamespace(rank=0, size=M), rules,
                                            heads)
    out = {}
    for path, t in zip(tree_paths(local), tree_leaves(local)):
        pl = placements[path.lstrip("/")]
        shape = list(t.shape)
        if pl.dim is not None:
            shape[pl.dim] *= M
        out[path.lstrip("/")] = (pl.spec, tuple(shape))
    return out


PLACEMENT_CASES = [("fusion", 2, None), ("fusion", 4, None), ("text_only", 2, None),
                   ("text_only", 4, None), ("fusion", 4, {"gcn_hidden": 1022})]


@pytest.mark.parametrize("model,M,over", PLACEMENT_CASES,
                         ids=["fusion-2", "fusion-4", "text_only-2", "text_only-4",
                              "fusion-4-gc-fallback"])
def test_placements_equal_the_jax_package(model, M, over):
    """Every leaf's spec and padded shape equal ``mgnns_tpu.parallel.sharding.
    shard_pytree``'s on a ``(1, M)`` mesh: the tables pad (15 -> 16 rows,
    47 -> 48 edges), a leaf whose split does not divide replicates
    (``gcn_hidden`` 1022 at model 4: ``gc1`` and ``gc2``), and the trunks,
    the LSTM and the label attention replicate."""
    if model == "fusion":
        tree, cfg = _fusion_tree(over)
        rules, jrules, heads = sharding.mgnns_param_rules(), jsharding.mgnns_param_rules(), \
            cfg.n_head
    else:
        tree = text_model_init(15, 7, 47, device="cpu")
        rules, jrules, heads = (sharding.text_model_param_rules(),
                                jsharding.text_model_param_rules(), None)
    port = _port_placements(tree, M, rules, heads)
    jax_side = _jax_placements({k: v for k, v in tree.items() if k not in TRUNKS}, M, jrules)
    assert {p: v for p, v in port.items() if not p.startswith(TRUNKS)} == jax_side
    assert all(spec == () for p, (spec, _) in port.items() if p.startswith(TRUNKS))
    sharded = {p for p, (spec, _) in port.items() if spec}
    assert {"text_gcn/node_embedding", "text_gcn/edge_weight"} <= sharded
    assert port["text_gcn/node_embedding"][1][0] == 16
    assert port["text_gcn/edge_weight"][1][0] == 48
    if model == "fusion":
        assert port["embedding/table"] == (("model", None), (16, 300))
        assert ("gc1/w" in sharded) == ("gc2/w" in sharded) == (over is None)
        assert not any(p.startswith(("lstm/", "object_attention/")) for p in sharded)


def test_head_cut_is_the_one_deviation_from_the_jax_package():
    """At model 8 four heads do not split: the port replicates the q/k/v
    projections and ``fc`` of every attention block (its head rule), where
    XLA splits them; every other leaf resolves as in the JAX package."""
    tree, cfg = _fusion_tree()
    port = _port_placements(tree, 8, sharding.mgnns_param_rules(), cfg.n_head)
    jax_side = _jax_placements({k: v for k, v in tree.items() if k not in TRUNKS}, 8,
                               jsharding.mgnns_param_rules())
    differ = {p for p, v in jax_side.items() if port[p] != v}
    heads = {p for p in jax_side if "slf_attn/" in p
             and p.rsplit("slf_attn/", 1)[1] in ("w_qs/w", "w_qs/b", "w_ks/w", "w_ks/b",
                                                 "w_vs/w", "w_vs/b", "fc/w")}
    assert differ == heads and heads
    assert all(port[p][0] == () for p in heads)
    assert all(jax_side[p][0] != () for p in heads)


@pytest.mark.parametrize("requested,max_batch,dsize", [
    (None, 16, 2), (None, 16, 4), (None, 24, 3), ([2, 8], 8, 2), ([4], 16, 4)])
def test_resolve_batch_buckets_with_a_data_axis_equals_the_jax_package(requested, max_batch,
                                                                      dsize):
    """The ladder of powers of 4 from the data axis's size, as
    ``mgnns_tpu.serving.resolve_batch_buckets``, and its refusal of a bucket
    the axis does not divide."""
    assert serving.resolve_batch_buckets(requested, max_batch, dsize) == \
        jserving.resolve_batch_buckets(requested, max_batch, dsize)
    for bad in ([dsize + 1], [max_batch + dsize]):
        with pytest.raises(ValueError, match="mesh data axis"):
            jserving.resolve_batch_buckets(bad, max_batch, dsize)
        with pytest.raises(ValueError, match="mesh data axis"):
            serving.resolve_batch_buckets(bad, max_batch, dsize)


# ------------------------------------------------------------ ranks against 1


@pytest.fixture(scope="module")
def runs(toy, tmp_path_factory):
    """The ``model2`` (2 ranks) and ``data2model2`` (4 ranks) scenarios,
    started together; the JAX package's eval logits of the toy batch are
    computed meanwhile."""
    dirs = {s: tmp_path_factory.mktemp(s) for s in ("model2", "data2model2")}
    for d in dirs.values():
        torch.save({"kw": toy["kw"], "inputs": toy["inputs"], "batch": toy["batch"],
                    "records": _records(toy, MW.N_RECORDS), "vocab": toy["vocab"],
                    "graph": {k: getattr(toy["graph"], k) for k in ("vocab_size", "keys", "pmi")},
                    "texts": CORPUS}, d / "toy.pt")
    procs = {s: _start(s, d, n) for (s, d), n in zip(dirs.items(), (2, 4))}
    try:
        full = {k: jnp.asarray(v) for k, v in toy["batch"].items()
                if k not in ("label", "weight")}
        full["object_inp"] = jnp.asarray(toy["consts"]["object_inp"].numpy())
        full["place_inp"] = jnp.asarray(toy["consts"]["place_inp"].numpy())
        jcfg = JModelConfig(**toy["kw"])
        jlogits = np.asarray(jax.jit(lambda p, s, c, b: j_mgnns_apply(
            p, s, c, b, cfg=jcfg, train=False)[0])(toy["jparams"], toy["jstate"],
                                                   toy["jconsts"], full))
    finally:
        out = {s: _finish(p, s, dirs[s], timeout=600) for s, p in procs.items()}
    out["jax_logits"] = jlogits
    return out


def test_forward_at_model_2_equals_one_rank_and_the_jax_package(runs):
    """The eval forward on 2 model ranks against the port's 1-rank forward
    (1e-5 of scale) and the JAX package's single-device logits (the fusion
    logits' atol 5e-3 of tests/test_torch_model.py)."""
    r0 = runs["model2"][0]
    assert r0["forward_err"] <= 1e-5
    np.testing.assert_allclose(r0["logits"].numpy(), runs["jax_logits"], atol=5e-3, rtol=0)


def _assert_trains_as_one_rank(ranks: list[dict]) -> None:
    """Losses within 1e-5 relative, the eval loss too, the confusion matrix
    and every record's prediction equal on every rank; BN statistics within
    1e-4 of each leaf's scale; parameters and Adam moments within the
    data-parallel tests' train-mode bounds (5e-3 of scale outside the
    trunks, trunk leaves Frobenius-relative 0.15; see
    tests/test_torch_parallel.py)."""
    want = ranks[0]["reference"]
    for r in ranks:
        got = r["run"]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5, atol=0)
        assert got["eval_loss"] == pytest.approx(want["eval_loss"], rel=1e-5)
        np.testing.assert_array_equal(got["confusion"], want["confusion"])
    merged = {k: v for r in ranks for k, v in r["run"]["preds"].items()}
    assert merged == want["preds"] and len(merged) == MW.N_RECORDS
    errs = ranks[0]["errors"]
    assert errs["stats"]["trunk_max_rel"] <= 1e-4, errs["stats"]
    for key in ("params", "mu", "nu"):
        assert errs[key]["other_max_rel"] <= 5e-3, (key, errs[key])
        assert errs[key]["trunk_frobenius"] <= 0.15, (key, errs[key])


def test_model_2_trains_as_one_rank(runs):
    """2 Adam steps on 2 model ranks through device tables (the plan path),
    at dropout 0.5 with the head-diversity term and the clip scaling every
    step, and an eval epoch, against the 1-rank run of the same batches."""
    ranks = runs["model2"]
    assert ranks[0]["clip_norm"] > MW.GRAD_CLIP
    assert all(r["run"]["fused"] for r in ranks)
    assert len(ranks[0]["reference"]["losses"]) == 2
    _assert_trains_as_one_rank(ranks)


def test_data_2_model_2_trains_as_one_rank_of_the_global_batch(runs):
    """4 ranks on a (2, 2) mesh, streamed, with ``gc1``/``gc2`` replicated
    by the fallback (``gcn_hidden`` 1023): against the 1-rank run of the
    global batches whose BatchNorm runs the data axis's arithmetic."""
    ranks = runs["data2model2"]
    for r in ranks:
        assert r["placements"]["gc1/w"] == r["placements"]["gc2/w"] == ()
        assert r["placements"]["embedding/table"] == ("model", None)
    _assert_trains_as_one_rank(ranks)


@pytest.mark.parametrize("scenario", ["model2", "data2model2"])
def test_replicated_leaves_bit_equal_and_padding_rows_zero(runs, scenario):
    """After training, every rank holds the same bits in every leaf the
    model axis replicates (parameters, BN statistics, Adam moments); each
    model rank shards the same leaves; the gather tables' padding rows (the
    last model rank's: 15 -> 16 rows, 47 -> 48 edges) are zero in the
    parameters and the moments."""
    ranks = runs[scenario]
    assert all(r["report"]["replicated"] == ranks[0]["report"]["replicated"] for r in ranks)
    assert all(r["report"]["sharded"] == ranks[0]["report"]["sharded"] for r in ranks)
    assert "img_object_text_mha/0/slf_attn/w_qs/w" in ranks[0]["report"]["sharded"]
    for r in ranks:
        pads = r["report"]["pads"]
        last = r["rank"] % 2 == 1
        assert {p: v["rows"] for p, v in pads.items()} == {
            "text_gcn/node_embedding": int(last), "text_gcn/edge_weight": int(last),
            "embedding/table": int(last)}
        assert all(v["zero"] for v in pads.values()), pads


def test_model_2_checkpoint_is_whole_and_restores_at_model_1(runs):
    """The model-2 run's checkpoint holds the 1-rank run's leaf shapes
    (vocabulary 15 and 47 edges, not their padded 16 and 48); a 1-rank
    engine restores it to the gathered parameters and moments bit for bit,
    the model-2 engine restores its own shards, and an engine on a model
    axis of 4 restores a model-2 checkpoint to the same whole parameters
    (its tables padded to 16 and 48 rows, a quarter a rank); the reference
    ``state_dict`` export gathers and unpads."""
    r0 = runs["model2"][0]
    assert r0["ckpt_shapes"] == r0["ref_shapes"]
    assert r0["model1_restore"] and all(r["model2_restore"] for r in runs["model2"])
    for r in runs["data2model2"]:  # a (2, 2) run's checkpoint on a (1, 4) mesh
        assert r["model4_restore"]
        assert r["model4_shards"] == {"text_gcn/node_embedding": (4, 300),
                                      "text_gcn/edge_weight": (12, 1),
                                      "embedding/table": (4, 300)}
    assert r0["export"] == {"embedding.weight": (15, 300),
                            "text_features.node_hidden.weight": (15, 300),
                            "text_features.seq_edge_w.weight": (47, 1),
                            "gc1.weight": (300, 1024), "multi_linear_1.weight": (300, 1200)}
    assert r0["export_equal"]


def test_predictor_on_a_2x2_mesh_equals_one_device(runs):
    """``Predictor(mesh=...)`` on 4 ranks: the bucket ladder of a data axis
    of 2, and on every rank the whole answer of an 11-record request (two
    chunks) and a 1-record one (a bucket of 2: one padding row on the
    second data position), labels equal to one device's and probabilities
    within 1e-5."""
    ranks = runs["data2model2"]
    want = ranks[0]["served_one"]
    for r in ranks:
        assert r["buckets"] == [2, 8]
        for got, ref in zip(r["served"], want):
            assert [g["label"] for g in got] == [w["label"] for w in ref]
            np.testing.assert_allclose([list(g["probs"].values()) for g in got],
                                       [list(w["probs"].values()) for w in ref], atol=1e-5)


# ------------------------------------------------------------------ the CLIs


def test_cli_main_and_predict_on_model_2_equal_the_one_rank_clis(tmp_path):
    """``cli.main --mesh_model 2`` (text-only, the text rules) on 2 gloo
    ranks reports the 1-rank run's epoch metrics and test predictions, and
    its rank 0 writes one prediction file equal to the 1-rank file (lr 0,
    as tests/test_torch_parallel.py's CLI test); ``cli.predict --mesh_model
    2`` on the checkpoint it wrote answers as ``cli.predict`` on the 1-rank
    run's, and only rank 0 writes."""
    root = tmp_path / "data"
    _make_mvsa_tree(root)
    two = tmp_path / "two"
    two.mkdir()
    posts = tmp_path / "posts.jsonl"
    posts.write_text("".join(json.dumps({"id": i, "text": t}) + "\n"
                             for i, t in enumerate(CORPUS * 3)))

    def predict_argv(run, out):
        return ["--platform", "cpu", "--data_root_path", str(root), "--checkpoint",
                str(run / "ckpt" / "mgnns_tpu"), "--text_only", "--input", str(posts),
                "--output", str(out), "--max_batch", "4"]

    (two / "cli_args.json").write_text(json.dumps(
        _cli_args(root, two, True) + ["--mesh_model", "2"]))
    (two / "predict_args.json").write_text(json.dumps(
        {"port": _free_port(), "argv": predict_argv(two, two / "preds.jsonl")
         + ["--mesh_model", "2"]}))
    procs = _start("cli", two, 2)
    try:
        one = pmain.main(_cli_args(root, tmp_path / "one", True))  # while the ranks run
        ppredict.main(predict_argv(tmp_path / "one", tmp_path / "one_preds.jsonl"))
    finally:
        a, b = _finish(procs, "cli", two, timeout=300)
    assert a["history"] == b["history"]
    for got, want in zip(a["history"], one["history"]):
        for split in ("train", "val"):
            assert got[split]["accuracy"] == want[split]["accuracy"], split
            assert got[split]["loss"] == pytest.approx(want[split]["loss"], rel=1e-5), split
    assert a["test_accuracy"] == one["test"]["accuracy"]
    want_preds = dict(zip(np.asarray(one["test"]["sample_index"]).tolist(),
                          np.asarray(one["test"]["preds"]).tolist()))
    assert a["preds"] == b["preds"] == want_preds
    pred_files = list((two / "pred").rglob("*.txt"))
    assert len(pred_files) == 1
    assert pred_files[0].read_text() == \
        next((tmp_path / "one" / "pred").rglob("*.txt")).read_text()
    got = [json.loads(line) for line in (two / "preds.jsonl").read_text().splitlines()]
    want = [json.loads(line) for line in (tmp_path / "one_preds.jsonl").read_text().splitlines()]
    assert [g["label"] for g in got] == [w["label"] for w in want] and len(got) == 12
    np.testing.assert_allclose([list(g["probs"].values()) for g in got],
                               [list(w["probs"].values()) for w in want], atol=1e-6)
