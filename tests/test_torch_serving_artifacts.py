"""Serving what the port's training CLI wrote, on the CPU:
``Predictor.from_engine_artifacts`` (text-only and fusion, dead modules
included) against a ``Predictor`` built in process from the restored trees,
its refusals, ``mgnns_tpu_torch.cli.predict``, and the training CLI's
reference-checkpoint flags (``--init_from_reference``, ``--resume
<x.pth.tar>`` and ``<dir>``, ``--include_dead_modules``), as
tests/test_pretrained_cli.py:143-192, :321-345 and
tests/test_dead_modules.py:198-229 drive the JAX CLI."""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from mgnns_tpu_torch.cli import main as pmain
from mgnns_tpu_torch.cli import predict as ppredict
from mgnns_tpu_torch.config import DataConfig, ModelConfig
from mgnns_tpu_torch.data.dataset import load_constants
from mgnns_tpu_torch.engine.checkpoint import Checkpointer
from mgnns_tpu_torch.models.import_reference import (
    export_reference_state_dict, import_reference_state_dict,
)
from mgnns_tpu_torch.models.mgnns import DEAD_MODULES
from mgnns_tpu_torch.serving import Predictor, load_preproc
from mgnns_tpu_torch.utils import tree_leaves, tree_paths
from tests.test_torch_cli import _fusion_tree
from tests.torch_train_common import few_torch_threads  # noqa: F401  (autouse fixture)
from tests.torch_train_common import CPU

# the fusion model at 32 px with frozen trunks: 4 records, one step an epoch
FUSION = ["--limit_samples", "4", "-b", "4", "--image-size", "32", "--bn_mode", "frozen",
          "--freeze_trunks", "-j", "1"]
RECORDS = [{"id": f"q{i}", "text": t, "image": f"img/{i}.jpg"} for i, t in enumerate(
    ["good great happy love day", "bad sad awful", "table walk city photo", "",
     "wonderful unknownword love", "hate terrible day day day", "photo"])]


def _cli(root, out, extra):
    return pmain.main(["--platform", "cpu", "--data_root_path", str(root), "--num_labels", "3",
                       "--text_min_count", "1", "--save_model_path", str(out / "ckpt"),
                       "--save_experiment_result_path", str(out / "exp"),
                       "--save_pred_result_path", str(out / "pred")] + extra)


def _ckpt(out):
    return str(out / "ckpt" / "mgnns_tpu")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """A fusion data tree, a text-only CLI run on it, and a fusion CLI run
    with the dead modules over two epochs."""
    tmp = tmp_path_factory.mktemp("artifacts")
    root = tmp / "data"
    _fusion_tree(root)
    _cli(root, tmp / "text", ["--text_only", "--epochs", "2", "-b", "30", "--lr", "5e-2"])
    dead = _cli(root, tmp / "dead", FUSION + ["--include_dead_modules", "--epochs", "2"])
    return dict(tmp=tmp, root=root, text=_ckpt(tmp / "text"), dead=_ckpt(tmp / "dead"),
                dead_result=dead)


def _in_process(ckpt, root, text_only, **kw):
    """A Predictor built from the restored trees and preproc files."""
    vocab, graph, label_map, graph_cfg = load_preproc(ckpt)
    raw = Checkpointer(ckpt).restore(device=CPU)
    common = dict(vocab=vocab, graph=graph, graph_cfg=graph_cfg, label_map=label_map,
                  params=raw["params"], device=CPU, **kw)
    if text_only:
        return Predictor(text_only=True, **common)
    cfg = ModelConfig(num_labels=len(label_map), vocab_size=len(vocab), edges_num=graph.num_edges,
                      image_size=32)
    consts = load_constants(DataConfig(
        data_root_path=str(root),
        object_inp_name=f"{root}/glove/object_glove_word2vec.pkl",
        place_inp_name=f"{root}/glove/place_glove_word2vec.pkl",
        label_glove_name=f"{root}/tumblr_label_glove.pkl",
        object_adj_file=f"{root}/adj/tumblr_objects_adj.pkl",
        place_adj_file=f"{root}/adj/tumblr_resnet50_places_adj.pkl"),
        object_t=cfg.object_t, place_t=cfg.place_t)
    consts = {k: torch.from_numpy(consts[k]) for k in ("label_embedding", "object_inp", "place_inp")}
    consts["label_query"] = consts.pop("label_embedding")
    return Predictor(batch_stats=raw["batch_stats"], consts=consts, cfg=cfg, **common)


def _assert_same_answers(got, want):
    assert [o["label"] for o in got] == [o["label"] for o in want]
    assert [o["label_id"] for o in got] == [o["label_id"] for o in want]
    for a, b in zip(got, want):
        assert a["probs"] == b["probs"]


@pytest.mark.parametrize("kind", ["text_only", "fusion_with_dead_modules"])
def test_from_engine_artifacts_equals_in_process_predictor(runs, kind):
    text_only = kind == "text_only"
    ckpt = runs["text"] if text_only else runs["dead"]
    kw = {} if text_only else dict(image_backend="synthetic", strict_images=False)
    pred = Predictor.from_engine_artifacts(
        str(runs["root"]), ckpt, text_only=text_only, device=CPU, max_batch=4,
        model_overrides=None if text_only else {"image_size": 32}, **kw)
    ref = _in_process(ckpt, runs["root"], text_only, max_batch=4, **kw)
    try:
        _assert_same_answers(pred.predict(RECORDS), ref.predict(RECORDS))
        if not text_only:
            assert set(DEAD_MODULES) <= set(pred.params)
    finally:
        pred.close()
        ref.close()


def test_include_dead_modules_saves_them_frozen(runs):
    """--include_dead_modules: both epochs' checkpoints carry the dead
    subtrees, unchanged from one step to the next while the live leaves
    move."""
    assert np.isfinite(runs["dead_result"]["history"][0]["train"]["loss"])
    ck = Checkpointer(runs["dead"])
    assert ck.all_steps() == [1, 2]
    a, b = (ck.restore(s, device=CPU)["params"] for s in (1, 2))
    for name in DEAD_MODULES:
        assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a[name]), tree_leaves(b[name])))
        assert any(float(x.std()) > 0 for x in tree_leaves(a[name])), name
    assert not torch.equal(a["multi_linear_2"]["w"], b["multi_linear_2"]["w"])


def _wrapper(runs, path, **meta):
    """The dead run's latest weights exported as a reference checkpoint
    wrapper."""
    raw = Checkpointer(runs["dead"]).restore(device=CPU)
    sd = export_reference_state_dict(raw["params"], raw["batch_stats"])
    torch.save({"arch": "Multi_GCN_Multihead_Att", "state_dict": sd, **meta}, path)
    return sd


@pytest.mark.parametrize("case", ["no_checkpoint", "vocab_mismatch", "text_only_reference",
                                  "unknown_leaf"])
def test_from_engine_artifacts_refuses(runs, case, tmp_path):
    root, kw = str(runs["root"]), dict(device=CPU, model_overrides={"image_size": 32})
    if case == "no_checkpoint":
        empty = tmp_path / "empty"
        empty.mkdir()
        for name in ("preproc.json", "preproc.npz"):
            shutil.copy(os.path.join(runs["dead"], name), empty / name)
        with pytest.raises(FileNotFoundError, match="no checkpoint"):
            Predictor.from_engine_artifacts(root, str(empty), **kw)
        with pytest.raises(FileNotFoundError, match="no checkpoint"):
            Predictor.from_engine_artifacts(root, str(tmp_path / "missing"), **kw)
    elif case == "vocab_mismatch":
        sd = _wrapper(runs, tmp_path / "w.pth.tar", epoch=1)
        sd["embedding.weight"] = sd["embedding.weight"][:-1]
        torch.save({"state_dict": sd}, tmp_path / "w.pth.tar")
        with pytest.raises(ValueError, match="vocab"):
            Predictor.from_engine_artifacts(root, runs["dead"], reference_ckpt=str(
                tmp_path / "w.pth.tar"), **kw)
    elif case == "text_only_reference":
        with pytest.raises(ValueError, match="text_only"):
            Predictor.from_engine_artifacts(root, runs["text"], text_only=True,
                                            reference_ckpt="w.pth.tar", device=CPU)
    else:
        ckpt = tmp_path / "ck"
        shutil.copytree(runs["dead"], ckpt)
        state = Checkpointer(str(ckpt)).restore(device=CPU)
        state["params"]["bogus"] = {"w": torch.zeros(2)}
        Checkpointer(str(ckpt)).save(9, state)
        with pytest.raises(ValueError, match="unknown.*bogus"):
            Predictor.from_engine_artifacts(root, str(ckpt), **kw)


def test_reference_ckpt_serves_the_wrapper_weights(runs, tmp_path):
    """``reference_ckpt`` serves the exported weights: the same answers as
    the checkpoint they came from."""
    _wrapper(runs, tmp_path / "w.pth.tar", epoch=2, best_score=np.float64(0.5))
    kw = dict(device=CPU, model_overrides={"image_size": 32}, image_backend="synthetic",
              strict_images=False)
    a = Predictor.from_engine_artifacts(str(runs["root"]), runs["dead"], **kw)
    b = Predictor.from_engine_artifacts(str(runs["root"]), runs["dead"],
                                        reference_ckpt=str(tmp_path / "w.pth.tar"), **kw)
    _assert_same_answers(a.predict(RECORDS[:3]), b.predict(RECORDS[:3]))


def test_predict_cli_writes_the_jsonl_of_predict(runs, tmp_path):
    src = tmp_path / "in.jsonl"
    src.write_text("".join(json.dumps(r) + "\n" for r in RECORDS) + "\n")
    out = tmp_path / "out.jsonl"
    ppredict.main(["--platform", "cpu", "--data_root_path", str(runs["root"]), "--checkpoint",
                   runs["text"], "--text_only", "--input", str(src), "--output", str(out),
                   "--max_batch", "4"])
    got = [json.loads(line) for line in out.read_text().splitlines()]
    want = _in_process(runs["text"], runs["root"], True, max_batch=4).predict(RECORDS)
    assert [g["id"] for g in got] == [r["id"] for r in RECORDS]
    assert [sorted(g) for g in got] == [["id", "label", "label_id", "probs"]] * len(RECORDS)
    _assert_same_answers(got, want)


@pytest.mark.parametrize("flag,item", [(["--mesh_data", "2"], "item 6b"),
                                       (["--mesh_model", "2"], "item 6b")])
def test_predict_cli_rejects_unported_flags_naming_their_item(flag, item):
    with pytest.raises(SystemExit, match=f"ROADMAP.md queue 1 {item}"):
        ppredict.main(["--platform", "cpu", "--checkpoint", "x", "--data_root_path", "x",
                       "--input", "x"] + flag)


def test_cli_init_from_reference_loads_every_weight(runs, tmp_path):
    """--init_from_reference with a wrapper whose best_score is a numpy
    scalar: at lr 0 the saved weights are the wrapper's, dead modules
    included."""
    sd = _wrapper(runs, tmp_path / "w.pth.tar", epoch=1, best_score=np.float64(0.5))
    _cli(runs["root"], tmp_path / "r", FUSION + [
        "--epochs", "1", "--lr", "0", "--weight_decay", "0",
        "--init_from_reference", str(tmp_path / "w.pth.tar")])
    saved = Checkpointer(_ckpt(tmp_path / "r")).restore(device=CPU)
    want_p, want_s = import_reference_state_dict(sd, device=CPU)
    for got, want in ((saved["params"], want_p), (saved["batch_stats"], want_s)):
        assert sorted(tree_paths(got)) == sorted(tree_paths(want))
        flat = dict(zip(tree_paths(got), tree_leaves(got)))
        for path, t in zip(tree_paths(want), tree_leaves(want)):
            assert torch.equal(flat[path], t), path
    with pytest.raises(SystemExit, match="need the fusion model"):
        _cli(runs["root"], tmp_path / "t", ["--text_only", "--init_from_reference",
                                            str(tmp_path / "w.pth.tar")])


def test_cli_resume_reference_wrapper_takes_epoch_and_fresh_optimizer(runs, tmp_path):
    """--resume <x.pth.tar> imports the weights, starts a fresh optimizer and
    takes the next epoch and the best score from the wrapper."""
    _wrapper(runs, tmp_path / "w.pth.tar", epoch=3, best_score=np.float64(0.75))
    res = _cli(runs["root"], tmp_path / "r", FUSION + [
        "--epochs", "4", "--resume", str(tmp_path / "w.pth.tar")])
    assert [h["epoch"] for h in res["history"]] == [3]
    assert res["best_val_accuracy"] >= 0.75
    saved = Checkpointer(_ckpt(tmp_path / "r")).restore(device=CPU)
    assert saved["opt_state"]["count"] == 1 and saved["step"] == 1
    with pytest.raises(SystemExit, match="fusion model"):
        _cli(runs["root"], tmp_path / "t", ["--text_only", "--resume", str(tmp_path / "w.pth.tar")])


def test_cli_resume_from_dir_continues_and_leaves_the_dir_alone(runs, tmp_path):
    """--resume <dir> restores the full train state of another run's
    directory and trains the next epoch; nothing in that directory changes.
    A directory whose trees differ from the run's (dead modules) raises, and
    a bogus target fails loudly."""
    src = tmp_path / "src"
    shutil.copytree(runs["dead"], src)
    before = {f: os.path.getmtime(src / f) for f in os.listdir(src)}
    res = _cli(runs["root"], tmp_path / "b", FUSION + [
        "--include_dead_modules", "--epochs", "3", "--max_to_keep", "1", "--resume", str(src)])
    assert [h["epoch"] for h in res["history"]] == [2]
    assert {f: os.path.getmtime(src / f) for f in os.listdir(src)} == before
    with pytest.raises(ValueError, match="extra .*object_gate"):
        _cli(runs["root"], tmp_path / "c", FUSION + ["--epochs", "3", "--resume", str(src)])
    with pytest.raises(SystemExit):
        _cli(runs["root"], tmp_path / "d", FUSION + ["--resume", str(tmp_path / "nope.xyz")])
