"""The port's command-line entry points against the JAX package's on the CPU:
``mgnns_tpu_torch.cli.main`` trains on synthetic MVSA-style and fusion data
trees (tests/test_mvsa.py:17-39), writes the JAX CLI's preprocessing files
and result paths, covers every JAX flag, and ingests torchvision-format
trunk checkpoints bit for bit; ``mgnns_tpu_torch.cli.prepare`` writes the
same files as ``mgnns_tpu.cli.prepare``."""

import json
import os
import pickle

import numpy as np
import pytest
import torch

import jax

from mgnns_tpu.cli import main as jmain
from mgnns_tpu.cli import prepare as jprepare
from mgnns_tpu.graphs.vocab import build_vocab, save_vocab
from mgnns_tpu.models import import_reference as IR
from mgnns_tpu.nn import resnet as jresnet

from mgnns_tpu_torch import convert
from mgnns_tpu_torch.cli import main as pmain
from mgnns_tpu_torch.cli import prepare as pprepare
from mgnns_tpu_torch.engine.checkpoint import Checkpointer
from mgnns_tpu_torch.nn import resnet
from tests.test_mvsa import _make_mvsa_tree
from tests.torch_train_common import CPU, np_tree


def _text_args(root, out, epochs):
    return ["--data_root_path", str(root), "--dataset", "MVSA_simple", "--num_labels", "3",
            "--text_min_count", "1", "--text_only", "--epochs", str(epochs), "-b", "30",
            "--lr", "5e-2", "-e", "--save_model_path", str(out / "ckpt"),
            "--save_experiment_result_path", str(out / "exp"),
            "--save_pred_result_path", str(out / "pred")]


def test_mvsa_text_cli_end_to_end(tmp_path):
    """tests/test_mvsa.py:42-59 through the port's CLI on the CPU."""
    _make_mvsa_tree(tmp_path)
    res = pmain.main(["--platform", "cpu"] + _text_args(tmp_path, tmp_path, 6))
    assert res["best_val_accuracy"] > 0.8
    assert res["test"]["accuracy"] > 0.8
    report = next((tmp_path / "exp" / "mgnns_tpu").iterdir()).read_text()
    assert "negative" in report and "neutral" in report and "positive" in report


def test_cli_device_tables_and_profile_dir_give_the_streaming_run(tmp_path, capsys):
    """``--device_text --device_images --cache_eval_batches --profile_dir``
    on the CPU: the greedy budget line, a trace of the first epoch in
    ``--profile_dir``, and every metric and prediction of the same run
    without the flags (the plan path runs the loop path's step on the same
    batches with the same dropout masks).  One torch thread: with more, the
    CPU's embedding backward adds across threads in a varying order, and
    even two runs without the flags can differ in the last bit of a loss."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _check_device_tables_run(tmp_path, capsys)
    finally:
        torch.set_num_threads(before)


def _check_device_tables_run(tmp_path, capsys):
    _make_mvsa_tree(tmp_path)
    plain = pmain.main(["--platform", "cpu"] + _text_args(tmp_path, tmp_path / "plain", 2))
    capsys.readouterr()
    flags = ["--device_text", "--device_images", "--cache_eval_batches",
             "--profile_dir", str(tmp_path / "trace")]
    res = pmain.main(["--platform", "cpu"] + _text_args(tmp_path, tmp_path / "tables", 2) + flags)
    assert "device_images: 3/3 split tables within 7.0 GB budget" in capsys.readouterr().out
    assert any(f.endswith(".pt.trace.json") for f in os.listdir(tmp_path / "trace"))
    for got, want in zip(res["history"], plain["history"]):
        assert got["train"]["fused"] and got["val"]["fused"]
        for split in ("train", "val"):
            for k in ("loss", "accuracy", "micro_f1", "macro_f1", "weighted_f1"):
                assert got[split][k] == want[split][k], (split, k)
    for k in ("accuracy", "loss", "preds", "targets", "sample_index"):
        np.testing.assert_array_equal(res["test"][k], plain["test"][k], err_msg=k)


def _files(root) -> dict:
    return {os.path.relpath(os.path.join(d, f), root): os.path.join(d, f)
            for d, _, fs in os.walk(root) for f in fs}


def _assert_same_file(got: str, want: str) -> None:
    if got.endswith(".npz"):  # a zip archive stamps its members with the time
        a, b = np.load(got), np.load(want)
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])
    else:
        with open(got, "rb") as f, open(want, "rb") as g:
            assert f.read() == g.read(), got


def test_cli_writes_the_jax_cli_preproc_and_result_paths(tmp_path):
    """On the same tree and flags both CLIs write the same preprocessing
    files beside the checkpoints and results under the same paths."""
    _make_mvsa_tree(tmp_path / "data")
    jmain.main(["--platform", "cpu"] + _text_args(tmp_path / "data", tmp_path / "jax", 1))
    pmain.main(["--platform", "cpu"] + _text_args(tmp_path / "data", tmp_path / "port", 1))
    for name in ("preproc.json", "preproc.npz"):
        _assert_same_file(str(tmp_path / "port" / "ckpt" / "mgnns_tpu" / name),
                          str(tmp_path / "jax" / "ckpt" / "mgnns_tpu" / name))
    for kind in ("exp", "pred"):
        assert sorted(_files(tmp_path / "port" / kind)) == sorted(_files(tmp_path / "jax" / kind))


def _prepare_tree(root):
    """An MVSA-style tree with a vocabulary, GloVe text, class names and
    object/place label lists."""
    _make_mvsa_tree(root)
    with open(root / "all_anno_json" / "train_all_anno.json") as f:
        texts = [json.loads(line)["text"] for line in f]
    save_vocab(build_vocab(texts, 1), str(root / "vocab" / "vocab-1.txt"))
    r = np.random.default_rng(7)
    words = sorted({w for t in texts for w in t.split(" ")}) + ["the", "negative", "positive"]
    with open(root / "glove.txt", "w") as f:
        f.write("3 12\n")  # a word2vec-style header line, skipped
        for w in words:
            f.write(w + " " + " ".join(f"{v:.5f}" for v in r.standard_normal(12)) + "\n")
    (root / "classes.txt").write_text("good\nbad\nunknownword\n")


PREPARE_CASES = {
    "vocab": [["vocab", "--text_min_count", "1"]],
    "adj": [["adj", "--key", "objects", "--num_classes", "8"],
            ["adj", "--key", "places", "--num_classes", "9", "--splits", "train", "val"]],
    "pmi": [["pmi", "--text_min_count", "1", "--window_size", "3", "--min_cooccurence", "1"]],
    "pack-glove": [["pack-glove", "--glove_txt", "{root}/glove.txt", "--kind", "vocab",
                    "--text_min_count", "1"],
                   ["pack-glove", "--glove_txt", "{root}/glove.txt", "--kind", "labels"],
                   ["pack-glove", "--glove_txt", "{root}/glove.txt", "--kind", "classes",
                    "--class_names", "{root}/classes.txt", "--output", "{root}/cls.pkl"]],
    "join": [["join", "--base", "{root}/all_anno_json/train_all_anno.json", "--extra",
              "{root}/all_anno_json/val_all_anno.json", "--output", "{root}/out/joined.jsonl"]],
    "filter-short": [["filter-short", "--input", "{root}/all_anno_json/test_all_anno.json",
                      "--output", "{root}/out/long.jsonl", "--min_words", "7"]],
    "upsample": [["upsample", "--input", "{root}/all_anno_json/val_all_anno.json",
                  "--label", "positive", "--times", "2", "--output", "{root}/up.jsonl"]],
    "label-stats": [["label-stats", "--input", "{root}/all_anno_json/train_all_anno.json"]],
}


@pytest.mark.parametrize("cmd", sorted(PREPARE_CASES))
def test_prepare_writes_what_the_jax_prepare_writes(cmd, tmp_path, capsys):
    """Each subcommand on two copies of one tree: the same files with the
    same bytes (``.npz`` member arrays equal), and the same standard output
    once the tree's path is taken out."""
    outputs = {}
    for name, mod in (("jax", jprepare), ("port", pprepare)):
        root = tmp_path / name
        _prepare_tree(root)
        for argv in PREPARE_CASES[cmd]:
            argv = [a.format(root=root) for a in argv]
            if not argv[0] in ("join", "filter-short", "upsample", "label-stats"):
                argv += ["--data_root_path", str(root)]
            mod.main(argv)
        outputs[name] = capsys.readouterr().out.replace(str(root), "<root>")
    assert outputs["port"] == outputs["jax"]
    got, want = _files(tmp_path / "port"), _files(tmp_path / "jax")
    assert sorted(got) == sorted(want)
    for rel in got:
        _assert_same_file(got[rel], want[rel])


def _sample_argv(action) -> list[str]:
    """A non-default value of one JAX CLI option."""
    opt = action.option_strings[-1]
    if action.nargs == 0:
        return [opt]
    if action.dest == "resume":
        return [opt, "reference.pth.tar"]
    if action.dest == "platform":
        return [opt, "cpu"]
    if action.choices:
        return [opt, next(c for c in action.choices if c != action.default)]
    value = {int: "2", float: "0.25", bool: "1"}.get(action.type, "x")
    return [opt, value]


REJECTED = {"fused_segments", "use_pallas", "libtpu_init_args", "perf_preset"}


def test_every_jax_flag_parses_and_is_honoured_ignored_or_rejected_with_its_counterpart():
    """Each option of the JAX CLI, at a non-default value, parses in the
    port.  The port rejects exactly the XLA-only, TPU-only and queued ones,
    each with a message naming its counterpart or its ROADMAP.md item;
    ``--mesh_data``, ``--mesh_model`` and ``--multihost`` act
    (tests/test_torch_parallel.py, tests/test_torch_model_axis.py), and
    ``--mesh_data 2`` or ``--mesh_model 2`` in a world of one process says
    how to start the ranks."""
    parser = pmain.build_parser()
    port_opts = {o for a in parser._actions for o in a.option_strings}
    rejected = set()
    for action in jmain.build_parser()._actions:
        if not action.option_strings or action.dest == "help":
            continue
        assert set(action.option_strings) <= port_opts, action.option_strings
        args = parser.parse_args(_sample_argv(action))
        msgs = pmain.unported_flags(args)
        if msgs:
            rejected.add(action.dest)
            assert len(msgs) == 1 and ("ROADMAP.md" in msgs[0] or "counterpart" in msgs[0]), msgs
    assert rejected == REJECTED
    # the defaults themselves are all accepted, and a bare --resume too
    assert pmain.unported_flags(parser.parse_args([])) == []
    assert pmain.unported_flags(parser.parse_args(["--resume"])) == []
    with pytest.raises(SystemExit, match="--mesh_model 2 needs a world of 2 ranks"):
        pmain.main(["--platform", "cpu", "--mesh_model", "2"])
    with pytest.raises(SystemExit, match="needs a world of 2 ranks"):
        pmain.main(["--platform", "cpu", "--mesh_data", "2"])


def _trunk_sd(depth, seed):
    """(torchvision-named state_dict, (params, stats)) of a random JAX trunk
    (tests/test_pretrained_cli.py:53-67)."""
    params, stats = jresnet.resnet_init(jax.random.key(seed), depth=depth)
    out: dict = {}
    IR._exp_trunk(out, "t", params, stats, depth)
    sd = {}
    for k, v in out.items():
        idx, _, tail = k[2:].partition(".")
        sd[IR._TRUNK_SEQ[idx] + ("." + tail if tail else "")] = torch.from_numpy(np.array(v))
    return sd, (params, stats)


def _assert_trees_equal(got, want):
    """Same structure (dict keys in any order, list lengths) and bit-equal
    float32 leaves."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _assert_trees_equal(got[k], want[k])
    elif isinstance(want, list):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _assert_trees_equal(a, b)
    else:
        assert got.dtype == torch.float32
        torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("depth", [50, 101])
def test_import_torch_state_dict_matches_jax_import(depth):
    sd, _ = _trunk_sd(depth, seed=depth)
    p, s = resnet.import_torch_state_dict(sd, depth)
    jp, js = jresnet.import_torch_state_dict(sd, depth)
    _assert_trees_equal(p, convert.resnet_from_jax(np_tree(jp), device=CPU))
    _assert_trees_equal(s, convert.resnet_from_jax(np_tree(js), device=CPU))


def _fusion_tree(root):
    """A fusion data tree: MVSA-style annotations with object/place ids, the
    seeded GloVe constant pickles, and adjacency pickles and a vocabulary
    written by the port's ``prepare``."""
    _make_mvsa_tree(root)
    (root / "glove").mkdir()
    r = np.random.default_rng(11)
    for rel, shape in (("glove/object_glove_word2vec.pkl", (80, 300)),
                       ("glove/place_glove_word2vec.pkl", (365, 300)),
                       ("tumblr_label_glove.pkl", (3, 300))):
        with open(root / rel, "wb") as f:
            pickle.dump(r.standard_normal(shape).astype(np.float32), f)
    for key, n, name in (("objects", 80, "tumblr_objects_adj.pkl"),
                         ("places", 365, "tumblr_resnet50_places_adj.pkl")):
        pprepare.main(["adj", "--data_root_path", str(root), "--key", key, "--num_classes",
                       str(n), "--output", str(root / "adj" / name)])
    pprepare.main(["vocab", "--data_root_path", str(root), "--text_min_count", "1"])


def test_fusion_cli_ingests_trunk_checkpoints_bit_for_bit(tmp_path):
    """The fusion model through the port's CLI at 64 px with frozen trunks:
    a torchvision ``resnet101.pth`` and a Places-style ``{'state_dict':
    {'module.…'}}`` ``.pth.tar``; the saved engine state carries every
    imported trunk tensor bit for bit."""
    root = tmp_path / "data"
    _fusion_tree(root)
    obj_sd, (obj_p, obj_s) = _trunk_sd(101, seed=1)
    plc_sd, (plc_p, plc_s) = _trunk_sd(50, seed=2)
    torch.save(obj_sd, tmp_path / "resnet101.pth")
    torch.save({"state_dict": {f"module.{k}": v for k, v in plc_sd.items()}, "epoch": 3},
               tmp_path / "resnet50_places365.pth.tar")
    res = pmain.main([
        "--platform", "cpu", "--data_root_path", str(root), "--num_labels", "3",
        "--text_min_count", "1", "--limit_samples", "8", "--epochs", "1", "-b", "4",
        "--image-size", "64", "--bn_mode", "frozen", "--freeze_trunks", "-j", "1", "-e",
        "--object_trunk_ckpt", str(tmp_path / "resnet101.pth"),
        "--place_trunk_ckpt", str(tmp_path / "resnet50_places365.pth.tar"),
        "--save_model_path", str(tmp_path / "ckpt"),
        "--save_experiment_result_path", str(tmp_path / "exp"),
        "--save_pred_result_path", str(tmp_path / "pred"),
        "--metrics_path", str(tmp_path / "metrics.jsonl")])
    assert np.isfinite(res["history"][0]["train"]["loss"])
    assert (tmp_path / "metrics.jsonl").stat().st_size > 0
    saved = Checkpointer(str(tmp_path / "ckpt" / "mgnns_tpu")).restore(device=CPU)
    for side, p, s in (("object_trunk", obj_p, obj_s), ("place_trunk", plc_p, plc_s)):
        _assert_trees_equal(saved["params"][side], convert.resnet_from_jax(np_tree(p), device=CPU))
        _assert_trees_equal(saved["batch_stats"][side],
                            convert.resnet_from_jax(np_tree(s), device=CPU))


def test_model_side_pieces_of_the_cli_match_jax(tmp_path):
    """The pieces the CLI calls against their JAX counterparts:
    ``initial_edge_weights`` both ways, ``build_cooccurrence``,
    ``load_adj_pickle`` and ``gen_A`` of a pickle's path, and the given
    tables of ``text_model_init`` and ``mgnns_init`` (padding row zeroed)."""
    from mgnns_tpu.graphs.cooccur import build_cooccurrence as j_build, load_adj_pickle as j_load
    from mgnns_tpu.graphs.cooccur import gen_A as j_gen_A
    from mgnns_tpu.graphs.pmi import cal_pmi as j_cal_pmi
    from mgnns_tpu.models import text_model_init as j_text_model_init

    from mgnns_tpu_torch.config import ModelConfig
    from mgnns_tpu_torch.graphs.cooccur import build_cooccurrence, gen_A, load_adj_pickle
    from mgnns_tpu_torch.graphs.pmi import PmiGraph
    from mgnns_tpu_torch.models.mgnns import mgnns_init
    from mgnns_tpu_torch.models.text_only import text_model_init

    texts = ["a b c a d", "b c d e", "a e b c"]
    vocab = ["PAD", "UNK", "a", "b", "c", "d", "e"]
    jg = j_cal_pmi(texts, vocab, 2, 1)
    g = PmiGraph(jg.vocab_size, jg.keys, jg.pmi)
    for ones in (True, False):
        np.testing.assert_array_equal(g.initial_edge_weights(ones), jg.initial_edge_weights(ones))
    sets = [[0, 2, 2, 5], [1], [], [5, 0, 3]]
    want = j_build(sets, 6)
    got = build_cooccurrence(sets, 6)
    for k in ("nums", "adj"):
        np.testing.assert_array_equal(got[k], want[k])
    with open(tmp_path / "adj.pkl", "wb") as f:
        pickle.dump(want, f)
    for k in ("nums", "adj"):
        np.testing.assert_array_equal(load_adj_pickle(str(tmp_path / "adj.pkl"))[k],
                                      j_load(str(tmp_path / "adj.pkl"))[k])
    for got, want in zip(gen_A(6, 0.3, str(tmp_path / "adj.pkl")),
                         j_gen_A(6, 0.3, str(tmp_path / "adj.pkl"))):
        np.testing.assert_array_equal(got, want)

    r = np.random.default_rng(0)
    emb = r.standard_normal((len(vocab), 300)).astype(np.float32)
    edges = g.initial_edge_weights(False)
    jp = j_text_model_init(jax.random.key(0), len(vocab), 3, g.num_edges, node_embedding=emb,
                           edge_weights=edges)
    p = text_model_init(len(vocab), 3, g.num_edges, node_embedding=emb, edge_weights=edges,
                        device=CPU)
    for k in ("node_embedding", "edge_weight"):
        np.testing.assert_array_equal(p["text_gcn"][k].numpy(), np.asarray(jp["text_gcn"][k]))

    cfg = ModelConfig(vocab_size=len(vocab), object_num_classes=2, place_num_classes=3)
    z = dict(num_edges=g.num_edges, label_embedding=np.zeros((7, 300)), object_A=np.eye(2),
             place_A=np.eye(3), object_inp=np.zeros((2, 300)), place_inp=np.zeros((3, 300)))
    trunk = resnet.resnet_init(torch.Generator().manual_seed(5), depth=101)
    params, stats, _ = mgnns_init(cfg, vocab_embedding=emb, node_embedding=emb, edge_weights=edges,
                                  object_trunk=trunk, device=CPU, **z)
    padded = emb.copy()
    padded[0] = 0.0
    np.testing.assert_array_equal(params["embedding"]["table"].numpy(), padded)
    np.testing.assert_array_equal(params["text_gcn"]["node_embedding"].numpy(), emb)
    np.testing.assert_array_equal(params["text_gcn"]["edge_weight"].numpy(), edges)
    _assert_trees_equal(params["object_trunk"], trunk[0])
    _assert_trees_equal(stats["object_trunk"], trunk[1])
