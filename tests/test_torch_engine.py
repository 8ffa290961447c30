"""The port's engine, optimizer, checkpoints, metrics and data pipeline
against the JAX package's, on the CPU.

The optimizer takes identical gradient trees in both packages; the engines
train the same weights on the same shuffled batches with SGD and dropout 0
(the dropout masks of the two packages cannot agree), and the loaders'
batches are compared key by key.
"""

import json
import os
import random

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from mgnns_tpu.config import DataConfig as JDataConfig
from mgnns_tpu.config import TextGraphConfig as JTextGraphConfig
from mgnns_tpu.data import images as jimages
from mgnns_tpu.data.dataset import load_constants as j_load_constants
from mgnns_tpu.data.loader import DeviceLoader as JDeviceLoader
from mgnns_tpu.data.text import build_text_side as j_build_text_side
from mgnns_tpu.engine import metrics as JM
from mgnns_tpu.engine.optim import make_optimizer
from mgnns_tpu.engine.train import Engine as JEngine
from mgnns_tpu.models import text_model_apply as j_text_model_apply
from mgnns_tpu.models import text_model_init as j_text_model_init

from mgnns_tpu_torch import convert
from mgnns_tpu_torch.config import DataConfig, TextGraphConfig
from mgnns_tpu_torch.data import images
from mgnns_tpu_torch.data.dataset import load_constants
from mgnns_tpu_torch.data.loader import DeviceLoader
from mgnns_tpu_torch.data.text import build_text_side
from mgnns_tpu_torch.engine import metrics as M
from mgnns_tpu_torch.engine.checkpoint import Checkpointer
from mgnns_tpu_torch.engine.optim import Optimizer, label_params
from mgnns_tpu_torch.engine.train import Engine, cross_entropy
from mgnns_tpu_torch.models.text_only import text_model_apply
from mgnns_tpu_torch.utils import tree_leaves
from tests.torch_train_common import LABELS, datasets, make_data, records, step_losses

CPU = "cpu"


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _leaves_like(like, tree) -> list:
    """The leaves of ``tree`` in the order of ``like``'s keys (JAX trees
    sort dict keys; the port keeps insertion order)."""
    if isinstance(like, dict):
        return [x for k in like for x in _leaves_like(like[k], tree[k])]
    if isinstance(like, (list, tuple)):
        return [x for a, b in zip(like, tree) for x in _leaves_like(a, b)]
    return [tree]


# --------------------------------------------------------------- optimizer


def _opt_tree(r):
    """A tree with a leaf in every group: text, lstm, trunk (nested lists),
    base, unlisted (frozen when faithful) and the always-frozen A."""
    a = lambda *s: r.standard_normal(s).astype(np.float32)  # noqa: E731
    return {
        "text_gcn": {"node_embedding": a(6, 4), "edge_weight": a(5, 1)},
        "lstm": {"layers": [[{"w_ih": a(4, 8)}]]},
        "object_trunk": {"conv1": a(3, 2, 2, 2), "layer1": [{"bn1": {"scale": a(3)}}]},
        "gc1": {"w": a(4, 4)},
        "embedding": {"table": a(6, 4)},
        "multi_linear_2": {"w": a(4, 7), "b": a(7)},
        "object_A": a(3, 3),
    }


OPT_CASES = [
    dict(algo="adam"),
    dict(algo="sgd"),
    dict(algo="adam", faithful=True),
    dict(algo="sgd", faithful=True, freeze_trunks=True),
    dict(algo="adam", freeze_trunks=True),
    dict(algo="adam", accumulation_steps=2),
    dict(algo="sgd", accumulation_steps=2, faithful=True),
]


@pytest.mark.parametrize("case", OPT_CASES, ids=lambda c: "-".join(f"{k}={v}" for k, v in c.items()))
def test_optimizer_matches_optax_chain(case):
    """Five steps against make_optimizer's optax chain on identical gradient
    trees: the step decay falls inside them (epoch_step 2, 2 steps an
    epoch), and steps 1 and 3 have a gradient norm above the clip of 10.
    Parameters within 1e-6 of each leaf's scale; the learning rate makes
    every update at least 1e-4 of it, so a wrong update shows."""
    r = np.random.default_rng(0)
    tree = _opt_tree(r)
    kw = dict(lr=0.05, lrp=0.1, weight_decay=1e-2, grad_clip=10.0, steps_per_epoch=2,
              epoch_step=(2,), lr_decay=0.2, **case)
    tx = make_optimizer(tree, **kw)
    jparams = jax.tree.map(jnp.asarray, tree)
    jstate = tx.init(jparams)
    params = convert.to_torch(tree, device=CPU)
    opt = Optimizer(params, **kw)
    state = opt.init(params)
    leaves = tree_leaves(params)
    for step in range(5):
        grads = jax.tree.map(lambda x: r.standard_normal(x.shape).astype(np.float32)
                             * (8.0 if step in (1, 3) else 0.3), tree)
        grads["object_A"] = np.zeros_like(grads["object_A"])
        updates, jstate = tx.update(jax.tree.map(jnp.asarray, grads), jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        opt.apply(leaves, [torch.from_numpy(g) for g in _leaves_like(tree, grads)], state)
        for p, w, u in zip(leaves, _leaves_like(tree, jparams), _leaves_like(tree, updates)):
            w, u = np.asarray(w), np.asarray(u)
            np.testing.assert_allclose(p.numpy(), w, rtol=0, atol=1e-6 * np.abs(w).max())
            assert (u == 0).all() or np.abs(u).max() > 1e-4 * np.abs(w).max()  # updates show
    if case.get("accumulation_steps", 1) == 1:
        assert state["count"] == 5
    else:
        assert state["count"] == 2 and state["mini_step"] == 1


@pytest.mark.parametrize("faithful,freeze", [(False, False), (True, False), (False, True)])
def test_label_params_match_jax(faithful, freeze):
    from mgnns_tpu.engine.optim import label_params as j_label_params

    tree = _opt_tree(np.random.default_rng(0))
    assert tree_leaves(label_params(tree, faithful, freeze)) == \
        _leaves_like(tree, j_label_params(tree, faithful, freeze))


# ------------------------------------------------------------------ metrics


@pytest.mark.parametrize("C", [2, 7])
def test_confusion_and_metrics_match_jax(C):
    r = np.random.default_rng(C)
    preds, labels = r.integers(0, C, 50), r.integers(0, C, 50)
    w = (np.arange(50) < 45).astype(np.float32)
    cm = M.confusion_update(M.confusion_init(C, CPU), torch.from_numpy(preds),
                            torch.from_numpy(labels), torch.from_numpy(w))
    jcm = JM.confusion_update(JM.confusion_init(C), jnp.asarray(preds), jnp.asarray(labels),
                              jnp.asarray(w))
    np.testing.assert_array_equal(cm.numpy(), np.asarray(jcm))
    assert M.metrics_from_confusion(cm.numpy()) == JM.metrics_from_confusion(np.asarray(jcm))
    names = LABELS[:C]
    assert M.classification_report(cm.numpy(), names) == JM.classification_report(np.asarray(jcm), names)


def test_cross_entropy_weighted():
    logits = torch.tensor([[10.0, 0.0], [0.0, 10.0], [10.0, 0.0]])
    labels = torch.tensor([0, 1, 1])
    assert float(cross_entropy(logits, labels, torch.tensor([1.0, 1.0, 0.0]))) < 1e-3
    assert float(cross_entropy(logits, labels, torch.ones(3))) > 1.0


# --------------------------------------------------------------- the data

@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """A data root with label.json, both packages' datasets over 10 records
    (image 32, synthetic backend), vocab and PMI graph."""
    return make_data(str(tmp_path_factory.mktemp("data")))


def _host(batch):
    return {k: (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)) for k, v in batch.items()}


@pytest.mark.parametrize("backend", ["synthetic", "pil"])
def test_loader_batches_match_jax(data, tmp_path, backend):
    """Two shuffled epochs of batch 4 (the last padded with weight 0), with
    images: the port's batches equal DeviceLoader's key by key.  The 'pil'
    case reads real files with train transforms, so each image's crop and
    flip come from the loader's per-image random streams."""
    if backend == "pil":
        Image = pytest.importorskip("PIL.Image")
        r = np.random.default_rng(0)
        for i in range(len(records())):
            Image.fromarray(r.integers(0, 256, (40 + i, 48, 3), dtype=np.uint8)).save(
                tmp_path / f"img{i}.png")
    jds, ds = datasets(data, backend=backend, image_root=str(tmp_path), train=backend == "pil")
    jl = JDeviceLoader(jds, 4, shuffle=True, seed=3, num_threads=2)
    pl = DeviceLoader(ds, 4, shuffle=True, seed=3, num_threads=2, device=CPU)
    assert len(pl) == len(jl) == 3
    for _ in range(2):
        jb, pb = [_host(b) for b in jl], [_host(b) for b in pl]
        assert len(jb) == len(pb) == 3
        for a, b in zip(pb, jb):
            assert sorted(a) == sorted(b)
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert pb[-1]["weight"].tolist() == [1, 1, 0, 0]


def test_loader_forced_length_and_rewind(data):
    _, ds = datasets(data)
    ld = DeviceLoader(ds, 4, shuffle=True, seed=1, with_images=False, num_batches=5, device=CPU)
    first = [_host(b) for b in ld]
    assert len(first) == 5 and first[-1]["weight"].sum() == 0 and first[-2]["weight"].sum() == 0
    ld.rewind_epoch()
    again = [_host(b) for b in ld]
    for a, b in zip(first, again):
        np.testing.assert_array_equal(a["sample_index"], b["sample_index"])
    with pytest.raises(ValueError):
        DeviceLoader(ds, 4, num_batches=2, device=CPU)


def test_multi_scale_crop_and_flip_match_jax(tmp_path):
    """The train transform of both packages on the same image with the same
    random.Random seeds, bit for bit."""
    Image = pytest.importorskip("PIL.Image")
    path = str(tmp_path / "x.png")
    Image.fromarray(np.random.default_rng(0).integers(0, 256, (70, 90, 3), dtype=np.uint8)).save(path)
    with Image.open(path) as im:
        im = im.convert("RGB")
        for seed in range(6):
            a = images.multi_scale_crop(im, 32, random.Random(seed))
            b = jimages.multi_scale_crop(im, 32, random.Random(seed))
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for seed in range(6):
        np.testing.assert_array_equal(
            images.load_image_uint8(path, size=32, train=True, rng=random.Random(seed)),
            jimages.load_image_uint8(path, size=32, train=True, rng=random.Random(seed)))
    assert images._fill_fix_offset(True, 90, 70, 40, 30) == jimages._fill_fix_offset(True, 90, 70, 40, 30)


def test_build_text_side_and_load_constants_match_jax(data, tmp_path):
    import pickle

    root = str(tmp_path)
    os.makedirs(os.path.join(root, "all_anno_json"))
    for phase in ("train", "val"):
        with open(os.path.join(root, "all_anno_json", f"{phase}_all_anno.json"), "w") as f:
            for rec in records():
                f.write(json.dumps(rec) + "\n")
    cfg_kw = dict(text_min_count=1, ngram=2, max_len=8)
    v, g, corp = build_text_side(root, TextGraphConfig(**cfg_kw), ["val"])
    jv, jg, jcorp = j_build_text_side(root, JTextGraphConfig(**cfg_kw), ["val"])
    assert v == jv
    np.testing.assert_array_equal(g.keys, jg.keys)
    for k in ("ids", "lens", "mask", "eids"):
        np.testing.assert_array_equal(getattr(corp["val"], k), getattr(jcorp["val"], k))

    r = np.random.default_rng(0)
    paths = {}
    for name, obj in (("o_inp", r.standard_normal((80, 300))), ("p_inp", r.standard_normal((365, 300))),
                      ("lab", r.standard_normal((7, 300))),
                      ("o_adj", {"nums": r.integers(1, 50, 80).astype(float),
                                 "adj": r.integers(0, 30, (80, 80)).astype(float)}),
                      ("p_adj", {"nums": r.integers(1, 50, 365).astype(float),
                                 "adj": r.integers(0, 30, (365, 365)).astype(float)})):
        paths[name] = os.path.join(root, f"{name}.pkl")
        with open(paths[name], "wb") as f:
            pickle.dump(obj, f)
    kw = dict(object_inp_name=paths["o_inp"], place_inp_name=paths["p_inp"],
              label_glove_name=paths["lab"], object_adj_file=paths["o_adj"],
              place_adj_file=paths["p_adj"])
    got = load_constants(DataConfig(**kw), object_t=0.4, place_t=0.3)
    want = j_load_constants(JDataConfig(**kw), object_t=0.4, place_t=0.3)
    assert sorted(got) == sorted(want)
    for k in got:
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], want[k])


# ------------------------------------------------------------- the engine


def _text_apply_port(ngram):
    def apply_fn(p, bs, batch, *, train, generator):
        return text_model_apply(p, batch, ngram=ngram, dropout_rate=0.0, train=train,
                                generator=generator), bs
    return apply_fn


def _text_apply_jax(ngram):
    def apply_fn(p, bs, batch, *, train, rng):
        return j_text_model_apply(p, batch, ngram=ngram, dropout_rate=0.0, train=train, rng=rng), bs
    return apply_fn


def test_engine_sgd_trajectory_matches_jax_text_only(data):
    """Four SGD steps of the text-only model through both engines and
    loaders, same seed and shuffled order: losses within 1e-4 relative."""
    jds, ds = datasets(data)
    jparams = j_text_model_init(jax.random.key(0), len(data["vocab"]), 7, data["graph"].num_edges)
    kw = dict(num_classes=7, lr=0.05, optimizer_algo="sgd", steps_per_epoch=3, epoch_step=(1,), seed=0)
    jeng = JEngine(_text_apply_jax(2), jparams, {}, **kw)
    eng = Engine(_text_apply_port(2), convert.text_model_from_jax_params(_np(jparams), device=CPU),
                 {}, device=CPU, **kw)
    jl = JDeviceLoader(jds, 3, shuffle=True, seed=0, with_images=False)
    pl = DeviceLoader(ds, 3, shuffle=True, seed=0, with_images=False, device=CPU)
    got, want = step_losses(jeng, eng, jl, pl, 4)
    assert len(got) == 4 and np.isfinite(got).all() and got[-1] != got[0]
    np.testing.assert_allclose(got, want, rtol=1e-4)


CORPUS2 = [("happy joy smile great day", 0), ("sad cry tears bad day", 1),
           ("joy smile happy fun", 0), ("cry bad sad terrible", 1),
           ("great fun smile joy", 0), ("terrible tears bad cry", 1)]


def _make_engine(tmp_path=None, **kw):
    """The port of tests/test_engine.py:_make_engine: the text-only model on
    a 6-document, 2-class corpus in batches of 3."""
    from mgnns_tpu_torch.graphs.pmi import cal_pmi as p_cal_pmi
    from mgnns_tpu_torch.graphs.pmi import doc_window_edge_ids
    from mgnns_tpu_torch.graphs.vocab import build_vocab as p_build_vocab
    from mgnns_tpu_torch.graphs.vocab import make_word_to_id, words_to_ids
    from mgnns_tpu_torch.models.text_only import text_model_init

    texts = [t for t, _ in CORPUS2]
    labels = np.array([lab for _, lab in CORPUS2], np.int32)
    vocab = p_build_vocab(texts, 1)
    graph = p_cal_pmi(texts, vocab, 3, 1, max_len=8)
    w2i = make_word_to_id(vocab)
    ids = np.zeros((len(texts), 8), np.int32)
    lens = np.zeros((len(texts),), np.int32)
    for n, t in enumerate(texts):
        toks = words_to_ids(t.split(" "), w2i)
        ids[n, : len(toks)] = toks
        lens[n] = len(toks)
    eids = doc_window_edge_ids(ids, lens, 2, graph)

    def loader():
        for i in range(0, len(texts), 3):
            sl = slice(i, i + 3)
            yield {"ids": ids[sl], "lens": lens[sl], "eids": eids[sl], "label": labels[sl],
                   "weight": np.ones(3, np.float32), "sample_index": np.arange(i, i + 3)}

    params = text_model_init(len(vocab), 2, graph.num_edges, seed=0, device=CPU)
    eng = Engine(_text_apply_port(2), params, {}, num_classes=2, lr=5e-2, steps_per_epoch=2,
                 epoch_step=(1000,), checkpoint_dir=str(tmp_path) if tmp_path is not None else None,
                 device=CPU, **kw)
    return eng, loader


def test_engine_overfits_toy_corpus():
    eng, loader = _make_engine()
    first = eng.train_epoch(loader())
    for _ in range(25):
        last = eng.train_epoch(loader())
    assert last["loss"] < first["loss"] and last["accuracy"] == 1.0
    ev = eng.eval_epoch(loader(), collect_preds=True)
    assert ev["accuracy"] == 1.0 and len(ev["preds"]) == 6
    np.testing.assert_array_equal(ev["sample_index"], np.arange(6))
    assert last["steady_samples_per_sec"] > 0 and ev["steady_samples_per_sec"] > 0


def test_nan_guard_skips_bad_update():
    """A non-finite loss leaves the parameters, the optimizer state and the
    BN running statistics as they were, and adds nothing to the confusion
    matrix (tests/test_engine.py:532)."""
    params = {"gc1": {"w": torch.ones(3)}}
    stats = {"bn": {"mean": torch.zeros(2)}}

    def apply_fn(p, bs, batch, *, train, generator):
        z = p["gc1"]["w"].sum() + batch["poison"]
        new_bs = {"bn": {"mean": bs["bn"]["mean"] + 1.0}}
        return torch.stack([z, 0.0 * batch["poison"]])[None, :], new_bs

    eng = Engine(apply_fn, params, stats, num_classes=2, lr=1e-1, steps_per_epoch=1, device=CPU)
    good = {"poison": np.float32(0.0), "label": np.array([0]), "weight": np.ones(1, np.float32)}
    bad = {"poison": np.float32(np.inf), "label": np.array([0]), "weight": np.ones(1, np.float32)}
    cm = M.confusion_init(2, CPU)
    w0 = eng.params["gc1"]["w"].clone()
    loss = eng.train_step(bad, cm)
    assert not np.isfinite(float(loss))
    torch.testing.assert_close(eng.params["gc1"]["w"], w0, rtol=0, atol=0)
    assert eng.opt_state["count"] == 0 and not eng.opt_state["mu"][0].any()
    assert float(eng.batch_stats["bn"]["mean"].sum()) == 0.0 and int(cm.sum()) == 0
    loss = eng.train_step(good, cm)
    assert np.isfinite(float(loss))
    assert not torch.allclose(eng.params["gc1"]["w"], w0)
    assert float(eng.batch_stats["bn"]["mean"][0]) == 1.0 and int(cm.sum()) == 1
    out = eng.train_epoch([bad, good])
    assert out["skipped_steps"] == 1 and np.isfinite(out["loss"])


def test_eval_loss_weighted_by_batch_size():
    def apply_fn(p, bs, batch, *, train, generator):
        return torch.stack([batch["z"], torch.zeros_like(batch["z"])], -1), bs

    eng = Engine(apply_fn, {"w": torch.ones(1)}, {}, num_classes=2, steps_per_epoch=1, device=CPU)
    b1 = {"z": np.zeros(4, np.float32), "label": np.ones(4, np.int32), "weight": np.ones(4, np.float32)}
    b2 = {"z": np.full(4, 10.0, np.float32), "label": np.ones(4, np.int32),
          "weight": np.array([1, 0, 0, 0], np.float32)}
    out = eng.eval_epoch([b1, b2])
    expected = (4 * np.log(2.0) + np.log1p(np.exp(10.0))) / 5
    assert abs(out["loss"] - expected) < 1e-4


def test_faithful_groups_freeze_unlisted_end_to_end():
    eng, loader = _make_engine(faithful_param_groups=True)
    head0 = eng.params["head"]["w"].clone()
    emb0 = eng.params["text_gcn"]["node_embedding"].clone()
    for _ in range(3):
        eng.train_epoch(loader())
    torch.testing.assert_close(eng.params["head"]["w"], head0, rtol=0, atol=0)
    assert not torch.allclose(eng.params["text_gcn"]["node_embedding"], emb0)


def test_engine_checkpoint_roundtrip(tmp_path):
    eng, loader = _make_engine(tmp_path / "ckpt")
    for _ in range(3):
        eng.train_epoch(loader())
    eng.epoch, eng.best_score = 2, 0.75
    eng.save(metrics={"val_accuracy": 0.75})
    params_before = [t.clone() for t in tree_leaves(eng.params)]
    mu_before = [t.clone() for t in eng.opt_state["mu"]]
    eng2, _ = _make_engine(tmp_path / "ckpt")
    eng2.restore()
    assert eng2.step == eng.step == 6 and eng2.epoch == 3
    assert eng2.best_score == pytest.approx(0.75)
    for a, b in zip(params_before + mu_before, tree_leaves(eng2.params) + eng2.opt_state["mu"]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    # training resumes from the restored state exactly as it would have
    eng.train_epoch(loader())
    eng2.train_epoch(loader())
    for a, b in zip(tree_leaves(eng.params), tree_leaves(eng2.params)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_checkpoint_retention_keeps_best_and_latest(tmp_path):
    ck = Checkpointer(str(tmp_path / "ck"), max_to_keep=2)
    state = {"w": torch.ones(3)}
    for step, s in {1: 0.2, 2: 0.9, 3: 0.5, 4: 0.4, 5: 0.3}.items():
        ck.save(step, state, metrics={"val_accuracy": s})
    assert ck.latest_step() == 5 and ck.best_step() == 2
    assert ck.all_steps() == [2, 4, 5]
    assert not [f for f in os.listdir(ck.directory) if f.endswith(".tmp")]
    torch.testing.assert_close(ck.restore(2, device=CPU)["w"], torch.ones(3))
    with pytest.raises(FileNotFoundError):
        Checkpointer(str(tmp_path / "empty")).restore(device=CPU)


def test_learning_loop_and_result_files(tmp_path):
    eng, loader = _make_engine(tmp_path / "ckpt")
    res = eng.learning(loader, loader, loader, max_epochs=3, result_paths={
        "experiment": str(tmp_path / "exp" / "result.txt"),
        "pred": str(tmp_path / "pred" / "pred.txt"), "label_names": ["pos", "neg"]},
        run_config={"lr": 5e-2})
    assert len(res["history"]) == 3 and "test" in res
    exp = (tmp_path / "exp" / "result.txt").read_text()
    assert "acc:" in exp and "weighted avg" in exp
    pred = (tmp_path / "pred" / "pred.txt").read_text().strip().split("\n")
    assert pred[0] == "ID\tTarget\tPred" and len(pred) == 7


def test_metrics_jsonl_logging(tmp_path):
    eng, loader = _make_engine()
    path = str(tmp_path / "m" / "metrics.jsonl")
    eng.learning(loader, loader, max_epochs=2, metrics_path=path)
    rows = [json.loads(line) for line in open(path)]
    assert [r["epoch"] for r in rows] == [0, 1]
    for r in rows:
        assert {"loss", "accuracy", "macro_f1", "skipped_steps"} <= set(r["train"])
        assert np.isfinite(r["val"]["accuracy"])


def test_eval_only_engine_refuses_to_train():
    eng, loader = _make_engine(eval_only=True)
    assert eng.opt_state is None
    assert eng.eval_epoch(loader())["accuracy"] >= 0.0
    with pytest.raises(RuntimeError, match="eval_only"):
        eng.train_epoch(loader())
