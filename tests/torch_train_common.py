"""Shared pieces of the port's training tests: the toy fusion setup of
tests/test_full_parity.py:245 in both packages, the port's train-mode
gradients, and leaf-by-leaf tree comparisons."""

import dataclasses
import json
import os

import numpy as np
import torch

import jax

from mgnns_tpu.config import DataConfig as JDataConfig
from mgnns_tpu.config import ModelConfig as JModelConfig
from mgnns_tpu.config import TextGraphConfig as JTextGraphConfig
from mgnns_tpu.data.dataset import TumblrDataset as JTumblrDataset
from mgnns_tpu.engine import metrics as JM
from mgnns_tpu.graphs.cooccur import gen_A
from mgnns_tpu.graphs.pmi import cal_pmi, doc_window_edge_ids
from mgnns_tpu.graphs.vocab import build_vocab, make_word_to_id, words_to_ids
from mgnns_tpu.models.mgnns import mgnns_init as j_mgnns_init

from mgnns_tpu_torch import convert
from mgnns_tpu_torch.config import DataConfig, ModelConfig, TextGraphConfig
from mgnns_tpu_torch.data.dataset import TumblrDataset
from mgnns_tpu_torch.engine import metrics as M
from mgnns_tpu_torch.graphs.pmi import PmiGraph
from mgnns_tpu_torch.engine.train import cross_entropy
from mgnns_tpu_torch.models.mgnns import mgnns_apply
from mgnns_tpu_torch.utils import tree_leaves, tree_unflatten

CPU = "cpu"
AUX_W = 0.3  # weight of the head-diversity term in the fusion loss


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


CORPUS = ["the cat sat on the mat", "a dog met a cat", "the mat sat still",
          "dogs and cats and logs"]


def build_toy():
    """The shapes of tests/test_full_parity.py:245 (image 64, 5/6 label
    classes, L=10, ngram 2) and labels for the loss."""
    L, ngram, obj_c, plc_c = 10, 2, 5, 6
    vocab = build_vocab(CORPUS, 1)
    graph = cal_pmi(CORPUS, vocab, ngram + 1, 1, max_len=L)
    r = np.random.default_rng(0)
    oA, _ = gen_A(obj_c, 0.4, {"nums": r.integers(1, 5, obj_c).astype(float),
                               "adj": r.integers(0, 4, (obj_c, obj_c)).astype(float)})
    pA, _ = gen_A(plc_c, 0.3, {"nums": r.integers(1, 5, plc_c).astype(float),
                               "adj": r.integers(0, 4, (plc_c, plc_c)).astype(float)})
    kw = dict(vocab_size=len(vocab), edges_num=graph.num_edges, image_size=64,
              object_num_classes=obj_c, place_num_classes=plc_c, dropout=0.0,
              text_dropout=0.0, is_regu=True)
    jparams, jstate, jconsts = j_mgnns_init(
        jax.random.key(0), JModelConfig(**kw), num_edges=graph.num_edges,
        label_embedding=r.standard_normal((7, 300)).astype(np.float32), object_A=oA, place_A=pA)
    # a repeated word ("the", "a", "and") in three of the four documents
    w2i = make_word_to_id(vocab)
    B = len(CORPUS)
    ids = np.zeros((B, L), np.int32)
    lens = np.zeros((B,), np.int32)
    for n, txt in enumerate(CORPUS):
        toks = words_to_ids(txt.split(" "), w2i)[:L]
        ids[n, : len(toks)] = toks
        lens[n] = len(toks)
    batch = {"ids": ids, "lens": lens,
             "mask": (np.arange(L)[None] < lens[:, None]).astype(np.float32),
             "eids": doc_window_edge_ids(ids, lens, ngram, graph),
             "image": r.standard_normal((B, 64, 64, 3)).astype(np.float32),
             "label": r.integers(0, 7, B).astype(np.int32),
             "weight": np.array([1, 1, 1, 0], np.float32)}
    object_inp = r.standard_normal((obj_c, 300)).astype(np.float32)
    place_inp = r.standard_normal((plc_c, 300)).astype(np.float32)
    params, stats, consts = convert.from_jax_params(
        np_tree(jparams), np_tree(jstate),
        dict(np_tree(jconsts), object_inp=object_inp, place_inp=place_inp), device=CPU)
    return dict(kw=kw, graph=graph, vocab=vocab, jparams=jparams, jstate=jstate, jconsts=jconsts,
                object_inp=object_inp, place_inp=place_inp, params=params, stats=stats,
                consts=consts, batch=batch)


def port_grads(apply, params, batch):
    """(loss, aux, new_stats, gradient tree) of ``apply`` at ``params``."""
    leaves = tree_leaves(params)
    live = [p.detach().clone().requires_grad_() for p in leaves]
    loss, aux, new_stats = apply(tree_unflatten(params, live), batch)
    grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(live, grads)]
    return float(loss.detach()), aux, new_stats, tree_unflatten(params, grads)


def leaf_errors(got, want) -> dict:
    """{leaf path: (scale-relative max error, scale)} of two trees."""
    out = {}

    def walk(g, w, path):
        if isinstance(g, dict):
            for k in g:
                walk(g[k], w[k], f"{path}/{k}")
        elif isinstance(g, list):
            for i, (a, b) in enumerate(zip(g, w)):
                walk(a, b, f"{path}/{i}")
        else:
            g = g.detach().double().numpy()
            w = w.detach().double().numpy() if isinstance(w, torch.Tensor) else np.asarray(w, np.float64)
            scale = max(np.abs(g).max(), np.abs(w).max(), 1e-8)
            out[path] = (np.abs(g - w).max() / scale, scale)

    walk(got, want, "")
    return out


def compare_trees(got, want, tol_for):
    """Scale-relative max error per leaf, against a tolerance per leaf path.
    A leaf's scale is floored at 1e-3 of the largest leaf's: gradients a
    thousand times smaller than the rest (attention over saturated
    softmaxes) are compared in absolute terms."""
    errs = leaf_errors(got, want)
    floor = 1e-3 * max(scale for _, scale in errs.values())
    bad = [(err * scale / max(scale, floor), path, scale) for path, (err, scale) in errs.items()
           if err * scale / max(scale, floor) > tol_for(path)]
    assert not bad, sorted(bad, reverse=True)[:10]


def fusion_case(f, freeze_trunks, remat_policy="none", remat_trunks=False):
    return dataclasses.replace(ModelConfig(**f["kw"]), freeze_trunks=freeze_trunks,
                               remat_policy=remat_policy, remat_trunks=remat_trunks)


def port_fusion(f, cfg):
    def apply(p, batch):
        logits, new_stats, aux = mgnns_apply(
            p, f["stats"], f["consts"],
            {k: torch.from_numpy(v) for k, v in batch.items()}, cfg=cfg, train=True,
            generator=torch.Generator().manual_seed(0))
        loss = cross_entropy(logits, torch.from_numpy(batch["label"]),
                             torch.from_numpy(batch["weight"]))
        return loss + AUX_W * aux["head_diversity"], aux, new_stats

    return port_grads(apply, f["params"], f["batch"])


def frobenius_errors(got, want) -> dict:
    """{leaf path: ||got - want|| / ||want||}."""
    out = {}
    for (path, _), g, w in zip(leaf_errors(got, want).items(), tree_leaves(got), tree_leaves(want)):
        g, w = g.detach().double(), w.detach().double()
        out[path] = float((g - w).norm() / max(float(w.norm()), 1e-12))
    return out


# ----------------------------------------------------------------- engines

LABELS = ["angry", "bored", "calm", "fear", "happy", "love", "sad"]
ENGINE_CORPUS = [
    "happy joy smile great day", "sad cry tears bad day", "joy smile happy fun",
    "cry bad sad terrible", "great fun smile joy", "terrible tears bad cry",
    "calm quiet day joy", "fear dark night cry", "love smile heart fun", "bored day quiet",
]


def records():
    return [{"id": f"r{i}", "text": t, "image": f"img{i}.png", "label": LABELS[i % 7]}
            for i, t in enumerate(ENGINE_CORPUS)]


def make_data(root: str) -> dict:
    """A data root with label.json, and the vocab and PMI graph of
    ENGINE_CORPUS."""
    with open(os.path.join(root, "label.json"), "w") as f:
        json.dump({n: i for i, n in enumerate(LABELS)}, f)
    vocab = build_vocab(ENGINE_CORPUS, 1)
    graph = cal_pmi(ENGINE_CORPUS, vocab, 3, 1, max_len=8)
    return dict(root=root, vocab=vocab, graph=graph)


def datasets(data, image_size=32, backend="synthetic", image_root=".", train=False):
    jds = JTumblrDataset(
        JDataConfig(data_root_path=data["root"], image_backend=backend, image_root=image_root),
        JTextGraphConfig(ngram=2, max_len=8), "train", data["vocab"], data["graph"],
        image_size=image_size, records=records(), train_transforms=train)
    ds = TumblrDataset(
        DataConfig(data_root_path=data["root"], image_backend=backend, image_root=image_root),
        TextGraphConfig(ngram=2, max_len=8), "train", data["vocab"],
        PmiGraph(data["graph"].vocab_size, data["graph"].keys, data["graph"].pmi),
        image_size=image_size, records=records(), train_transforms=train)
    return jds, ds


def step_losses(jeng, eng, jloader, loader, steps):
    jl, pl = [], []
    jcm, cm = JM.confusion_init(7), M.confusion_init(7, CPU)
    for jb, pb in zip(jloader, loader):
        jeng.state, loss, jcm = jeng._train_step(jeng.state, jb, jcm)
        jl.append(float(loss))
        pl.append(float(eng.train_step(pb, cm)))
        if len(pl) == steps:
            break
    np.testing.assert_array_equal(cm.numpy(), np.asarray(jcm))
    return np.array(pl), np.array(jl)
