"""The port's text-only and fusion models in train mode against the JAX
package on the CPU: losses, every gradient, the new BatchNorm statistics
and head diversity (dropout 0: the two packages' masks cannot agree).

Weights come from the JAX package's initializers through
``mgnns_tpu_torch.convert``; inputs from numpy seeds (the shapes of
tests/test_full_parity.py:245)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mgnns_tpu.config import ModelConfig as JModelConfig
from mgnns_tpu.engine.train import cross_entropy as j_cross_entropy
from mgnns_tpu.models import mgnns_apply as j_mgnns_apply
from mgnns_tpu.models import text_model_apply as j_text_model_apply
from mgnns_tpu.models import text_model_init as j_text_model_init

from mgnns_tpu_torch import convert
from mgnns_tpu_torch.engine.train import cross_entropy
from mgnns_tpu_torch.models.text_only import text_model_apply
from mgnns_tpu_torch.utils import tree_leaves
from tests.torch_train_common import (
    AUX_W, CPU, build_toy, compare_trees, fusion_case, frobenius_errors, np_tree,
    port_fusion, port_grads,
)


@pytest.fixture(scope="module")
def toy():
    return build_toy()


def test_text_model_train_grads_match_jax(toy):
    """Loss and every gradient of CE(text_model_apply(train=True)) against
    jax.grad with the Pallas kernel (interpret mode), rtol 1e-5."""
    f = toy
    jparams = j_text_model_init(jax.random.key(1), len(f["vocab"]), 7, f["graph"].num_edges,
                                edge_weights=np.random.default_rng(2).uniform(
                                    0.5, 1.5, (f["graph"].num_edges, 1)).astype(np.float32))
    params = convert.text_model_from_jax_params(np_tree(jparams), device=CPU)
    b = f["batch"]
    keys = ("ids", "lens", "eids")

    def jloss(p):
        logits = j_text_model_apply(p, {k: jnp.asarray(b[k]) for k in keys}, ngram=2,
                                    dropout_rate=0.0, train=True, rng=jax.random.key(0),
                                    use_pallas=True)
        return j_cross_entropy(logits, jnp.asarray(b["label"]), jnp.asarray(b["weight"]))

    want_loss, want = jax.jit(jax.value_and_grad(jloss))(jparams)

    def apply(p, batch):
        logits = text_model_apply(p, {k: torch.from_numpy(batch[k]) for k in keys}, ngram=2,
                                  dropout_rate=0.0, train=True,
                                  generator=torch.Generator().manual_seed(0))
        return cross_entropy(logits, torch.from_numpy(batch["label"]),
                             torch.from_numpy(batch["weight"])), None, None

    loss, _, _, grads = port_grads(apply, params, b)
    assert abs(loss - float(want_loss)) <= 1e-5 * abs(float(want_loss))
    compare_trees(grads, convert.text_model_from_jax_params(np_tree(want), device=CPU),
                  lambda path: 1e-5)


@pytest.fixture(scope="module", params=[False, True], ids=["batch_bn", "freeze_trunks"])
def fusion_pair(toy, request):
    """The JAX and port train-mode fusion step (bn_mode 'batch', is_regu,
    dropout 0), with or without frozen trunks."""
    f = toy
    freeze = request.param
    jcfg = dataclasses.replace(JModelConfig(**f["kw"]), freeze_trunks=freeze)
    full = {k: jnp.asarray(v) for k, v in f["batch"].items() if k not in ("label", "weight")}
    full["object_inp"] = jnp.asarray(f["object_inp"])
    full["place_inp"] = jnp.asarray(f["place_inp"])

    def jloss(p):
        logits, new_state, aux = j_mgnns_apply(p, f["jstate"], f["jconsts"], full, cfg=jcfg,
                                               train=True, rng=jax.random.key(0))
        loss = j_cross_entropy(logits, jnp.asarray(f["batch"]["label"]),
                               jnp.asarray(f["batch"]["weight"]))
        return loss + AUX_W * aux["head_diversity"], (new_state, aux)

    (jl, (jstate, jaux)), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(f["jparams"])
    want = dict(loss=float(jl), stats=jstate, aux=jaux, grads=jgrads)
    got = dict(zip(("loss", "aux", "stats", "grads"), port_fusion(f, fusion_case(f, freeze))))
    return freeze, want, got


def test_fusion_train_loss_and_head_diversity_match_jax(fusion_pair):
    _, want, got = fusion_pair
    assert abs(got["loss"] - want["loss"]) <= 5e-4 * abs(want["loss"])
    np.testing.assert_allclose(float(got["aux"]["head_diversity"].detach()),
                               float(want["aux"]["head_diversity"]), atol=1e-5, rtol=0)


def test_fusion_train_grads_match_jax(fusion_pair):
    """Every gradient leaf against the JAX package's.

    With frozen trunks (BatchNorm on running statistics) the leaves hold the
    tolerance of tests/test_full_parity.py:398-419, 5e-3 of scale.  Train-mode
    BatchNorm through randomly initialized trunks is ill-conditioned in
    float32: each package's trunk gradients move by several percent from a
    float64 run of the same maths, the JAX package's the more, and a few
    leaves by far more where a max-pool or ReLU tie flips.  There the trunk
    leaves are held to a Frobenius-relative 0.15 and the other leaves, some
    of which read the trunk features, to 1e-2 of scale; the BatchNorm maths
    itself is held tightly one layer at a time
    (tests/test_torch_train.py::test_train_batch_norm_matches_jax)."""
    freeze, want, got = fusion_pair
    want_grads = convert.params_from_jax(np_tree(want["grads"]), device=CPU)
    if freeze:  # no trunk backward at all
        assert all(float(t.abs().max()) == 0.0 for side in ("object_trunk", "place_trunk")
                   for t in tree_leaves(got["grads"][side]))
        compare_trees(got["grads"], want_grads, lambda path: 5e-3)
        return
    trunks = ("object_trunk", "place_trunk")
    compare_trees({k: v for k, v in got["grads"].items() if k not in trunks},
                   {k: v for k, v in want_grads.items() if k not in trunks}, lambda path: 1e-2)
    fro = frobenius_errors({k: got["grads"][k] for k in trunks}, {k: want_grads[k] for k in trunks})
    bad = sorted(((e, p) for p, e in fro.items() if e > 0.15), reverse=True)
    assert not bad, bad[:10]


def test_fusion_train_batch_stats_match_jax(fusion_pair):
    """The new running statistics within 1e-3 of scale: they summarize
    activations that have passed up to 100 train-mode BatchNorm layers in
    float32 (the update formula is held to 1e-5 one layer at a time); frozen
    trunks keep the old statistics exactly."""
    freeze, want, got = fusion_pair
    want_stats = {k: convert.resnet_from_jax(np_tree(want["stats"][k]), device=CPU)
                  for k in ("object_trunk", "place_trunk")}
    compare_trees(got["stats"], want_stats, lambda path: 1e-3)
    if freeze:
        assert got["stats"]["object_trunk"] is not None
        for a, b in zip(tree_leaves(got["stats"]), tree_leaves(convert.from_jax_params(
                np_tree(want["grads"]), np_tree(want["stats"]), {
                    "label_query": np.zeros(1), "object_inp": np.zeros(1),
                    "place_inp": np.zeros(1)}, device=CPU)[1])):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
