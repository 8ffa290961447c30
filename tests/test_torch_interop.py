"""Checkpoint interop and the dead modules of the port against the JAX
package, on the CPU: reference-named ``state_dict``s both ways
(``mgnns_tpu_torch.models.import_reference`` against
``mgnns_tpu.models.import_reference``), the GRU, the positional encoding, the
co-attention block, the ``ops`` namespace, and the optimizer's freezing of
the dead modules."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mgnns_tpu.ops as jops
from mgnns_tpu.config import ModelConfig as JModelConfig
from mgnns_tpu.data.text import encode_texts as j_encode_texts
from mgnns_tpu.graphs.cooccur import gen_A
from mgnns_tpu.graphs.pmi import cal_pmi
from mgnns_tpu.graphs.vocab import build_vocab, make_word_to_id
from mgnns_tpu.config import TextGraphConfig as JTextGraphConfig
from mgnns_tpu.models import import_reference as JIR
from mgnns_tpu.models import mgnns_apply as j_mgnns_apply
from mgnns_tpu.models.mgnns import mgnns_init as j_mgnns_init
from mgnns_tpu.nn import attention as jattention
from mgnns_tpu.nn import coattention as jcoattention
from mgnns_tpu.nn import lstm as jlstm

import mgnns_tpu_torch.ops as pops
from mgnns_tpu_torch import convert
from mgnns_tpu_torch.config import ModelConfig
from mgnns_tpu_torch.engine.optim import Optimizer
from mgnns_tpu_torch.models import import_reference as IR
from mgnns_tpu_torch.models.mgnns import DEAD_MODULES, mgnns_apply
from mgnns_tpu_torch.nn import attention, coattention, lstm
from mgnns_tpu_torch.utils import tree_leaves, tree_map, tree_paths
from tests.torch_train_common import few_torch_threads  # noqa: F401  (autouse fixture)
from tests.torch_train_common import CPU, np_tree

CORPUS = ["the cat sat on the mat", "a dog met a cat", "the mat sat still",
          "dogs and cats and logs"]


@pytest.fixture(scope="module")
def built():
    """A JAX fusion model with its dead modules at small shapes (image 64,
    5/6 label classes, L=10, ngram 2), its reference export, the port's twin
    by ``convert``, and a parity batch."""
    L, ngram, obj_c, plc_c = 10, 2, 5, 6
    vocab = build_vocab(CORPUS, 1)
    graph = cal_pmi(CORPUS, vocab, ngram + 1, 1, max_len=L)
    r = np.random.default_rng(0)
    kw = dict(vocab_size=len(vocab), edges_num=graph.num_edges, image_size=64,
              object_num_classes=obj_c, place_num_classes=plc_c)
    oA, _ = gen_A(obj_c, 0.4, {"nums": r.integers(1, 5, obj_c).astype(float),
                               "adj": r.integers(0, 4, (obj_c, obj_c)).astype(float)})
    pA, _ = gen_A(plc_c, 0.3, {"nums": r.integers(1, 5, plc_c).astype(float),
                               "adj": r.integers(0, 4, (plc_c, plc_c)).astype(float)})
    jparams, jstate, jconsts = j_mgnns_init(
        jax.random.key(0), JModelConfig(**kw), num_edges=graph.num_edges,
        label_embedding=r.standard_normal((7, 300)).astype(np.float32), object_A=oA,
        place_A=pA, include_dead_modules=True)
    object_inp = r.standard_normal((obj_c, 300)).astype(np.float32)
    place_inp = r.standard_normal((plc_c, 300)).astype(np.float32)
    params, stats, consts = convert.from_jax_params(
        np_tree(jparams), np_tree(jstate),
        dict(np_tree(jconsts), object_inp=object_inp, place_inp=place_inp), device=CPU)
    ids, lens, mask, eids = j_encode_texts(CORPUS, make_word_to_id(vocab), graph,
                                           JTextGraphConfig(ngram=ngram, max_len=L))
    batch = {"ids": ids, "lens": lens, "mask": mask, "eids": eids,
             "image": r.standard_normal((len(CORPUS), 64, 64, 3)).astype(np.float32)}
    jsd = {k: np.array(v) for k, v in JIR.export_reference_state_dict(jparams, jstate).items()}
    return dict(kw=kw, jparams=jparams, jstate=jstate, jconsts=jconsts, jsd=jsd,
                object_inp=object_inp, place_inp=place_inp, params=params, stats=stats,
                consts=consts, batch=batch)


def _assert_trees_equal(got, want):
    """Same structure (dict keys in any order, list lengths), bit-equal
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
        assert got.dtype == torch.float32 and got.device.type == "cpu"
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def _port_logits(params, f):
    with torch.inference_mode():
        return mgnns_apply(params, f["stats"], f["consts"],
                           {k: torch.from_numpy(v) for k, v in f["batch"].items()},
                           cfg=ModelConfig(**f["kw"]))[0]


def test_jax_export_imports_as_convert_does(built):
    """A JAX reference export (dead modules included) imports in the port to
    the leaves ``convert`` makes of the same JAX params, exactly."""
    sd = {k: torch.from_numpy(v) for k, v in built["jsd"].items()}
    params, stats = IR.import_reference_state_dict(sd, device=CPU)
    assert set(DEAD_MODULES) <= set(params)
    _assert_trees_equal(params, built["params"])
    _assert_trees_equal(stats, built["stats"])


def test_port_export_equals_jax_export_and_jax_reimports_it(built):
    """The port's export has the JAX export's keys, shapes and values, and
    the JAX importer reads it back to the original JAX params exactly."""
    sd = IR.export_reference_state_dict(built["params"], built["stats"])
    assert sorted(sd) == sorted(built["jsd"])
    for k, v in built["jsd"].items():
        assert tuple(sd[k].shape) == v.shape, k
        np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)
    jp, js = JIR.import_reference_state_dict(sd)
    for want, got in ((built["jparams"], jp), (built["jstate"], js)):
        wl = jax.tree_util.tree_leaves_with_path(want)
        gl = jax.tree_util.tree_leaves_with_path(got)
        assert [p for p, _ in wl] == [p for p, _ in gl]
        for (path, a), (_, b) in zip(wl, gl):
            np.testing.assert_array_equal(np.asarray(b), np.asarray(a), err_msg=str(path))


def test_imported_fusion_logits_match_jax(built):
    """Logits of the imported params within the fusion tolerance the port
    holds to the JAX package (atol 5e-3, rtol 1e-3)."""
    params, _ = IR.import_reference_state_dict(
        {k: torch.from_numpy(v) for k, v in built["jsd"].items()}, device=CPU)
    full = {k: jnp.asarray(v) for k, v in built["batch"].items()}
    full.update(object_inp=jnp.asarray(built["object_inp"]),
                place_inp=jnp.asarray(built["place_inp"]))
    apply = jax.jit(lambda p, s, c, b: j_mgnns_apply(p, s, c, b, cfg=JModelConfig(**built["kw"]),
                                                     train=False)[0])
    want = np.asarray(apply(built["jparams"], built["jstate"], built["jconsts"], full))
    got = _port_logits(params, built).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=5e-3, rtol=1e-3)


def test_partial_dead_module_imports_as_absent_and_forward_ignores_dead(built):
    """A dead module with a key missing is left out of the import, the
    whole ones come in, and the forward is bit-equal with and without them."""
    sd = {k: torch.from_numpy(v) for k, v in built["jsd"].items()
          if k not in ("rnn.bias_hh_l1_reverse", "text_object_text_multi_head_att.pos_ffn.w_2.bias")}
    params, _ = IR.import_reference_state_dict(sd, device=CPU)
    assert "rnn" not in params and "text_object_text_mha" not in params
    assert {"object_gate", "place_linear_2", "text_place_text_mha", "text_head"} <= set(params)
    slim = {k: v for k, v in params.items() if k not in DEAD_MODULES}
    torch.testing.assert_close(_port_logits(params, built), _port_logits(slim, built),
                               rtol=0, atol=0)
    # and the export of the slim tree has no dead key
    assert not any(k.startswith(("rnn.", "text_features.Linear"))
                   for k in IR.export_reference_state_dict(slim, built["stats"]))


def test_mgnns_init_dead_modules_have_jax_shapes_and_leave_live_draws(built):
    """``include_dead_modules=True`` adds the JAX package's dead subtrees with
    its shapes, and the live parameters are the same draws as without."""
    from mgnns_tpu_torch.models.mgnns import mgnns_init

    kw = built["kw"]
    z = dict(num_edges=kw["edges_num"], label_embedding=np.zeros((7, 300)),
             object_A=np.eye(5), place_A=np.eye(6), object_inp=np.zeros((5, 300)),
             place_inp=np.zeros((6, 300)), device=CPU)
    with_dead, _, _ = mgnns_init(ModelConfig(**kw), include_dead_modules=True, **z)
    without, _, _ = mgnns_init(ModelConfig(**kw), **z)
    shapes = lambda t: {p: tuple(x.shape) for p, x in zip(tree_paths(t), tree_leaves(t))}  # noqa: E731
    jdead = {k: v for k, v in built["jparams"].items() if k in DEAD_MODULES}
    want = {p: tuple(np.shape(x)) for p, x in zip(
        tree_paths(np_tree(jdead)), tree_leaves(np_tree(jdead)))}
    assert shapes({k: with_dead[k] for k in DEAD_MODULES}) == want
    _assert_trees_equal({k: v for k, v in with_dead.items() if k not in DEAD_MODULES}, without)


@pytest.mark.parametrize("num_layers,bidirectional", [(1, False), (1, True), (2, False), (2, True)])
def test_gru_matches_jax_and_torch_packed(num_layers, bidirectional):
    """The port's GRU against ``mgnns_tpu``'s ``gru_apply`` and a packed
    ``torch.nn.GRU`` (tests/test_dead_modules.py:48-69), 1e-5."""
    B, L, D, H = 5, 9, 6, 4
    r = np.random.default_rng(num_layers * 2 + bidirectional)
    x = r.standard_normal((B, L, D)).astype(np.float32)
    lens = np.array([9, 7, 1, 4, 0], np.int32)
    params = lstm.gru_init(torch.Generator().manual_seed(0), D, H, num_layers, bidirectional)
    out, h = lstm.gru_apply(params, torch.from_numpy(x), torch.from_numpy(lens))
    jout, jh = jlstm.gru_apply(jax.tree.map(lambda t: jnp.asarray(t.numpy()), params),
                               jnp.asarray(x), jnp.asarray(lens))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-5)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=1e-5)

    tl = torch.nn.GRU(D, H, num_layers, bidirectional=bidirectional, batch_first=True)
    with torch.no_grad():
        for l, dirs in enumerate(params["layers"]):
            for d, p in enumerate(dirs):
                suf = "_reverse" if d == 1 else ""
                for name in ("w_ih", "w_hh"):
                    getattr(tl, f"weight_{name[2:]}_l{l}{suf}").copy_(p[name].T)
                for name in ("b_ih", "b_hh"):
                    getattr(tl, f"bias_{name[2:]}_l{l}{suf}").copy_(p[name])
    keep = lens > 0  # pack_padded_sequence takes no empty sequence
    packed = torch.nn.utils.rnn.pack_padded_sequence(
        torch.from_numpy(x[keep]), torch.from_numpy(lens[keep]), batch_first=True,
        enforce_sorted=False)
    with torch.no_grad():
        out_t, h_t = tl(packed)
    out_t, _ = torch.nn.utils.rnn.pad_packed_sequence(out_t, batch_first=True, total_length=L)
    np.testing.assert_allclose(out.numpy()[keep], out_t.numpy(), atol=1e-5)
    np.testing.assert_allclose(h.numpy()[:, keep], h_t.numpy(), atol=1e-5)
    assert not out.numpy()[~keep].any()


def test_positional_encoding_matches_jax_and_stops_gradient():
    table = attention.positional_encoding_table(14, n_position=23, device=CPU)
    np.testing.assert_allclose(table.numpy(), np.asarray(jattention.positional_encoding_table(
        14, n_position=23)), atol=1e-6)
    x = torch.randn(2, 7, 14, generator=torch.Generator().manual_seed(0))
    t = table.clone().requires_grad_()
    y = attention.add_positional_encoding(x, t)
    torch.testing.assert_close(y - x, table[:7].expand(2, 7, 14))
    assert not y.requires_grad


def test_coattention_matches_jax():
    """``coattention_apply`` and the masked helpers against the JAX package
    on the same weights, 1e-5."""
    B, L, No, Np, T, O, P = 3, 6, 4, 5, 8, 7, 9
    r = np.random.default_rng(0)
    p = coattention.coattention_init(torch.Generator().manual_seed(0), T, O, P)
    jp = jax.tree.map(lambda t: jnp.asarray(t.numpy()), p)
    mask = np.ones((B, L), np.float32)
    mask[1, 3:] = 0.0
    mask[2, 1:] = 0.0
    args = [r.standard_normal(s).astype(np.float32)
            for s in ((B, T), (B, L, T), (B, O), (B, No, O), (B, P), (B, Np, P))] + [mask]
    got = coattention.coattention_apply(p, *map(torch.from_numpy, args))
    want = jax.jit(jcoattention.coattention_apply)(jp, *map(jnp.asarray, args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    x, logit = args[1], r.standard_normal((B, L)).astype(np.float32)
    for name, a in (("masked_mean", x), ("masked_max", x), ("masked_softmax", logit)):
        for m in (None, mask):
            got = getattr(coattention, name)(torch.from_numpy(a),
                                             None if m is None else torch.from_numpy(m))
            want = jax.jit(getattr(jcoattention, name))(jnp.asarray(a),
                                                        None if m is None else jnp.asarray(m))
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, err_msg=name)
    assert "b" not in p["v_text_object"] and "b" in p["linear"]


def test_ops_namespace_has_the_jax_names():
    """``mgnns_tpu_torch.ops`` exports ``mgnns_tpu.ops``'s names, the Pallas
    entry point's apart; its ``window_max_aggregate`` is the K1 wrapper."""
    from mgnns_tpu_torch.kernels import edge_max

    assert set(pops.__all__) == set(jops.__all__) - {"window_max_aggregate_pallas"}
    assert pops.window_max_aggregate is edge_max.window_max_aggregate
    for name in pops.__all__:
        if name.endswith("_init"):
            assert name[:-5] + "_apply" in pops.__all__, name


@pytest.mark.parametrize("faithful", [False, True])
def test_optimizer_freezes_dead_modules(faithful):
    """An Adam step with weight decay leaves the dead modules as they were
    (they get no gradient, as autograd gives them), and moves the live
    leaves exactly as the same step on the tree without them."""
    g = torch.Generator().manual_seed(0)
    live = {"text_gcn": {"node_embedding": torch.randn(6, 4, generator=g)},
            "lstm": lstm.lstm_init(g, 4, 3, 1, False),
            "multi_linear_1": {"w": torch.randn(4, 3, generator=g), "b": torch.randn(3, generator=g)}}
    dead = {"rnn": lstm.gru_init(g, 4, 3, 1, True),
            "object_gate": {"w": torch.randn(4, 4, generator=g), "b": torch.randn(4, generator=g)},
            "text_head": {"w": torch.randn(4, 2, generator=g), "b": torch.randn(2, generator=g)}}
    grads_live = [torch.randn(t.shape, generator=g) for t in tree_leaves(live)]
    results = []
    for tree in ({**live, **dead}, dict(live)):
        tree = tree_map(torch.clone, tree)
        opt = Optimizer(tree, lr=1e-2, weight_decay=1e-2, faithful=faithful)
        state = opt.init(tree)
        leaves = tree_leaves(tree)
        names = tree_paths(tree)
        it = iter(grads_live)
        grads = [None if n.split("/")[1] in DEAD_MODULES else next(it) for n in names]
        opt.apply(leaves, grads, state)
        results.append(dict(zip(names, leaves)))
    with_dead, without = results
    for name, before in zip(tree_paths(dead), tree_leaves(dead)):
        torch.testing.assert_close(with_dead[name], before, rtol=0, atol=0)
    for name, t in without.items():
        torch.testing.assert_close(with_dead[name], t, rtol=0, atol=0)
    assert any(not torch.equal(with_dead[n], t) for n, t in zip(tree_paths(live), tree_leaves(live)))
