"""Each ported nn module against its JAX counterpart on the CPU.

The JAX package's initializers make the weights, ``mgnns_tpu_torch.convert``
carries them across, and numpy-seeded inputs go to both.  Tolerances: 1e-5
for the small float32 modules (sums in another order), scale-relative 1e-3
for the ResNet trunks (dozens of stacked convolutions)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mgnns_tpu.graphs.cooccur import gen_adj as j_gen_adj
from mgnns_tpu.nn import attention as jatt
from mgnns_tpu.nn import core as jcore
from mgnns_tpu.nn import image_gcn as jgcn
from mgnns_tpu.nn import lstm as jlstm
from mgnns_tpu.nn import resnet as jresnet
from mgnns_tpu.nn import text_gcn as jtext_gcn

from mgnns_tpu_torch import convert
from mgnns_tpu_torch.graphs.cooccur import gen_adj
from mgnns_tpu_torch.nn import attention, core, image_gcn, lstm, resnet, text_gcn

ATOL = RTOL = 1e-5


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(tree):
    return convert.to_torch(_np(tree), device="cpu")


def _close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=rtol)


@pytest.mark.parametrize("case", ["distinct", "duplicates"])
def test_text_gcn_apply(case):
    """Duplicate words exercise the first-occurrence scatter-max readout."""
    V, D, E, B, L, ngram = 30, 8, 12, 4, 10, 2
    r = np.random.default_rng(0)
    jp = jtext_gcn.text_gcn_init(jax.random.key(0), V, D, E,
                                 edge_weights=r.uniform(-1, 2, (E, 1)).astype(np.float32))
    hi = 4 if case == "duplicates" else V
    ids = r.integers(1, hi, (B, L)).astype(np.int32)
    lens = np.array([10, 1, 7, 4], np.int32)
    ids[np.arange(L)[None, :] >= lens[:, None]] = 0
    eids = r.integers(0, E, (B, L, 2 * ngram + 1)).astype(np.int32)
    want = jtext_gcn.text_gcn_apply(jp, jnp.asarray(ids), jnp.asarray(lens),
                                    jnp.asarray(eids), ngram=ngram)
    got = text_gcn.text_gcn_apply(_t(jp), torch.from_numpy(ids), torch.from_numpy(lens),
                                  torch.from_numpy(eids), ngram=ngram)
    _close(got, want)


def test_unique_word_readout():
    r = np.random.default_rng(1)
    B, L, D = 3, 12, 5
    per_pos = r.standard_normal((B, L, D)).astype(np.float32)
    ids = r.integers(1, 5, (B, L)).astype(np.int32)
    lens = np.array([12, 3, 1], np.int32)
    per_pos[np.arange(L)[None, :] >= lens[:, None]] = -np.inf
    want = jtext_gcn.unique_word_readout(jnp.asarray(per_pos), jnp.asarray(ids), jnp.asarray(lens))
    got = text_gcn.unique_word_readout(torch.from_numpy(per_pos), torch.from_numpy(ids),
                                       torch.from_numpy(lens))
    _close(got, want)


def test_lstm_apply():
    """Masked 2-layer BiLSTM: memory bank and final states, lens 1 and L."""
    B, L, D, H = 4, 9, 6, 5
    r = np.random.default_rng(2)
    jp = jlstm.lstm_init(jax.random.key(3), D, H, 2, True)
    x = r.standard_normal((B, L, D)).astype(np.float32)
    lens = np.array([9, 1, 5, 3], np.int32)
    out_w, (h_w, c_w) = jlstm.lstm_apply(jp, jnp.asarray(x), jnp.asarray(lens))
    out_g, (h_g, c_g) = lstm.lstm_apply(_t(jp), torch.from_numpy(x), torch.from_numpy(lens))
    assert out_g.shape == (B, L, 2 * H) and h_g.shape == (4, B, H)
    for g_, w_ in ((out_g, out_w), (h_g, h_w), (c_g, c_w)):
        _close(g_, w_)


@pytest.mark.parametrize("depth", [50, 101])
def test_resnet_apply(depth):
    """Trunk at 64 px (2x2 feature grid) with non-trivial running stats."""
    r = np.random.default_rng(depth)
    jp, js = jresnet.resnet_init(jax.random.key(depth), depth=depth)
    js = jax.tree.map(lambda a: jnp.asarray(r.uniform(0.5, 1.5, a.shape).astype(np.float32)), js)
    x = r.standard_normal((2, 64, 64, 3)).astype(np.float32)
    want, _ = jresnet.resnet_apply(jp, js, jnp.asarray(x), depth=depth)
    with torch.inference_mode():
        got, _ = resnet.resnet_apply(convert.resnet_from_jax(_np(jp), device="cpu"),
                                     convert.resnet_from_jax(_np(js), device="cpu"),
                                     torch.from_numpy(x))
    assert got.shape == (2, 2, 2, 2048)
    want = np.asarray(want)
    _close(got, want, atol=1e-3 * np.abs(want).max(), rtol=0)


def test_graph_conv_and_gen_adj():
    r = np.random.default_rng(4)
    C = 6
    A = r.uniform(0.1, 1.0, (C, C)).astype(np.float32)
    _close(gen_adj(torch.from_numpy(A)), j_gen_adj(jnp.asarray(A)))
    jp = jgcn.graph_conv_init(jax.random.key(4), 16, 32)
    x = r.standard_normal((C, 16)).astype(np.float32)
    adj = np.array(j_gen_adj(jnp.asarray(A)))
    _close(image_gcn.graph_conv_apply(_t(jp), torch.from_numpy(x), torch.from_numpy(adj)),
           jgcn.graph_conv_apply(jp, jnp.asarray(x), jnp.asarray(adj)))


@pytest.mark.parametrize("masked", [False, True], ids=["no_mask", "mask"])
def test_my_mha_apply(masked):
    B, L, d, H, dkv = 3, 7, 12, 4, 6
    r = np.random.default_rng(5)
    jp = jatt.my_mha_init(jax.random.key(5), H, d, dkv)
    q = r.standard_normal((B, d)).astype(np.float32)
    kv = r.standard_normal((B, L, d)).astype(np.float32)
    mask = None
    if masked:
        mask = (np.arange(L)[None, :] < np.array([7, 1, 4])[:, None]).astype(np.float32)
    want_out, want_attn = jatt.my_mha_apply(
        jp, jnp.asarray(q), jnp.asarray(kv), jnp.asarray(kv),
        None if mask is None else jnp.asarray(mask), n_head=H, d_kv=dkv)
    got_out, got_attn = attention.my_mha_apply(
        _t(jp), torch.from_numpy(q), torch.from_numpy(kv), torch.from_numpy(kv),
        None if mask is None else torch.from_numpy(mask), n_head=H, d_kv=dkv)
    _close(got_out, want_out)
    _close(got_attn, want_attn)


def test_label_attention_apply():
    r = np.random.default_rng(6)
    jp = jatt.label_attention_init(jax.random.key(6), 300, 5)
    query = r.standard_normal((7, 300)).astype(np.float32)
    x = r.standard_normal((3, 5)).astype(np.float32)
    want = jatt.label_attention_apply(jp, jnp.asarray(query), jnp.asarray(x), jnp.asarray(x),
                                      n_heads=5)
    got = attention.label_attention_apply(_t(jp), torch.from_numpy(query), torch.from_numpy(x),
                                          torch.from_numpy(x), n_heads=5)
    assert got.shape == (3, 7, 300)
    _close(got, want)


@pytest.mark.parametrize("op", ["linear", "layer_norm", "leaky_relu", "embedding"])
def test_core_ops(op):
    r = np.random.default_rng(7)
    x = r.standard_normal((4, 6, 10)).astype(np.float32) * 3
    if op == "linear":
        jp = jcore.linear_init(jax.random.key(7), 10, 5)
        _close(core.linear(_t(jp), torch.from_numpy(x)), jcore.linear_apply(jp, jnp.asarray(x)))
    elif op == "layer_norm":
        p = {"gamma": r.standard_normal(10).astype(np.float32),
             "beta": r.standard_normal(10).astype(np.float32)}
        _close(core.layer_norm(_t(p), torch.from_numpy(x)),
               jcore.layer_norm_apply(jax.tree.map(jnp.asarray, p), jnp.asarray(x)))
    elif op == "leaky_relu":
        _close(core.leaky_relu(torch.from_numpy(x)), jcore.leaky_relu(jnp.asarray(x)))
    else:
        jp = jcore.embedding_init(jax.random.key(0), 9, 10, padding_idx=0)
        ids = r.integers(0, 9, (3, 4))
        _close(core.embedding(_t(jp)["table"], torch.from_numpy(ids)),
               jcore.embedding_apply(jp, jnp.asarray(ids)))
        p = core.embedding_init(torch.Generator().manual_seed(0), 9, 10)
        assert p["table"].shape == (9, 10) and (p["table"][0] == 0).all() and p["table"][1].any()
