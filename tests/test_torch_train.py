"""The port's training maths against the JAX package on the CPU, module by
module: K2's plain backward, the autograd wiring around K1/K2, the
scatter-max readout's tied gradient, dropout and its generator streams, the
head-diversity regularizer and train-mode BatchNorm.  The whole models are
in tests/test_torch_train_models.py, the remat policies in
tests/test_torch_train_remat.py."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mgnns_tpu.kernels.edge_max import _backward as j_pallas_backward
from mgnns_tpu.kernels.edge_max import window_max_aggregate_pallas
from mgnns_tpu.nn import attention as jatt
from mgnns_tpu.nn import text_gcn as jtext_gcn

from mgnns_tpu_torch.kernels import edge_max
from mgnns_tpu_torch.nn import attention, core, text_gcn


# ------------------------------------------------------------------ K2


def _k2_inputs(seed, B=4, L=12, D=8, ngram=1, case="random"):
    """Lens include 1 and L.  ``ties``: three distinct rows and unit weights,
    so most in-window messages tie; ``constant``: the constant-input case of
    tests/test_kernels.py:78, where every message ties."""
    r = np.random.default_rng(seed)
    W = 2 * ngram + 1
    if case == "constant":
        emb = np.full((B, L, D), 0.5, np.float32)
        w = np.ones((B, L, W), np.float32)
    elif case == "ties":
        emb = r.standard_normal((B, 3, D)).astype(np.float32)[:, r.integers(0, 3, L), :]
        w = np.ones((B, L, W), np.float32)
        w[:, :, ::2] = -1.0
    else:
        emb = r.standard_normal((B, L, D)).astype(np.float32)
        w = r.uniform(-2, 2, (B, L, W)).astype(np.float32)
        w[:, :, 0] = 0.0
    lens = r.integers(1, L + 1, (B,)).astype(np.int32)
    lens[0], lens[-1] = 1, L
    g = r.standard_normal((B, L, D)).astype(np.float32)
    if case == "constant":
        g = np.broadcast_to(np.arange(1, D + 1, dtype=np.float32), (B, L, D)).copy()
    return np.ascontiguousarray(emb), w, lens, g


# g=0 is the degenerate window: one message a row, so no tie for ``constant``
# to split; g=4 is the model's window
K2_CASES = [(ngram, case) for ngram in (0, 1, 2, 3, 4) for case in ("random", "ties", "constant")
            if (ngram, case) != (0, "constant")]


@pytest.mark.parametrize("ngram,case", K2_CASES)
def test_backward_plain_equals_pallas_and_vjp(ngram, case):
    """The plain backward against the Pallas backward in interpret mode and
    against jax.vjp of the jnp forward, atol 1e-6, ties included."""
    emb, w, lens, g = _k2_inputs(ngram, ngram=ngram, case=case)
    ours = edge_max.window_max_aggregate_backward_plain(
        *(torch.from_numpy(a) for a in (emb, w, lens, g)), ngram)
    pallas = j_pallas_backward(jnp.asarray(emb), jnp.asarray(w), jnp.asarray(lens),
                               jnp.asarray(g), ngram, True)
    valid = jnp.asarray(np.arange(emb.shape[1])[None, :, None] < lens[:, None, None])
    _, vjp = jax.vjp(lambda e, ww: jtext_gcn.window_max_aggregate(e, ww, jnp.asarray(lens), ngram),
                     jnp.asarray(emb), jnp.asarray(w))
    ref = vjp(jnp.where(valid, jnp.asarray(g), 0.0))
    for o, p, v in zip(ours, pallas, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(p), atol=1e-6, rtol=0)
        np.testing.assert_allclose(o.numpy(), np.asarray(v), atol=1e-6, rtol=0)
    if case == "constant":  # the tie split leaves fractional gradient mass
        assert len(np.unique(np.round(ours[1].numpy(), 6))) > 2


@pytest.mark.parametrize("ngram", [1, 3])
def test_window_max_aggregate_autograd_matches_custom_vjp(ngram):
    """WindowMaxAggregate on CPU tensors against the JAX custom-VJP of the
    Pallas function, through a masked weighted sum."""
    emb, w, lens, g = _k2_inputs(ngram + 10, ngram=ngram, case="ties")
    valid = np.arange(emb.shape[1])[None, :, None] < lens[:, None, None]
    e = torch.from_numpy(emb).requires_grad_()
    ww = torch.from_numpy(w).requires_grad_()
    out = edge_max.window_max_aggregate(e, ww, torch.from_numpy(lens), ngram)
    (torch.where(torch.from_numpy(valid), out, 0.0) * torch.from_numpy(g)).sum().backward()

    def loss(e_, w_):
        m = window_max_aggregate_pallas(e_, w_, jnp.asarray(lens), ngram, True)
        return jnp.sum(jnp.where(jnp.asarray(valid), m, 0.0) * jnp.asarray(g))

    ge, gw = jax.grad(loss, argnums=(0, 1))(jnp.asarray(emb), jnp.asarray(w))
    np.testing.assert_allclose(e.grad.numpy(), np.asarray(ge), atol=1e-6, rtol=0)
    np.testing.assert_allclose(ww.grad.numpy(), np.asarray(gw), atol=1e-6, rtol=0)


def test_readout_splits_tied_gradient_like_jax():
    """A repeated phrase puts one word's maximum at two positions with equal
    values; the scatter-max backward splits its gradient evenly between
    them, as the JAX package's scatter-max VJP does."""
    B, L, D = 2, 8, 4
    r = np.random.default_rng(3)
    per_pos = r.standard_normal((B, L, D)).astype(np.float32)
    ids = np.array([[5, 6, 5, 6, 7, 0, 0, 0], [3, 3, 4, 3, 9, 9, 2, 1]], np.int32)
    lens = np.array([5, 8], np.int32)
    per_pos[0, 2] = per_pos[0, 0]            # word 5 ties at positions 0 and 2
    per_pos[1, 3] = per_pos[1, 0]            # word 3 ties at positions 0 and 3
    per_pos[np.arange(L)[None, :] >= lens[:, None]] = -np.inf
    up = r.standard_normal((B, D)).astype(np.float32)
    x = torch.from_numpy(per_pos).requires_grad_()
    (text_gcn.unique_word_readout(x, torch.from_numpy(ids), torch.from_numpy(lens))
     * torch.from_numpy(up)).sum().backward()
    want = jax.grad(lambda p: jnp.sum(jtext_gcn.unique_word_readout(
        p, jnp.asarray(ids), jnp.asarray(lens)) * jnp.asarray(up)))(jnp.asarray(per_pos))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want), atol=1e-6, rtol=0)
    np.testing.assert_allclose(x.grad.numpy()[0, 0], 0.5 * up[0])


# ------------------------------------------------------------------ dropout


@pytest.mark.parametrize("case", ["eval", "rate0", "no_generator"])
def test_dropout_identity(case):
    x = torch.randn(50, 40, generator=torch.Generator().manual_seed(0))
    g = None if case == "no_generator" else torch.Generator().manual_seed(1)
    out = core.dropout(x, 0.0 if case == "rate0" else 0.5, g, case != "eval")
    assert out is x


def test_dropout_mask_statistics():
    """Same seed, same mask; the kept fraction within 3 sigma of 1 - rate;
    kept entries scaled by 1 / (1 - rate)."""
    rate, n = 0.3, 200_000
    x = torch.rand(n, generator=torch.Generator().manual_seed(0)) + 0.5
    a = core.dropout(x, rate, torch.Generator().manual_seed(7), True)
    b = core.dropout(x, rate, torch.Generator().manual_seed(7), True)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    kept = a != 0
    frac = float(kept.float().mean())
    assert abs(frac - (1 - rate)) <= 3 * np.sqrt(rate * (1 - rate) / n)
    torch.testing.assert_close(a[kept], x[kept] / (1 - rate), rtol=0, atol=0)


def test_rng_stream_sites_are_independent():
    s1 = core.RngStream(torch.Generator().manual_seed(3))
    s2 = core.RngStream(torch.Generator().manual_seed(3))
    a = [torch.rand(4, generator=s1.next(n)) for n in ("x", "y")]
    b = [torch.rand(4, generator=s2.next(n)) for n in ("x", "y")]
    assert all(torch.equal(p, q) for p, q in zip(a, b))
    assert not torch.equal(a[0], a[1])
    assert core.RngStream(None).next("x") is None


@pytest.mark.parametrize("n_head", [1, 4])
def test_head_diversity_matches_jax(n_head):
    r = np.random.default_rng(n_head)
    heads = r.standard_normal((3, n_head, 6)).astype(np.float32)
    heads[0, 0] = 0.0  # an all-zero head: the sqrt guard keeps it finite
    x = torch.from_numpy(heads).requires_grad_()
    got = attention.head_diversity(x)
    want, vjp = jax.vjp(jatt.head_diversity, jnp.asarray(heads))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-6, rtol=1e-5)
    if n_head < 2:  # a constant 0, with no gradient
        assert not got.requires_grad and not np.asarray(vjp(jnp.ones(3))[0]).any()
        return
    got.sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(vjp(jnp.ones(3))[0]), atol=1e-6, rtol=1e-5)


# ------------------------------------------------------------- the models

@pytest.mark.parametrize("train", [True, False])
def test_train_batch_norm_matches_jax(train):
    """One BatchNorm layer against ``bn_apply``: the output, its gradients
    and the new running statistics (momentum 0.1, unbiased batch variance)
    within 1e-5."""
    from mgnns_tpu.nn import resnet as jresnet
    from mgnns_tpu_torch.nn import resnet

    r = np.random.default_rng(4)
    x = (r.standard_normal((4, 5, 3, 8)) * 3 + 1).astype(np.float32)   # NHWC
    p = {"scale": r.uniform(0.5, 1.5, 8).astype(np.float32),
         "bias": r.standard_normal(8).astype(np.float32)}
    st = {"mean": r.standard_normal(8).astype(np.float32),
          "var": r.uniform(0.5, 2.0, 8).astype(np.float32)}
    ct = r.standard_normal(x.shape).astype(np.float32)

    def jf(xx, pp):
        y, ns = jresnet.bn_apply(pp, jax.tree.map(jnp.asarray, st), xx, train=train)
        return jnp.sum(y * jnp.asarray(ct)), (y, ns)

    (_, (jy, jns)), (jgx, jgp) = jax.value_and_grad(jf, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x), jax.tree.map(jnp.asarray, p))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    pt = {k: torch.from_numpy(v).requires_grad_() for k, v in p.items()}
    y, ns = resnet.bn(pt, {k: torch.from_numpy(v) for k, v in st.items()}, xt, train=train)
    (y * torch.from_numpy(ct).permute(0, 3, 1, 2)).sum().backward()
    close = lambda a, b: np.testing.assert_allclose(a, np.asarray(b), atol=1e-5, rtol=1e-5)  # noqa: E731
    close(y.detach().permute(0, 2, 3, 1).numpy(), jy)
    close(xt.grad.permute(0, 2, 3, 1).numpy(), jgx)
    for k in ("scale", "bias"):
        close(pt[k].grad.numpy(), jgp[k])
    for k in ("mean", "var"):
        close(ns[k].numpy(), jns[k])
