"""K1 (windowed edge-max aggregation): the port's plain version against the
JAX package's Pallas kernel (interpret mode, as tests/test_kernels.py runs
it) and jnp reference, exactly; and the wrapper's guards.  The CUDA kernel
itself is held against the plain version in tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mgnns_tpu.kernels.edge_max import window_max_aggregate_pallas
from mgnns_tpu.nn.text_gcn import window_max_aggregate as j_window_max_aggregate

from mgnns_tpu_torch.kernels import edge_max


def _inputs(seed, B=4, L=16, D=8, ngram=2, ties=False):
    """Lens include 1 and L; with ``ties``, a vocabulary of 3 rows and unit
    weights make every in-window message tie (as tests/test_kernels.py:78)."""
    r = np.random.default_rng(seed)
    W = 2 * ngram + 1
    if ties:
        emb = r.standard_normal((B, 3, D)).astype(np.float32)[:, r.integers(0, 3, L), :]
        w = np.ones((B, L, W), np.float32)
        w[:, :, ::2] = -1.0
    else:
        emb = r.standard_normal((B, L, D)).astype(np.float32)
        w = r.uniform(-2, 2, (B, L, W)).astype(np.float32)
        w[:, :, 0] = 0.0  # zero weights give 0 * x messages
    lens = r.integers(1, L + 1, (B,)).astype(np.int32)
    lens[0], lens[-1] = 1, L
    return np.ascontiguousarray(emb), w, lens


@pytest.mark.parametrize("ties", [False, True], ids=["random", "ties"])
@pytest.mark.parametrize("ngram", [0, 1, 2, 4, 16])  # every window K1 instantiates, ends and model
def test_plain_equals_pallas_and_jnp(ngram, ties):
    emb, w, lens = _inputs(ngram, ngram=ngram, ties=ties)
    ours = edge_max.window_max_aggregate_plain(
        torch.from_numpy(emb), torch.from_numpy(w), torch.from_numpy(lens), ngram).numpy()
    pallas = np.asarray(window_max_aggregate_pallas(
        jnp.asarray(emb), jnp.asarray(w), jnp.asarray(lens), ngram, True))
    ref = np.asarray(j_window_max_aggregate(
        jnp.asarray(emb), jnp.asarray(w), jnp.asarray(lens), ngram))
    np.testing.assert_array_equal(ours, pallas)
    np.testing.assert_array_equal(ours, ref)
    valid = np.arange(emb.shape[1])[None, :] < lens[:, None]
    assert np.isneginf(ours[~valid]).all() and np.isfinite(ours[valid]).all()


def test_wrapper_takes_plain_version_on_cpu():
    emb, w, lens = _inputs(0)
    before = edge_max.launches
    args = (torch.from_numpy(emb), torch.from_numpy(w), torch.from_numpy(lens), 2)
    torch.testing.assert_close(edge_max.window_max_aggregate(*args),
                               edge_max.window_max_aggregate_plain(*args), rtol=0, atol=0)
    assert edge_max.launches == before  # no kernel launched on the CPU


@pytest.mark.parametrize("bad", ["emb_f64", "w_f16", "lens_i64", "shape", "strided"])
def test_wrapper_rejects(bad):
    emb, w, lens = (torch.from_numpy(a) for a in _inputs(0))
    err = TypeError
    if bad == "emb_f64":
        emb = emb.double()
    elif bad == "w_f16":
        w = w.half()
    elif bad == "lens_i64":
        lens = lens.long()
    elif bad == "shape":
        w, err = w[:, :, :3].contiguous(), ValueError
    else:
        emb, err = emb.transpose(1, 2).contiguous().transpose(1, 2), ValueError
    with pytest.raises(err):
        edge_max.window_max_aggregate(emb, w, lens, 2)


def test_wrapper_requires_grad_names_k2():
    """Inputs that require grad take K2's path: on the CPU its plain
    backward, with no kernel launched."""
    emb, w, lens = (torch.from_numpy(a) for a in _inputs(0))
    g = torch.from_numpy(np.random.default_rng(9).standard_normal(emb.shape).astype(np.float32))
    e, ww = emb.clone().requires_grad_(), w.clone().requires_grad_()
    before = (edge_max.launches, edge_max.bwd_launches)
    out = edge_max.window_max_aggregate(e, ww, lens, 2)
    out.backward(g)
    assert (edge_max.launches, edge_max.bwd_launches) == before
    want_e, want_w = edge_max.window_max_aggregate_backward_plain(emb, w, lens, g, 2)
    torch.testing.assert_close(e.grad, want_e, rtol=0, atol=0)
    torch.testing.assert_close(ww.grad, want_w, rtol=0, atol=0)

