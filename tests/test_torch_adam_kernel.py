"""The optimizer kernels' wrapper on the CPU (``mgnns_tpu_torch/kernels/
adam.py``): the launch plan covers every element of every leaf once, across
table splits and chunk boundaries; the gradients' layouts are classified as
the kernels read them; CPU leaves take the plain chain and never the
wrapper; the wrapper refuses what the kernels do not take.
``tests/test_torch_cuda.py`` holds the kernels to the plain chain on the
card."""

import numpy as np
import pytest
import torch

from mgnns_tpu_torch.engine import optim
from mgnns_tpu_torch.kernels import adam
from mgnns_tpu_torch.utils import tree_leaves


def _covered(sizes: list[int], chunk: int, max_leaves: int) -> list[np.ndarray]:
    """How many times the plan's blocks cover each element of each leaf,
    each block finding its leaf as the kernels do (the last leaf of its
    launch whose first chunk is at most the block's)."""
    keep, start, launches = adam.plan(sizes, chunk, max_leaves)
    hits = [np.zeros(n, np.int64) for n in sizes]
    bases = []
    for ln in launches:
        assert 1 <= ln.stop - ln.first <= max_leaves
        bases.append(ln.base)
        table = start[ln.first:ln.stop]
        assert table[0] == 0 and np.all(np.diff(table) > 0)
        for c in range(ln.chunks):
            k = ln.first + int(np.searchsorted(table, c, side="right")) - 1
            leaf = int(keep[k])
            begin = (c - int(start[k])) * chunk
            assert 0 <= begin < sizes[leaf]
            hits[leaf][begin:min(begin + chunk, sizes[leaf])] += 1
    assert bases == list(np.cumsum([0] + [ln.chunks for ln in launches])[:-1])
    return hits


@pytest.mark.parametrize("max_leaves", [1, 3, 672])
def test_plan_covers_every_element_once(max_leaves):
    chunk = 16
    sizes = [0, 1, 15, 16, 17, 0, 33, 160, 5, 0, 47, 16 * 7 + 3, 2]
    hits = _covered(sizes, chunk, max_leaves)
    assert all(np.all(h == 1) for h in hits)
    keep, _, launches = adam.plan(sizes, chunk, max_leaves)
    assert [sizes[i] for i in keep] == [n for n in sizes if n > 0]
    assert len(launches) == -(-len(keep) // max_leaves)


def test_plan_of_nothing_is_empty():
    keep, start, launches = adam.plan([0, 0], 4096, 672)
    assert len(keep) == len(start) == 0 and launches == []


def test_chunk_size_adapts_to_the_element_count():
    # the fusion model's trained set fills 132 SMs with the largest chunks; a
    # small set takes the smallest; a power of two between them otherwise
    assert adam.chunk_size(90_997_314, 132) == adam.MAX_CHUNK
    assert adam.chunk_size(2_740_000_000, 132) == adam.MAX_CHUNK
    assert adam.chunk_size(1000, 132) == adam.MIN_CHUNK
    mid = adam.chunk_size(132 * 4 * 10_000, 132)
    assert adam.MIN_CHUNK < mid < adam.MAX_CHUNK and mid & (mid - 1) == 0


def test_the_fusion_leaf_set_takes_one_update_launch():
    """652 trained leaves of the fusion model (their count does not depend on
    the widths) fit one update launch's table."""
    sizes = [1] * 652
    assert len(adam.plan(sizes, adam.MIN_CHUNK, adam.MAX_UPDATE_LEAVES)[2]) == 1


def test_layout_classification():
    p = torch.zeros(8, 6, 3, 3)
    # the same strides, and channels_last over 1x1 (the same storage order)
    assert adam.layout(p, torch.zeros(8, 6, 3, 3)) == 0
    pw = torch.zeros(16, 8, 1, 1)
    assert adam.layout(pw, torch.zeros(16, 8, 1, 1).contiguous(
        memory_format=torch.channels_last)) == 0
    # channels_last over a contiguous OIHW parameter: the index map
    cl = torch.zeros(8, 6, 3, 3).contiguous(memory_format=torch.channels_last)
    assert adam.layout(p, cl) == (6 << 16) | 9
    # a channels_last parameter takes a channels_last gradient as flat storage
    assert adam.layout(cl, torch.zeros_like(cl)) == 0
    # a column slice, a transpose: copied
    w = torch.zeros(9, 5)
    col = torch.zeros(9, 8)[:, :5]
    tr = torch.zeros(5, 9).t()
    assert adam.layout(w, col) is None and adam.layout(w, tr) is None
    out = adam.match_layouts([p, p, w, w, w], [cl, None, col, tr, torch.zeros(9, 5)])
    assert adam.grad_copies == 2
    assert out[0] is cl and out[1] is None
    assert out[2].is_contiguous() and out[3].is_contiguous()
    assert torch.equal(out[2], col) and torch.equal(out[3], tr)


def test_dense():
    assert adam._dense(torch.zeros(3, 4)) and adam._dense(torch.zeros(3, 4).t())
    assert adam._dense(torch.zeros(2, 3, 4, 5).contiguous(memory_format=torch.channels_last))
    assert adam._dense(torch.zeros(0, 4)) and adam._dense(torch.zeros(()))
    assert not adam._dense(torch.zeros(9, 8)[:, :5])
    assert not adam._dense(torch.zeros(1, 4).expand(3, 4))


def _leaves(seed: int):
    g = torch.Generator().manual_seed(seed)
    params = {"text_gcn": {"w": torch.randn(33, 17, generator=g)},
              "object_trunk": {"conv": torch.randn(8, 6, 3, 3, generator=g)},
              "gc1": {"b": torch.randn(1001, generator=g)},
              "object_A": torch.randn(4, 4, generator=g)}
    grads = [torch.randn(33, 17, generator=g),
             torch.randn(8, 6, 3, 3, generator=g).contiguous(memory_format=torch.channels_last),
             None, torch.randn(4, 4, generator=g)]
    return params, grads


@pytest.mark.parametrize("algo", ["adam", "sgd"])
def test_cpu_leaves_take_the_plain_chain(monkeypatch, algo):
    """On CPU leaves no wrapper function is called, and the step's bits are
    the plain chain's, run directly."""
    def refuse(*args, **kwargs):
        raise AssertionError("the CUDA wrapper was called for CPU leaves")

    for name in ("update", "sum_squares", "select", "match_layouts"):
        monkeypatch.setattr(adam, name, refuse)
    runs = []
    for direct in (False, True):
        params, grads = _leaves(0)
        opt = optim.Optimizer(params, lr=1e-2, grad_clip=1.0, algo=algo)
        state = opt.init(params)
        leaves = tree_leaves(params)
        for _ in range(2):
            ok = torch.tensor(True)
            if direct:
                opt._plain_chain(leaves, grads, state, ok)
            else:
                opt.apply(leaves, grads, state, ok)
        runs.append(leaves + opt.tensors(state))
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    olds, news = [torch.zeros(3), torch.zeros(5)], [torch.ones(3), torch.full((5,), 2.0)]
    optim.select_(olds, news, torch.tensor(False))
    assert all(torch.equal(o, torch.zeros_like(o)) for o in olds)
    optim.select_(olds, news, torch.tensor(True))
    assert all(torch.equal(o, n) for o, n in zip(olds, news))


def _update(params, grads, mu, nu, **kw):
    scalars = dict(norm=torch.tensor(1.0), clip=10.0, weight_decay=0.0, bc1=torch.tensor(0.1),
                   bc2=torch.tensor(0.001), neg_lr=torch.tensor([-1e-3]), ok=None)
    scalars.update(kw)
    adam.update(params, grads, mu, nu, [1.0] * len(params), **scalars)


def test_the_wrapper_refuses_what_the_kernels_do_not_take():
    p = [torch.zeros(5)]
    with pytest.raises(TypeError, match="float32"):
        _update(p, [torch.zeros(5)], [torch.zeros(5, dtype=torch.float16)], [torch.zeros(5)])
    with pytest.raises(ValueError, match="several devices"):
        _update(p, [torch.zeros(5, device="meta")], [torch.zeros(5)], [torch.zeros(5)])
    with pytest.raises(ValueError, match="CUDA"):
        _update(p, [torch.zeros(5)], [torch.zeros(5)], [torch.zeros(5)])
    with pytest.raises(ValueError, match="CUDA"):
        adam.sum_squares(p, [torch.zeros(5)])
    with pytest.raises(ValueError, match="CUDA"):
        adam.select(p, [torch.ones(5)], None)
    with pytest.raises(ValueError, match="parameters"):
        _update(p, [], [torch.zeros(5)], [torch.zeros(5)])
