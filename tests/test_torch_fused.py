"""The port's device-resident training path against the JAX package's, on
the CPU: ``DeviceLoader``'s device tables, epoch plans, ``rewind_epoch`` and
eval-batch cache against ``mgnns_tpu.data.loader.DeviceLoader``; the
engine's plan path (the step a CUDA graph captures, run eagerly on the CPU)
against the port's own loop path and against the JAX engine's fused
``lax.scan`` epochs (tests/test_engine.py:210, :242, :259); the nan-guard on
the device in both packages; the device-count optimizer against optax; and
the dropout generators of ``SiteGenerators`` against fresh ones.

The data are the synthetic 10-record corpus of ``tests/torch_train_common``
with 32 px synthetic images.
"""

import random

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from mgnns_tpu.data.loader import DeviceLoader as JDeviceLoader
from mgnns_tpu.engine.optim import make_optimizer
from mgnns_tpu.engine.train import Engine as JEngine
from mgnns_tpu.models import text_model_apply as j_text_model_apply
from mgnns_tpu.models import text_model_init as j_text_model_init

from mgnns_tpu_torch import convert
from mgnns_tpu_torch.data.loader import DeviceLoader
from mgnns_tpu_torch.engine.optim import Optimizer
from mgnns_tpu_torch.engine.train import Engine
from mgnns_tpu_torch.models.mgnns import mgnns_apply
from mgnns_tpu_torch.models.text_only import text_model_apply
from mgnns_tpu_torch.nn.core import SiteGenerators
from mgnns_tpu_torch.utils import tree_leaves, tree_map
from tests.torch_train_common import CPU, build_toy, datasets, make_data

B = 3  # 10 records: three full batches and one of a single record


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return make_data(str(tmp_path_factory.mktemp("data")))


@pytest.fixture(scope="module")
def dsets(data):
    return datasets(data)


def _host(batch) -> dict:
    return {k: np.asarray(v.numpy() if isinstance(v, torch.Tensor) else v)
            for k, v in batch.items()}


def _loaders(dsets, **kw):
    jds, ds = dsets
    return JDeviceLoader(jds, B, num_threads=2, **kw), DeviceLoader(ds, B, num_threads=2,
                                                                     device=CPU, **kw)


# ------------------------------------------------------------------ loader


@pytest.mark.parametrize("flags", [dict(device_text=True), dict(device_images=True),
                                   dict(device_text=True, device_images=True)],
                         ids=["text", "images", "both"])
def test_table_batches_equal_jax_loader(dsets, flags):
    """Batches gathered from the device tables equal the JAX loader's, key
    by key and byte for byte, over two shuffled epochs."""
    jl, pl = _loaders(dsets, shuffle=True, seed=2, **flags)
    for _ in range(2):
        jb, pb = [_host(b) for b in jl], [_host(b) for b in pl]
        assert len(jb) == len(pb) == 4
        for a, b in zip(pb, jb):
            assert sorted(a) == sorted(b)
            for k in a:
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("shuffle,num_batches", [(False, None), (True, None), (True, 6)],
                         ids=["in-order", "shuffled", "forced-length"])
def test_epoch_plan_equals_jax(dsets, shuffle, num_batches):
    """The plan's tables, index, weight and label matrices and row shapes
    equal the JAX loader's, epoch after epoch; a forced length pads with
    zero-weight batches; the image table is flat [N, H*W*3] uint8."""
    jl, pl = _loaders(dsets, shuffle=shuffle, seed=1, num_batches=num_batches,
                      device_text=True, device_images=True)
    for _ in range(2):
        jp, pp = jl.epoch_plan(), pl.epoch_plan()
        for k in ("idx", "weight", "labels"):
            assert pp[k].dtype == jp[k].dtype, k
            np.testing.assert_array_equal(pp[k], jp[k], err_msg=k)
        assert pp["row_shapes"] == {"image": (32, 32, 3)} == {
            k: tuple(v) for k, v in jp["row_shapes"].items()}
        assert sorted(pp["tables"]) == sorted(jp["tables"])
        for k, t in pp["tables"].items():
            np.testing.assert_array_equal(t.numpy(), np.asarray(jp["tables"][k]), err_msg=k)
        assert pp["tables"]["image"].shape == (10, 32 * 32 * 3)
        assert pp["tables"]["image"].dtype == torch.uint8
    if num_batches:
        assert pp["idx"].shape == (6, B) and not pp["weight"][4:].any()
        assert pp["weight"].sum() == 10


def test_epoch_plan_needs_every_input_in_tables_and_rewinds(dsets):
    jds, ds = dsets
    assert DeviceLoader(ds, B, device=CPU).epoch_plan() is None
    assert DeviceLoader(ds, B, device_text=True, device=CPU).epoch_plan() is None  # images stream
    assert DeviceLoader(ds, B, device_images=True, device=CPU).epoch_plan() is None
    ld = DeviceLoader(ds, B, shuffle=True, seed=4, with_images=False, device_text=True, device=CPU)
    first = ld.epoch_plan()
    ld.rewind_epoch()
    again = ld.epoch_plan()
    np.testing.assert_array_equal(first["idx"], again["idx"])
    assert not np.array_equal(first["idx"], ld.epoch_plan()["idx"])
    # the tables are uploaded once per dataset and shared by its loaders
    other = DeviceLoader(ds, 5, with_images=False, device_text=True, device=CPU)
    assert other.epoch_plan()["tables"]["ids"] is first["tables"]["ids"]


def test_device_images_refuses_random_pixels(data):
    _, ds = datasets(data, backend="pil", train=True)
    with pytest.raises(ValueError, match="deterministic"):
        DeviceLoader(ds, B, device_images=True, device=CPU)


@pytest.mark.parametrize("budget", [None, 1], ids=["unbounded", "one-batch"])
def test_eval_cache_budget_latch_equals_jax(dsets, budget):
    """The cache keeps a contiguous prefix of the first epoch's batches up
    to the byte budget, as the JAX loader does, and later epochs replay it
    and stream the rest: the batches stay those of a loader without one."""
    jds, ds = dsets
    one = None
    if budget is not None:  # room for one batch and a half
        ld = DeviceLoader(ds, B, device_images=True, device=CPU)
        one = int(1.5 * sum(np.asarray(v).nbytes for v in ld._assemble(
            np.arange(B), None, random.Random(0)).values()))
    kw = dict(cache_device_batches=True, cache_budget_bytes=one, device_images=True)
    jl, pl = _loaders(dsets, **kw)
    plain = DeviceLoader(ds, B, device_images=True, device=CPU)
    want = [_host(b) for b in plain]
    for epoch in range(3):
        got = [_host(b) for b in pl]
        [_host(b) for b in jl]
        assert len(pl._device_cache) == len(jl._device_cache) == (4 if budget is None else 1)
        assert pl._cache_complete == jl._cache_complete == (budget is None)
        assert pl._cache_stopped == jl._cache_stopped == (budget is not None)
        for a, b in zip(got, want):
            for k in b:
                np.testing.assert_array_equal(a[k], b[k], err_msg=f"epoch {epoch} {k}")
    with pytest.raises(ValueError, match="shuffle=False"):
        DeviceLoader(ds, B, shuffle=True, cache_device_batches=True, device=CPU)


# ------------------------------------------------------------------ engines


@pytest.fixture
def one_torch_thread():
    """Bit-for-bit comparisons of two runs on the CPU: with more than one
    thread the embedding backward adds across threads in a varying order."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _port_text_engine(data, params, *, dropout, images=False, poison=None, **kw):
    def apply_fn(p, bs, batch, *, train, generator):
        logits = text_model_apply(p, batch, ngram=2, dropout_rate=dropout, train=train,
                                  generator=generator)
        if images:  # a per-sample pixel statistic, so the gathered pixels count
            logits = logits + batch["image"].float().mean(dim=(1, 2, 3))[:, None] / 255.0
        if poison is not None:
            bad = (batch["ids"] == poison).any()
            logits = logits + torch.where(bad, float("nan"), 0.0)
        return logits, bs

    return Engine(apply_fn, params, {}, device=CPU, **kw)


def _jax_text_engine(params, *, poison=None, **kw):
    def apply_fn(p, bs, batch, *, train, rng):
        logits = j_text_model_apply(p, batch, ngram=2, dropout_rate=0.0, train=train, rng=rng)
        if poison is not None:
            logits = logits + jnp.where((batch["ids"] == poison).any(), jnp.nan, 0.0)
        return logits, bs

    return JEngine(apply_fn, params, {}, **kw)


@pytest.mark.parametrize("images", [False, True], ids=["text", "text+pixels"])
def test_plan_path_equals_loop_path(data, dsets, images, one_torch_thread):
    """Three shuffled Adam epochs at dropout 0.5, then eval: the plan path
    (the captured step's body, eager on the CPU) and the loop path give the
    same losses, metrics, parameters and predictions, bit for bit: the same
    step on the same batches with the same dropout masks."""
    jds, ds = dsets
    params = convert.text_model_from_jax_params(jax.tree.map(np.asarray, j_text_model_init(
        jax.random.key(0), len(data["vocab"]), 7, data["graph"].num_edges)), device=CPU)
    kw = dict(num_classes=7, lr=5e-2, steps_per_epoch=4, epoch_step=(2,), seed=3)
    engines = [_port_text_engine(data, tree_map(torch.clone, params), dropout=0.5,
                                 images=images, **kw) for _ in range(2)]
    flags = dict(device_text=True, device_images=images)
    loaders = [DeviceLoader(ds, B, shuffle=True, seed=5, with_images=images, device=CPU, **f)
               for f in ({}, flags)]
    for _ in range(3):
        loop, plan = (e.train_epoch(ld) for e, ld in zip(engines, loaders))
        assert plan["fused"] is True and "fused" not in loop
        assert plan["capture_seconds"] == 0.0
        for k in ("loss", "accuracy", "macro_f1", "skipped_steps"):
            assert plan[k] == loop[k], k
    for a, b in zip(*(tree_leaves(e.params) for e in engines)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert int(engines[1].opt_state["count"]) == engines[1].step == 12
    evals = [e.eval_epoch(DeviceLoader(ds, 4, with_images=images, device=CPU, **f),
                          collect_preds=True) for e, f in zip(engines, ({}, flags))]
    for k in ("loss", "accuracy", "confusion", "preds", "targets", "sample_index"):
        np.testing.assert_array_equal(evals[1][k], evals[0][k], err_msg=k)


def test_plan_path_equals_jax_fused_epochs(data, dsets):
    """The port's plan path against the JAX engine's fused epochs from the
    same weights on the same shuffled plans (SGD, dropout 0, a decay
    boundary at epoch 1): losses within 1e-5 relative, accuracy equal,
    parameters within 1e-4 relative (tests/test_torch_engine.py:290's
    tolerance), eval predictions and confusion equal."""
    jds, ds = dsets
    jparams = j_text_model_init(jax.random.key(1), len(data["vocab"]), 7, data["graph"].num_edges)
    kw = dict(num_classes=7, lr=0.05, optimizer_algo="sgd", steps_per_epoch=4, epoch_step=(1,))
    jeng = _jax_text_engine(jparams, **kw)
    eng = _port_text_engine(data, convert.text_model_from_jax_params(
        jax.tree.map(np.asarray, jparams), device=CPU), dropout=0.0, **kw)
    jl = JDeviceLoader(jds, B, shuffle=True, seed=0, with_images=False, device_text=True)
    pl = DeviceLoader(ds, B, shuffle=True, seed=0, with_images=False, device_text=True, device=CPU)
    for _ in range(3):
        want, got = jeng.train_epoch(jl), eng.train_epoch(pl)
        assert want["fused"] is got["fused"] is True
        assert got["loss"] == pytest.approx(want["loss"], rel=1e-5)
        assert got["accuracy"] == want["accuracy"]
    jtree = {"text_gcn": jeng.state.params["text_gcn"], "head": jeng.state.params["head"]}
    for name, sub in eng.params.items():
        for k, t in sub.items():
            np.testing.assert_allclose(t.numpy(), np.asarray(jtree[name][k]), rtol=1e-4,
                                       atol=1e-6, err_msg=f"{name}/{k}")
    want = jeng.eval_epoch(JDeviceLoader(jds, 4, with_images=False, device_text=True),
                           collect_preds=True)
    got = eng.eval_epoch(DeviceLoader(ds, 4, with_images=False, device_text=True, device=CPU),
                         collect_preds=True)
    assert got["loss"] == pytest.approx(want["loss"], rel=1e-5)
    for k in ("confusion", "preds", "targets", "sample_index"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_poisoned_batch_skipped_on_device_in_both_packages(data, dsets, one_torch_thread):
    """A batch whose logits are NaN, third of four in the epoch, is skipped
    by the device-side guard on both packages' plan paths and on the port's
    loop path: one skipped step, the other steps' updates as the JAX
    package makes them, and nothing added to the confusion matrix.  SGD, as
    in tests/test_torch_engine.py:290: Adam's normalisation turns the two
    packages' float32 rounding of near-zero gradients into 1e-4-relative
    differences of single embedding entries."""
    jds, ds = dsets
    heart = data["vocab"].index("heart")  # only in record 8, batch [6, 7, 8]
    jparams = j_text_model_init(jax.random.key(2), len(data["vocab"]), 7, data["graph"].num_edges)
    kw = dict(num_classes=7, lr=0.05, optimizer_algo="sgd", steps_per_epoch=4, epoch_step=(10,))
    jeng = _jax_text_engine(jparams, poison=heart, **kw)
    port = [_port_text_engine(data, convert.text_model_from_jax_params(
        jax.tree.map(np.asarray, jparams), device=CPU), dropout=0.0, poison=heart, **kw)
        for _ in range(2)]
    want = jeng.train_epoch(JDeviceLoader(jds, B, with_images=False, device_text=True))
    got = port[0].train_epoch(DeviceLoader(ds, B, with_images=False, device_text=True,
                                           device=CPU))
    loop = port[1].train_epoch(DeviceLoader(ds, B, with_images=False, device=CPU))
    assert got["fused"] and want["fused"]
    assert want["skipped_steps"] == got["skipped_steps"] == loop["skipped_steps"] == 1
    assert got["loss"] == pytest.approx(want["loss"], rel=1e-5) and got["loss"] == loop["loss"]
    assert got["accuracy"] == want["accuracy"] == loop["accuracy"]
    assert int(port[0].opt_state["count"]) == 3
    for name in ("text_gcn", "head"):
        for k, t in port[0].params[name].items():
            assert torch.isfinite(t).all()
            np.testing.assert_allclose(t.numpy(), np.asarray(jeng.state.params[name][k]),
                                       rtol=1e-4, atol=1e-6, err_msg=f"{name}/{k}")
            torch.testing.assert_close(t, port[1].params[name][k], rtol=0, atol=0)


# --------------------------------------------------------------- optimizer


@pytest.mark.parametrize("accumulation_steps", [1, 2])
def test_device_count_optimizer_with_guard_equals_optax(accumulation_steps):
    """Eight micro-steps whose count, decayed rate and bias corrections live
    on the device, across the decay boundary (2 applied steps an epoch,
    decay at epoch 2); micro-step 3's gradient is NaN and ``ok`` false, so
    it changes nothing, and optax sees the other seven.  Parameters within
    1e-6 of each leaf's scale."""
    r = np.random.default_rng(0)
    tree = {"gc1": {"w": r.standard_normal((4, 4)).astype(np.float32)},
            "lstm": {"w": r.standard_normal((3, 5)).astype(np.float32)},
            "object_trunk": {"w": r.standard_normal((6,)).astype(np.float32)}}
    kw = dict(lr=0.05, lrp=0.1, weight_decay=1e-2, grad_clip=10.0, steps_per_epoch=2,
              epoch_step=(2,), lr_decay=0.2, accumulation_steps=accumulation_steps)
    tx = make_optimizer(tree, **kw)
    jparams = jax.tree.map(jnp.asarray, tree)
    jstate = tx.init(jparams)
    params = convert.to_torch(tree, device=CPU)
    opt = Optimizer(params, **kw)
    state = opt.init(params)
    leaves = tree_leaves(params)
    for step in range(8):
        grads = {k: {n: r.standard_normal(v.shape).astype(np.float32) * (6.0 if step % 3 else 0.5)
                     for n, v in sub.items()} for k, sub in tree.items()}
        ok = step != 3
        if ok:
            updates, jstate = tx.update(jax.tree.map(jnp.asarray, grads), jstate, jparams)
            jparams = optax.apply_updates(jparams, updates)
        g = [torch.from_numpy(grads[k][n]) for k in params for n in params[k]]
        if not ok:
            g[0][0, 0] = float("nan")
        opt.update(leaves, g, state, torch.tensor(ok), opt.applies_now(state))
        if ok or accumulation_steps == 1:
            opt.advance(state)
        for p, (k, n) in zip(leaves, [(k, n) for k in params for n in params[k]]):
            w = np.asarray(jparams[k][n])
            np.testing.assert_allclose(p.numpy(), w, rtol=0, atol=1e-6 * np.abs(w).max())
    assert state["count"].dtype == torch.int64 and int(state["count"]) == 7 // accumulation_steps


# ---------------------------------------------------------------- dropout


def test_site_generators_draw_the_masks_of_fresh_generators():
    """The toy fusion model in train mode at dropout 0.5 (every dropout site,
    nested streams included): a ``SiteGenerators`` root re-seeded per step
    gives the logits that a fresh generator of the same seed gives, step
    after step, and makes each site's generator once."""
    import dataclasses

    from mgnns_tpu_torch.config import ModelConfig

    f = build_toy()
    cfg = dataclasses.replace(ModelConfig(**f["kw"]), dropout=0.5, text_dropout=0.5)
    batch = {k: torch.from_numpy(v) for k, v in f["batch"].items()}
    tree = SiteGenerators(CPU)
    made = None
    for seed in (11, 12, 11):
        tree.reseed(seed)
        got = mgnns_apply(f["params"], f["stats"], f["consts"], batch, cfg=cfg, train=True,
                          generator=tree.root)[0]
        want = mgnns_apply(f["params"], f["stats"], f["consts"], batch, cfg=cfg, train=True,
                           generator=torch.Generator().manual_seed(seed))[0]
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        made = made or tree.generators()
        assert tree.generators() == made and len(made) > 10
    off = mgnns_apply(f["params"], f["stats"], f["consts"], batch, cfg=cfg, train=True,
                      generator=torch.Generator().manual_seed(12))[0]
    assert not torch.equal(got, off)
