"""The port's precision policy against the JAX package on the CPU: bf16
trunks (forward, gradients, drift from float32), BatchNorm and the image
normalization at bf16, and the pin that keeps float32 trunk convolutions off
TF32 in the forward and in the backward.

The fusion model runs at the toy shapes of tests/torch_train_common.py
(image 64, 5/6 label classes, B=4, L=10, dropout 0), train mode, with uint8
pixels so the normalization runs in the compute dtype; weights come from the
JAX package's initializers through ``mgnns_tpu_torch.convert``.  The trunks
normalize by their running statistics (``bn_mode="frozen"``): train-mode
BatchNorm over 4 images of 64 px through random-init trunks is so
ill-conditioned that the JAX package's own bf16 logits lie 0.41 of scale
from its float32 ones there, against 0.023 with running statistics, close
to the 0.021 it measured at full size (MULTICHIP_r05.json).  The train-mode
BatchNorm maths at bf16 is held one layer at a time instead
(``test_bn_bf16_matches_jax``)."""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from mgnns_tpu.config import ModelConfig as JModelConfig
from mgnns_tpu.engine.train import cross_entropy as j_cross_entropy
from mgnns_tpu.models import mgnns_apply as j_mgnns_apply
from mgnns_tpu.models.mgnns import normalize_image_batch as j_normalize_image_batch
from mgnns_tpu.nn import resnet as jresnet

from mgnns_tpu_torch import convert
from mgnns_tpu_torch.config import ModelConfig
from mgnns_tpu_torch.engine.metrics import confusion_init
from mgnns_tpu_torch.engine.train import Engine, cross_entropy
from mgnns_tpu_torch.models.mgnns import mgnns_apply, normalize_image_batch
from mgnns_tpu_torch.nn import resnet
from mgnns_tpu_torch.utils import tree_leaves
from tests.torch_train_common import few_torch_threads  # noqa: F401  (autouse fixture)
from tests.torch_train_common import (
    CPU, build_toy, compare_trees, leaf_errors, np_tree, port_grads,
)

LOGIT_TOL = 4e-2   # the JAX package's own bf16-vs-float32 bound (MULTICHIP_r05.json)
GRAD_TOL = 5e-2    # non-trunk gradients, port bf16 vs JAX bf16, of scale


@pytest.fixture(scope="module")
def toy():
    f = build_toy()
    f["kw"] = dict(f["kw"], bn_mode="frozen")
    r = np.random.default_rng(3)
    f["batch"] = dict(f["batch"], image=r.integers(0, 256, f["batch"]["image"].shape,
                                                   dtype=np.uint8))
    return f


def _jax_step(f, dtype):
    """(loss, logits, gradient tree) of the JAX package's train step."""
    jcfg = dataclasses.replace(JModelConfig(**f["kw"]), compute_dtype=dtype)
    full = {k: jnp.asarray(v) for k, v in f["batch"].items() if k not in ("label", "weight")}
    full["object_inp"] = jnp.asarray(f["object_inp"])
    full["place_inp"] = jnp.asarray(f["place_inp"])

    def loss_fn(p):
        logits, _, _ = j_mgnns_apply(p, f["jstate"], f["jconsts"], full, cfg=jcfg, train=True,
                                     rng=jax.random.key(0))
        loss = j_cross_entropy(logits, jnp.asarray(f["batch"]["label"]),
                               jnp.asarray(f["batch"]["weight"]))
        return loss, logits

    (loss, logits), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(f["jparams"])
    return float(loss), np.asarray(logits, np.float64), grads


def _port_step(f, dtype):
    """(loss, logits, gradient tree) of the port's train step."""
    cfg = ModelConfig(**dict(f["kw"], compute_dtype=dtype))
    batch = {k: torch.from_numpy(v) for k, v in f["batch"].items()}
    out = {}

    def apply(p, _):
        logits, new_stats, aux = mgnns_apply(p, f["stats"], f["consts"], batch, cfg=cfg,
                                             train=True, generator=torch.Generator().manual_seed(0))
        out["logits"] = logits.detach().double().numpy()
        return cross_entropy(logits, batch["label"], batch["weight"]), aux, new_stats

    loss, _, _, grads = port_grads(apply, f["params"], f["batch"])
    return loss, out["logits"], grads


@pytest.fixture(scope="module")
def runs(toy):
    return {(pkg, dtype): (_jax_step if pkg == "jax" else _port_step)(toy, dtype)
            for pkg in ("jax", "port") for dtype in ("float32", "bfloat16")}


def _scaled_err(got, want):
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-8))


def test_bf16_fusion_logits_match_jax(runs):
    _, got, _ = runs["port", "bfloat16"]
    _, want, _ = runs["jax", "bfloat16"]
    assert np.isfinite(got).all()
    assert _scaled_err(got, want) <= LOGIT_TOL


def test_bf16_drift_from_float32_within_twice_jax(runs):
    """The port's bf16-vs-float32 logit drift is at most twice the JAX
    package's on the same inputs."""
    port = _scaled_err(runs["port", "bfloat16"][1], runs["port", "float32"][1])
    jax_drift = _scaled_err(runs["jax", "bfloat16"][1], runs["jax", "float32"][1])
    assert 0 < port <= 2 * jax_drift, (port, jax_drift)


def test_bf16_fusion_grads_match_jax(toy, runs):
    """Each non-trunk gradient leaf within 5e-2 of scale of the JAX
    package's bf16 step, plus twice the JAX package's own bf16-vs-float32
    drift of that leaf: no bf16 run can be held closer to another than bf16
    holds one package to its own float32, and some leaves move far (a ReLU
    of a position-wise FFN whose pre-activation sits near zero moves
    ``pos_ffn/w_1`` by up to a third, and a saturated label-attention softmax
    its ``w_q``/``w_k`` by 0.95, in the JAX package alone).  Trunk gradients
    are finite and non-zero; every gradient is float32, as are the master
    parameters."""
    trunks = ("object_trunk", "place_trunk")

    def heads(tree):
        return {k: v for k, v in tree.items() if k not in trunks}

    _, _, got = runs["port", "bfloat16"]
    want, want32 = (heads(convert.params_from_jax(np_tree(runs["jax", dt][2]), device=CPU))
                    for dt in ("bfloat16", "float32"))
    drift = leaf_errors(want, want32)
    floor = 1e-3 * max(scale for _, scale in drift.values())
    compare_trees(heads(got), want, lambda path: GRAD_TOL + 2 * drift[path][0] * drift[path][1]
                  / max(drift[path][1], floor))
    for side in trunks:
        leaves = tree_leaves(got[side])
        assert all(torch.isfinite(g).all() for g in leaves)
        assert sum(float(g.abs().sum()) for g in leaves) > 0
    assert all(g.dtype == torch.float32 for g in tree_leaves(got))
    assert all(p.dtype == torch.float32 for p in tree_leaves(toy["params"])
               if p.is_floating_point())


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_bn_bf16_matches_jax(train):
    """BatchNorm on a bf16 activation: the output in bf16 within two bf16
    steps of scale of ``bn_apply``'s, the running statistics (float32 in
    both) within 1e-5 of scale."""
    r = np.random.default_rng(4)
    C = 6
    x = (3 * r.standard_normal((4, 5, 5, C)) + 1).astype(np.float32)
    p = {"scale": r.uniform(0.5, 1.5, C).astype(np.float32),
         "bias": r.standard_normal(C).astype(np.float32)}
    s = {"mean": r.standard_normal(C).astype(np.float32),
         "var": r.uniform(0.5, 2.0, C).astype(np.float32)}
    xb = jnp.asarray(x, jnp.bfloat16)
    want_y, want_s = jresnet.bn_apply(jax.tree.map(jnp.asarray, p), jax.tree.map(jnp.asarray, s),
                                      xb, train=train)
    xt = torch.from_numpy(np.array(xb.astype(jnp.float32))).bfloat16().permute(0, 3, 1, 2)
    got_y, got_s = resnet.bn({k: torch.from_numpy(v) for k, v in p.items()},
                             {k: torch.from_numpy(v) for k, v in s.items()}, xt, train=train)
    assert got_y.dtype == torch.bfloat16 and want_y.dtype == jnp.bfloat16
    y = got_y.float().permute(0, 2, 3, 1).numpy()
    wy = np.asarray(want_y.astype(jnp.float32))
    assert _scaled_err(y, wy) <= 2 * 2.0 ** -8
    for k in ("mean", "var"):
        assert got_s[k].dtype == torch.float32
        np.testing.assert_allclose(got_s[k].numpy(), np.asarray(want_s[k]),
                                   rtol=0, atol=1e-5 * float(np.abs(want_s[k]).max()))


def test_normalize_image_batch_bf16_bit_exact():
    raw = np.random.default_rng(5).integers(0, 256, (2, 8, 8, 3), dtype=np.uint8)
    got = normalize_image_batch(torch.from_numpy(raw), torch.bfloat16)
    want = j_normalize_image_batch(jnp.asarray(raw), jnp.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  np.asarray(want).view(np.int16))


@pytest.mark.parametrize("stride,padding", [(1, 0), (2, 1), (2, 3)])
def test_pinned_conv_equals_autograd_conv(stride, padding):
    """The pinned conv's output and both gradients equal ``F.conv2d``'s
    under autograd exactly."""
    r = torch.Generator().manual_seed(stride + padding)
    x = torch.randn(2, 4, 9, 9, generator=r).to(memory_format=torch.channels_last)
    w = torch.randn(6, 4, 3, 3, generator=r)
    outs = []
    for fn in (lambda a, b: F.conv2d(a, b, stride=stride, padding=padding),
               lambda a, b: resnet.conv(a, b, torch.float32, stride, padding)):
        a, b = x.clone().requires_grad_(), w.clone().requires_grad_()
        y = fn(a, b)
        outs.append((y, *torch.autograd.grad(y, [a, b], torch.ones_like(y) * 0.5)))
    for got, want in zip(outs[1], outs[0]):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def _trunk_engine():
    """An Engine over a ResNet-50 trunk at 32 px with a linear read-out."""
    g = torch.Generator().manual_seed(0)
    trunk_p, trunk_s = resnet.resnet_init(g, depth=50)
    params = {"trunk": trunk_p, "head": torch.randn(2048, 3, generator=g) * 0.01}

    def apply_fn(p, bs, batch, *, train, generator):
        feats, new = resnet.resnet_apply(p["trunk"], bs["trunk"], batch["image"], train=train)
        return feats.mean(dim=(1, 2)) @ p["head"], {"trunk": new}

    engine = Engine(apply_fn, params, {"trunk": trunk_s}, num_classes=3, optimizer_algo="sgd",
                    device=CPU)
    batch = {"image": torch.randn(2, 32, 32, 3, generator=g),
             "label": np.array([0, 2], np.int32), "weight": np.ones(2, np.float32)}
    return engine, batch


@pytest.mark.parametrize("pinned", [True, False], ids=["package_default", "pin_removed"])
def test_trunk_convs_run_ieee_forward_and_backward(pinned, monkeypatch):
    """With torch's global flags allowing TF32 for cuDNN convolutions, every
    trunk conv of ``Engine.train_step`` reads the conv precision "ieee" in
    its forward and in its backward, and the global flag is restored after.
    The CPU computes no TF32, so this checks the mechanism: with the pin
    replaced by a no-op the same spy reads "tf32"."""
    conv_flags = torch.backends.cudnn.conv
    before = conv_flags.fp32_precision
    seen = {"forward": [], "backward": []}
    conv2d, conv_bwd = F.conv2d, torch.ops.aten.convolution_backward

    def spy_forward(*a, **k):
        seen["forward"].append(conv_flags.fp32_precision)
        return conv2d(*a, **k)

    def spy_backward(*a, **k):
        seen["backward"].append(conv_flags.fp32_precision)
        return conv_bwd(*a, **k)

    monkeypatch.setattr(F, "conv2d", spy_forward)
    monkeypatch.setattr(torch.ops.aten, "convolution_backward", spy_backward)
    if not pinned:
        monkeypatch.setattr(resnet, "ieee_float32_convs", contextlib.nullcontext)
    engine, batch = _trunk_engine()
    try:
        conv_flags.fp32_precision = "tf32"
        loss = engine.train_step(batch, confusion_init(3, CPU))
        after = conv_flags.fp32_precision
    finally:
        conv_flags.fp32_precision = before
    assert torch.isfinite(loss)
    assert after == "tf32"
    expect = "ieee" if pinned else "tf32"
    for phase in ("forward", "backward"):
        assert len(seen[phase]) == 53, phase  # ResNet-50's convs
        assert set(seen[phase]) == {expect}, (phase, set(seen[phase]))
