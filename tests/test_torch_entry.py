"""The port's entry surface (``mgnns_tpu_torch/entry.py``) against the JAX
package's ``__graft_entry__.py`` on the CPU:

- the helpers: ``_tiny_inputs``, ``_build``'s label embedding and label
  graphs, ``_FakeFusionDS`` and ``_unpad_like`` equal the JAX copies' for the
  same seeds, array for array;
- the forward: the port's on ``__graft_entry__._build``'s JAX weights (carried
  across by ``convert.py``) against ``mgnns_tpu.models.mgnns_apply`` at 64 px
  and float32 (atol 5e-3, the port's fusion-logits bound), and at bf16 its
  trunks and, on shared trunk features, the rest of its forward against the
  JAX package's (4e-2 of scale); ``entry(device="cpu")`` at production
  shapes;
- the dry run: ``dryrun_multichip(4, device="cpu")`` once for the module
  (4 gloo ranks, geometries (4, 1), (2, 2), (1, 4)), its four legs read from
  the numbers it returns; and its rank watchdog, which fails the call as
  soon as a rank fails or the ranks outlast the timeout.
"""

import contextlib
import io
import json
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import __graft_entry__ as G
from mgnns_tpu.config import ModelConfig as JModelConfig
from mgnns_tpu.models import mgnns_apply as j_mgnns_apply
from mgnns_tpu.nn import resnet as jresnet

from mgnns_tpu_torch import convert, entry
from mgnns_tpu_torch.config import ModelConfig
from mgnns_tpu_torch.kernels import edge_max
from mgnns_tpu_torch.nn import resnet

from torch_train_common import np_tree

SMALL = dict(vocab_size=257, edges_num=515, image_size=64)


# ------------------------------------------------------------------ helpers


@pytest.mark.parametrize("seed,B,L,W,image_size", [(1, 2, 100, 9, 32), (2, 4, 16, 9, 32),
                                                    (3, 3, 7, 5, 16)])
def test_tiny_inputs_equal_the_jax_helper(seed, B, L, W, image_size):
    cfg, jcfg = ModelConfig(**SMALL), JModelConfig(**SMALL)
    got = entry._tiny_inputs(cfg, 515, B, L, W, image_size, np.random.default_rng(seed))
    want = G._tiny_inputs(jcfg, 515, B, L, W, image_size, np.random.default_rng(seed))
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["image"].shape == (B, image_size, image_size, 3)


def test_fake_fusion_ds_equals_the_jax_class():
    cfg, jcfg = ModelConfig(**SMALL), JModelConfig(**SMALL)
    got, want = entry._FakeFusionDS(cfg, 515, n=9, L=16, W=9), G._FakeFusionDS(jcfg, 515, 9, 16, 9)
    assert len(got) == len(want) == 9 and got.cacheable_images() and want.cacheable_images()
    assert got.image_size == want.image_size and got.pixel_format == want.pixel_format == "float32"
    for k in ("ids", "lens", "mask", "eids"):
        np.testing.assert_array_equal(getattr(got.text, k), getattr(want.text, k), err_msg=k)
    np.testing.assert_array_equal(got.labels, want.labels)
    for i in (0, 4, 8):
        a, b = got.load_image(i), want.load_image(i)
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def test_fake_fusion_ds_pixel_table_keeps_float32():
    """The dry run's eval epoch gathers ``_FakeFusionDS``'s float32 pixels
    from a device table: the loader's table keeps the dataset's dtype and
    equals the JAX loader's table of the JAX class, row for row."""
    from mgnns_tpu.data.loader import _build_image_table_pipelined

    from mgnns_tpu_torch.data.loader import DeviceLoader

    cfg, jcfg = ModelConfig(**SMALL), JModelConfig(**SMALL)
    ds = entry._FakeFusionDS(cfg, 515, n=5, L=16, W=9)
    table, row_shape = DeviceLoader(ds, 2, device_images=True, device_text=True,
                                    device="cpu")._ensure_image_table()
    want, want_shape = _build_image_table_pipelined(G._FakeFusionDS(jcfg, 515, 5, 16, 9), 1)
    assert table.dtype == torch.float32 and row_shape == tuple(want_shape) == (64, 64, 3)
    np.testing.assert_array_equal(table.numpy(), np.asarray(want))


def test_unpad_like_and_geometries():
    got = np.arange(20.0).reshape(5, 4)
    np.testing.assert_array_equal(entry._unpad_like(got, np.zeros((3, 4))),
                                  G._unpad_like(got, np.zeros((3, 4))))
    # __graft_entry__.py:201-207
    assert entry._geometries(8) == ([(8, 1), (4, 2), (1, 8)], (4, 2))
    assert entry._geometries(4) == ([(4, 1), (2, 2), (1, 4)], (2, 2))
    assert entry._geometries(2) == ([(2, 1), (1, 2)], (2, 1))
    assert entry._geometries(1) == ([(1, 1)], (1, 1))


# ------------------------------------------------------------------ forward


@pytest.fixture(scope="module")
def jax_build():
    """``__graft_entry__._build``'s weights at 64 px, their port copies, and
    a batch of ``_tiny_inputs``."""
    jcfg = JModelConfig(**SMALL, compute_dtype="float32")
    jp, js, jc = G._build(jcfg, jcfg.edges_num, jax.random.key(0))
    batch = G._tiny_inputs(jcfg, jcfg.edges_num, B=2, L=16, W=9, image_size=64,
                           rng=np.random.default_rng(3))
    params, stats, consts = convert.from_jax_params(
        np_tree(jp), np_tree(js),
        dict(np_tree(jc), object_inp=batch["object_inp"], place_inp=batch["place_inp"]),
        device="cpu")
    return dict(jp=jp, js=js, jc=jc, batch=batch, params=params, stats=stats, consts=consts)


def test_build_draws_the_jax_constants(jax_build):
    """``_build``'s label embedding and label graphs are the JAX helper's,
    bit for bit (``np.random.default_rng(0)`` in the same order)."""
    params, _, consts = entry._build(ModelConfig(**SMALL), 515, 0, "cpu")
    np.testing.assert_array_equal(consts["label_query"].numpy(),
                                  np.asarray(jax_build["jc"]["label_query"]))
    for k in ("object_A", "place_A"):
        np.testing.assert_array_equal(params[k].numpy(), np.asarray(jax_build["jp"][k]))
    assert params["object_A"].shape == (80, 80) and params["place_A"].shape == (365, 365)


def test_forward_on_the_jax_weights_equals_jax(jax_build):
    """The entry forward (``_forward_fn``, the batch's GloVe inputs in place
    of ``consts``') on the JAX weights, float32: within atol 5e-3 of
    ``mgnns_apply``'s logits."""
    f = jax_build
    jcfg = JModelConfig(**SMALL)
    want = np.asarray(jax.jit(lambda p, s, c, b: j_mgnns_apply(p, s, c, b, cfg=jcfg,
                                                               train=False)[0])(
        f["jp"], f["js"], f["jc"], {k: jnp.asarray(v) for k, v in f["batch"].items()}))
    fn = entry._forward_fn(ModelConfig(**SMALL), f["consts"])
    got = fn(f["params"], f["stats"], {k: torch.from_numpy(v) for k, v in f["batch"].items()})
    assert got.shape == (2, 7) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=5e-3, rtol=0)


@pytest.mark.parametrize("side,depth", [("object_trunk", 101), ("place_trunk", 50)])
def test_bf16_trunks_on_the_jax_weights_equal_jax(jax_build, side, depth):
    """The entry's bf16 trunks (``compute_dtype="bfloat16"``) on the JAX
    weights and the batch's pixels: features within 4e-2 of scale of the
    JAX package's bf16 trunk (``__graft_entry__.py:353-366``'s bound; both
    lie ~1.2e-2 from their float32 features here).

    The bound is held on the trunks' features and not on the logits: with
    random weights and identity running statistics the object trunk's
    features reach ~2e4 here, the label attention saturates, and a bf16
    rounding can flip it.  On several seeds of this batch the JAX package's
    own bf16 logits then lie further than 4e-2 of scale from its float32
    logits, and so do the port's, on other seeds."""
    f = jax_build
    x = f["batch"]["image"]
    want = np.asarray(jresnet.resnet_apply(f["jp"][side], f["js"][side], jnp.asarray(x),
                                           depth=depth, train=False, dtype=jnp.bfloat16)[0],
                      np.float32)
    got = resnet.resnet_apply(f["params"][side], f["stats"][side], torch.from_numpy(x),
                              train=False, dtype=ModelConfig(**SMALL, compute_dtype="bfloat16")
                              .cdtype)[0]
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape == (2, 2, 2, 2048)
    got = got.float().numpy()
    assert np.abs(got - want).max() / max(1.0, np.abs(want).max()) <= 4e-2


def test_bf16_forward_after_the_trunks_equals_jax(jax_build, monkeypatch):
    """The rest of the bf16 forward (the trunks' bf16 features taken to
    float32, the memory banks, the image GCN, the label attention, the
    fusion stacks and the head) on the JAX weights: both packages' trunks
    return the same ReLU-like features in bf16, and the logits agree within
    4e-2 of scale (``__graft_entry__.py:353-366``'s bound).  The trunks
    themselves are held by the test above."""
    f = jax_build
    r = np.random.default_rng(11)
    feats = {depth: np.maximum(r.standard_normal((2, 2, 2, 2048)), 0).astype(np.float32)
             for depth in (101, 50)}
    calls = []

    def j_trunk(tp, ts, img, *, depth, dtype, **_):
        calls.append(("jax", depth, dtype))
        return jnp.asarray(feats[depth], dtype), ts

    def t_trunk(tp, ts, img, *, dtype, **_):
        depth = 101 if tp is f["params"]["object_trunk"] else 50
        calls.append(("torch", depth, dtype))
        return torch.from_numpy(feats[depth]).to(dtype), ts

    monkeypatch.setattr(jresnet, "resnet_apply", j_trunk)
    monkeypatch.setattr(resnet, "resnet_apply", t_trunk)
    jcfg = JModelConfig(**SMALL, compute_dtype="bfloat16")
    want = np.asarray(j_mgnns_apply(f["jp"], f["js"], f["jc"],
                                    {k: jnp.asarray(v) for k, v in f["batch"].items()},
                                    cfg=jcfg, train=False)[0], np.float32)
    fn = entry._forward_fn(ModelConfig(**SMALL, compute_dtype="bfloat16"), f["consts"])
    got = fn(f["params"], f["stats"], {k: torch.from_numpy(v) for k, v in f["batch"].items()})
    assert calls == [("jax", 101, jnp.bfloat16), ("jax", 50, jnp.bfloat16),
                     ("torch", 101, torch.bfloat16), ("torch", 50, torch.bfloat16)]
    assert got.shape == (2, 7) and np.isfinite(want).all()
    err = np.abs(got.float().numpy() - want).max() / max(1.0, np.abs(want).max())
    assert err <= 4e-2


def test_entry_on_the_cpu_at_production_shapes():
    """``entry(device="cpu")``: the JAX entry's config and shapes, finite
    ``[2, 7]`` logits; on the CPU K1's plain version runs, so the kernel's
    counter does not move."""
    fn, (params, stats, batch) = entry.entry(device="cpu")
    assert batch["ids"].shape == (2, 100) and batch["eids"].shape == (2, 100, 9)
    assert batch["image"].shape == (2, 448, 448, 3) and batch["image"].dtype == torch.float32
    assert params["text_gcn"]["node_embedding"].shape[0] == 4096
    assert params["text_gcn"]["edge_weight"].shape[0] == 8192
    before = edge_max.launches
    out = fn(params, stats, batch)
    assert out.shape == (2, 7) and torch.isfinite(out).all()
    assert edge_max.launches == before


# ------------------------------------------------------------------ dry run


@pytest.fixture(scope="module")
def dry():
    """``dryrun_multichip(4)`` on 4 CPU gloo ranks: its result and what it
    printed."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = entry.dryrun_multichip(4, device="cpu", timeout=600)
    out["printed"] = buf.getvalue()
    return out


def test_dryrun_geometries_and_summary(dry):
    assert dry["geometries"] == [[4, 1], [2, 2], [1, 4]] and dry["primary"] == [2, 2]
    assert dry["batch"] == 4 and len(dry["launches"]) == 4
    lines = dry["printed"].splitlines()
    assert [ln for ln in lines if ln.startswith("[dryrun] ")] == [
        "[dryrun] 1/4 sharded-vs-single 3-step parity @ mesh (4x1) ...",
        "[dryrun] 1/4 sharded-vs-single 3-step parity @ mesh (2x2) ...",
        "[dryrun] 1/4 sharded-vs-single 3-step parity @ mesh (1x4) ...",
        "[dryrun] 2/4 fused SPMD table-gather eval epoch ...",
        "[dryrun] 3/4 sharded checkpoint save/restore ...",
        "[dryrun] 4/4 bf16 sharded-vs-single parity @ mesh (2x2) ..."]
    assert lines[-1].startswith("dryrun_multichip(4): 3-step parity ok @ meshes "
                                "['4x1', '2x2', '1x4']")
    # the three steps train: the batch's eval loss falls
    assert dry["eval_loss_after"] < dry["eval_loss_before"]
    # on the CPU the kernels' plain versions run
    assert all(r["k1"] == r["k2"] == 0 for r in dry["launches"])


@pytest.mark.parametrize("geometry", ["4x1", "2x2", "1x4"])
def test_dryrun_parity_at_each_geometry(dry, geometry):
    """Each sharded step's loss within 1e-4 of the one-device step from the
    same state, its confusion matrix and the trajectory's equal, the
    parameters within rtol 5e-4 / atol 5e-5 each step and after the three
    steps (``_worst`` at most 1); on a model axis the odd-sized node table
    split into ceil(257 / m) rows a rank with zero padding rows."""
    rep = dry["parity"][geometry]
    assert rep["max_loss_rel"] <= 1e-4 and len(rep["losses"]) == 3
    assert all(np.isfinite(rep["losses"]))
    assert rep["confusion_equal"]
    assert rep["step_param_worst"] <= 1.0 and rep["param_worst"] <= 1.0
    m = int(geometry.split("x")[1])
    if m > 1:
        for key in ("table", "table_after"):
            assert rep[key] == {"sharded": True, "rows": -(-257 // m), "padding_zero": True}
    else:
        assert "table" not in rep


def test_dryrun_eval_epoch(dry):
    """The primary mesh's eval epoch from device tables runs the plan path
    over all N = 2B+1 records, its confusion matrix equals one device's and
    its loss is within 1e-4."""
    ev = dry["eval"]
    assert ev["fused"] and ev["n"] == 9 and ev["confusion_sum"] == 9 and ev["confusion_equal"]
    assert abs(ev["loss"] - ev["loss_ref"]) <= 1e-4 * max(1.0, abs(ev["loss_ref"]))


def test_dryrun_checkpoint_round_trip(dry):
    ck = dry["checkpoint"]
    assert ck["bit_equal"] and ck["step"] == ck["step_before"] == 3
    assert ck["table"]["sharded"] and ck["table"]["rows"] == 129


def test_dryrun_bf16_leg(dry):
    b = dry["bf16"]
    assert b["fwd_drift"] <= 4e-2
    assert np.isfinite(b["loss"]) and abs(b["loss"] - b["loss_ref"]) <= 4e-2 * max(
        1.0, abs(b["loss_ref"]))


# ------------------------------------------------------------------ watchdog


def _sleepers(codes: list) -> list:
    return [subprocess.Popen([sys.executable, "-c", "import sys, time; time.sleep(60)"
                              if c is None else f"import sys; sys.exit({c})"]) for c in codes]


@pytest.mark.parametrize("case", ["failing_rank", "timeout"])
def test_a_failing_or_stuck_rank_fails_the_call(case):
    """``_wait_ranks`` raises as soon as one rank exits non-zero while the
    others would wait for it, or once the timeout passes; ``_run_ranks``'s
    ``finally`` then kills the rest."""
    procs = _sleepers([None, 3] if case == "failing_rank" else [None, None])
    t0 = time.monotonic()
    try:
        with pytest.raises(RuntimeError, match="rank 1 exited with 3" if case == "failing_rank"
                           else r"ranks \[0, 1\] still running after 1.0 s"):
            entry._wait_ranks(procs, 30.0 if case == "failing_rank" else 1.0)
    finally:
        for p in procs:
            p.kill()
            p.wait()
    assert time.monotonic() - t0 < 20


def test_dryrun_reports_a_failing_rank_with_its_log(tmp_path):
    """Ranks started as the dry run starts them, on a spec every rank
    refuses, fail the call with a rank's traceback."""
    with open(tmp_path / "spec.json", "w") as f:
        json.dump({"n_devices": 2, "device": "nosuchdevice"}, f)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=r"(?s)rank \d exited with 1.*nosuchdevice"):
        entry._run_ranks(str(tmp_path), 2, "cpu", 120.0)
    assert time.monotonic() - t0 < 100
