"""The port's bench surface (``mgnns_tpu_torch.bench``, ``bench_torch.py``,
``mgnns_tpu_torch/tools/{_bench_util,roofline,bench_serving}.py``) on the
CPU, at tiny widths (64 px, 5/6 label classes, L=16): the flagship data, one
JSON line per mode, the bench's eval and text programs against the JAX
package, the FLOP counts, and the serving legs."""

import contextlib
import io
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mgnns_tpu.config import ModelConfig as JModelConfig
from mgnns_tpu.models.mgnns import mgnns_apply as j_mgnns_apply
from mgnns_tpu.models.mgnns import mgnns_init as j_mgnns_init
from mgnns_tpu.models.text_only import text_model_apply as j_text_model_apply
from mgnns_tpu.models.text_only import text_model_init as j_text_model_init

from mgnns_tpu_torch import bench, convert
from mgnns_tpu_torch.config import ModelConfig, TextGraphConfig
from mgnns_tpu_torch.data.loader import DeviceLoader
from mgnns_tpu_torch.engine.metrics import confusion_init
from mgnns_tpu_torch.engine.train import Engine
from mgnns_tpu_torch.models.text_only import text_model_init
from mgnns_tpu_torch.nn.resnet import RESNET_LAYERS
from mgnns_tpu_torch.serving import Predictor
from mgnns_tpu_torch.tools import _bench_util as U
from mgnns_tpu_torch.tools import bench_serving, roofline

from torch_train_common import few_torch_threads, np_tree  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"
B, L = 4, 16
TINY = dict(n_records=8, image_size=64, graph_cfg=TextGraphConfig(max_len=L),
            label_classes=(5, 6))
EVAL_KEYS = ("ids", "lens", "mask", "eids", "image")


@pytest.fixture(scope="module")
def data():
    return U.flagship_data("synthetic", **TINY)


def first_batch(ds) -> dict:
    it = iter(DeviceLoader(ds, B, device=CPU))
    batch = next(it)
    it.close()
    return batch


# ------------------------------------------------------------------ data


def test_flagship_data_is_seeded_and_is_the_smoke_tests_corpus():
    """The synthetic data is the same from the same seed, it is what
    ``chip_smoke.py`` builds its serving and training phases from (phase 3
    calls ``flagship_data``), and phase 3's PMI graph (321,875 edges) stands
    at the default graph config."""
    import chip_smoke

    a = U.flagship_data("synthetic", n_records=8, image_size=64)
    b = U.flagship_data("synthetic", n_records=8, image_size=64)
    assert chip_smoke.flagship_data is U.flagship_data
    vocab, texts = U.synthetic_corpus()
    assert a.vocab == vocab and len(vocab) == 20153
    assert a.ds.text.texts == texts[:8]
    assert a.graph.num_edges == 321875 and a.name == "synthetic"
    for k in ("ids", "lens", "mask", "eids"):
        np.testing.assert_array_equal(getattr(a.ds.text, k), getattr(b.ds.text, k))
    np.testing.assert_array_equal(a.ds.labels, b.ds.labels)
    np.testing.assert_array_equal(a.ds.load_image(3), b.ds.load_image(3))
    for k in a.consts_np:
        np.testing.assert_array_equal(a.consts_np[k], b.consts_np[k])
    assert a.consts_np["object_A"].shape == (80, 80) and a.consts_np["place_inp"].shape == (365, 300)
    # the arrays the loaders read, as a reference-layout tree gives them
    batch = first_batch(a.ds)
    assert set(EVAL_KEYS) | {"weight", "label"} <= set(batch)
    assert batch["image"].shape == (B, 64, 64, 3) and batch["image"].dtype == torch.uint8


def test_flagship_data_reads_a_reference_tree(tmp_path, monkeypatch):
    """``MGNNS_DATA`` names a tree in the reference's layout, read through
    the port's data modules; a tree that is not there raises."""
    root = str(tmp_path / "tree")
    with contextlib.redirect_stdout(io.StringIO()):
        U.cli_tree(root)
    monkeypatch.setenv("MGNNS_DATA", root)
    d = U.flagship_data(n_records=5, image_size=64)
    assert d.name == root and len(d.ds) == 5 and d.ds.num_classes == 3
    assert d.consts_np["object_A"].shape == (80, 80)
    assert first_batch(d.ds)["ids"].shape == (B, 100)
    monkeypatch.setenv("MGNNS_DATA", str(tmp_path / "absent"))
    with pytest.raises(FileNotFoundError, match="absent"):
        U.flagship_data()


def test_settings_read_bench_pys_environment():
    s = bench.settings({"MGNNS_BENCH_MODE": "train", "MGNNS_BENCH_REMAT": "block"})
    assert (s["batch_size"], s["n_samples"], s["platform"], s["trace"]) == (16, 512, "cuda", False)
    assert s["model"] == {"bn_mode": "frozen", "remat_policy": "block", "freeze_trunks": False,
                          "unroll_trunks": True, "stem_s2d": False}
    assert bench.settings({})["batch_size"] == 128
    assert bench.settings({"MGNNS_BENCH_MODE": "text"})["batch_size"] == 64
    with pytest.raises(ValueError, match="serve"):
        bench.settings({"MGNNS_BENCH_MODE": "serve"})
    with pytest.raises(ValueError, match="card"):
        bench.run("text", platform=CPU, trace=True)


# ------------------------------------------------------------- the bench


@pytest.mark.parametrize("mode", ["text", "full", "train"])
def test_bench_run_prints_one_json_line(data, mode, capsys):
    """One JSON line per mode with ``bench.py``'s metric name; on the CPU no
    card was measured, so the peak and the MFU are null."""
    model = dict(bench.settings({"MGNNS_BENCH_MODE": mode})["model"], compute_dtype="float32")
    out = bench.run(mode, platform=CPU, batch_size=B, data=data, model_overrides=model)
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == out
    assert out["metric"] == {"full": "mgnns_eval_samples_per_sec_per_chip",
                             "text": "text_channel_eval_samples_per_sec_per_chip",
                             "train": "mgnns_train_samples_per_sec_per_chip"}[mode]
    assert out["unit"] == "samples/s" and out["value"] > 0
    assert out["device"] == {"name": "cpu", "power_limit": None} and out["data"] == "synthetic"
    assert out["peak_tflops"] is None and out["mfu"] is None
    assert "launches" not in out and "trace" not in out
    if mode == "full":
        assert out["vs_baseline"] > 0 and out["live_pipeline_fused"]
        assert out["live_preds_differ_from_cached"] == 0
        assert out["flops_per_sample"] == roofline.forward_flops(
            ModelConfig(**_port_kw(data), bn_mode="batch"), B, L) / B
    elif mode == "train":
        assert out["vs_baseline"] is None and out["epoch_fused"]
        assert out["config"]["bn_mode"] == "frozen" and out["value_step_microbench"] > 0
    else:
        assert out["flops_per_sample"] == 2 * 300 * 7


# ------------------------------------------------- against the JAX package


def _port_kw(data) -> dict:
    return dict(vocab_size=len(data.vocab), edges_num=data.graph.num_edges, image_size=64,
                object_num_classes=5, place_num_classes=6)


@pytest.fixture(scope="module")
def jax_fusion(data):
    """The JAX package's fusion model at the tiny data's shapes (float32,
    trunks unrolled so that XLA's count covers every block), the same
    weights in the port, and one batch of the bench's loader."""
    c = data.consts_np
    jcfg = JModelConfig(**_port_kw(data), unroll_trunks=True)
    jp, js, jc = j_mgnns_init(jax.random.key(0), jcfg, num_edges=data.graph.num_edges,
                              label_embedding=c["label_embedding"], object_A=c["object_A"],
                              place_A=c["place_A"])
    params, stats, consts = convert.from_jax_params(
        np_tree(jp), np_tree(js),
        dict(np_tree(jc), object_inp=c["object_inp"], place_inp=c["place_inp"]), device=CPU)
    cfg = ModelConfig(**_port_kw(data))
    model = types.SimpleNamespace(cfg=cfg, params=params, bstats=stats, consts=consts,
                                  apply_fn=U.fusion_apply_fn(cfg, consts))
    batch = first_batch(data.ds)
    jbatch = {k: jnp.asarray(np.asarray(batch[k])) for k in EVAL_KEYS}
    jbatch.update(object_inp=jnp.asarray(c["object_inp"]), place_inp=jnp.asarray(c["place_inp"]))
    jfwd = jax.jit(lambda p, s, cc, b: j_mgnns_apply(p, s, cc, b, cfg=jcfg, train=False)[0])
    return types.SimpleNamespace(jcfg=jcfg, jargs=(jp, js, jc, jbatch), jfwd=jfwd, model=model,
                                 batch=batch)


def test_bench_eval_program_matches_jax(jax_fusion):
    """The bench's eval logits on the JAX package's weights and batch: atol
    5e-3 (``tests/test_full_parity.py``'s), argmax equal where the margin
    exceeds it."""
    f = jax_fusion
    want = np.asarray(f.jfwd(*f.jargs))
    got = bench.eval_logits(f.model, f.batch).numpy()
    np.testing.assert_allclose(got, want, atol=5e-3, rtol=0)
    top2 = np.sort(want, axis=1)[:, -2:]
    sure = top2[:, 1] - top2[:, 0] > 5e-3
    assert (got.argmax(1) == want.argmax(1))[sure].all()


def test_bench_text_program_matches_jax_pallas(data):
    """The text mode's forward against ``text_model_apply(use_pallas=True)``
    (the Pallas kernel in interpret mode) on the same weights, at 1e-5."""
    jp = j_text_model_init(jax.random.key(1), len(data.vocab), 7, data.graph.num_edges,
                           edge_weights=np.random.default_rng(2).uniform(
                               0.5, 1.5, (data.graph.num_edges, 1)).astype(np.float32))
    params = convert.text_model_from_jax_params(np_tree(jp), device=CPU)
    batch = first_batch(data.ds)
    keys = ("ids", "lens", "eids")
    want = np.asarray(j_text_model_apply(jp, {k: jnp.asarray(np.asarray(batch[k])) for k in keys},
                                         ngram=data.graph_cfg.ngram, use_pallas=True))
    got = bench.text_logits(params, batch, data.graph_cfg.ngram).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


# ------------------------------------------------------------------ FLOPs


@pytest.mark.parametrize("freeze_trunks", [False, True])
def test_flop_counter_equals_the_closed_form(data, freeze_trunks):
    """``FlopCounterMode`` over the bench's eval forward and one
    ``Engine.train_step`` (frozen BatchNorm) counts exactly the closed form."""
    m = U.flagship_model(data, device=CPU, compute_dtype="float32", bn_mode="frozen",
                         freeze_trunks=freeze_trunks)
    batch = first_batch(data.ds)
    assert roofline.counted_flops(bench.eval_logits, m, batch) == \
        roofline.forward_flops(m.cfg, B, L)
    eng = Engine(m.apply_fn, m.params, m.bstats, num_classes=7, freeze_trunks=freeze_trunks,
                 device=CPU)
    assert roofline.counted_flops(eng.train_step, batch, confusion_init(7, CPU)) == \
        roofline.train_step_flops(m.cfg, B, L)


def test_flop_counter_equals_the_closed_form_text_and_trunks(data):
    params = text_model_init(len(data.vocab), 7, data.graph.num_edges, device=CPU)
    batch = first_batch(data.ds)
    assert roofline.counted_flops(bench.text_logits, params, batch, data.graph_cfg.ngram) == \
        roofline.text_forward_flops(7, B)
    x = torch.randn(2, 64, 64, 3)
    for depth in (101, 50):
        fn, p = roofline.trunk_grad_fn(depth, torch.float32, CPU)
        assert roofline.counted_flops(fn, p, x) == roofline.trunk_grad_flops(depth, 64, 2)
    # the trunks' output grid at the model's sizes
    assert roofline.feature_pixels(448) == 196 and roofline.feature_pixels(64) == 4


def _padding_taps_flops(depth: int, image_size: int, batch: int) -> int:
    """FLOPs of a trunk's conv taps that fall on zero padding."""
    def taps(n, k, s, p):  # per spatial dim: (all taps, taps inside the input)
        o = (n + 2 * p - k) // s + 1
        return o * k, sum(0 <= i * s - p + j < n for i in range(o) for j in range(k))

    total = 0
    n = image_size
    convs = [(n, 3, 64, 7, 2, 3)]
    n = (n + 6 - 7) // 2 + 1
    n = (n + 2 - 3) // 2 + 1
    cin = 64
    for li, (blocks, width) in enumerate(zip(RESNET_LAYERS[depth], (64, 128, 256, 512)),
                                         start=1):
        for b in range(blocks):
            st = 2 if (li > 1 and b == 0) else 1
            convs.append((n, width, width, 3, st, 1))
            n = (n + 2 - 3) // st + 1
    for n_in, ci, co, k, s, p in convs:
        full, inside = taps(n_in, k, s, p)
        total += 2 * batch * ci * co * (full ** 2 - inside ** 2)
    return total


def test_xla_count_of_the_jax_forward_holds_the_closed_form(jax_fusion):
    """XLA's ``cost_analysis()["flops"]`` of the JAX eval forward (the same
    weights and batch) against the closed form.  XLA counts a conv's
    multiply-adds over the taps that land inside its input only, so the
    closed form is taken without the taps on zero padding (at 64 px they
    are 12% of it; at 448 px 2%), and XLA adds its elementwise work on top:
    the ratio measured here is 1.016, held to [1, 1.05]."""
    f = jax_fusion
    ca = f.jfwd.lower(*f.jargs).compile().cost_analysis()
    xla = float((ca[0] if isinstance(ca, list) else ca)["flops"])
    closed = roofline.forward_flops(f.model.cfg, B, L)
    inside = closed - sum(_padding_taps_flops(d, 64, B) for d in (101, 50))
    assert 1.0 <= xla / inside <= 1.05, (xla, closed, inside)


# ---------------------------------------------------------------- serving


def _predictor(data, text_only: bool) -> Predictor:
    common = dict(vocab=data.vocab, graph=data.graph, graph_cfg=data.graph_cfg,
                  label_map={n: i for i, n in enumerate(U.EMOTIONS)}, max_batch=4, device=CPU)
    if text_only:
        return Predictor(params=text_model_init(len(data.vocab), 7, data.graph.num_edges,
                                                device=CPU), text_only=True, **common)
    m = U.flagship_model(data, device=CPU, compute_dtype="float32")
    return Predictor(params=m.params, batch_stats=m.bstats, consts=m.consts, cfg=m.cfg,
                     image_backend="synthetic", strict_images=False, **common)


@pytest.mark.parametrize("text_only", [True, False], ids=["text", "fusion"])
def test_bench_serving_legs_answer_as_predict(data, text_only):
    """The direct, sustained and HTTP legs with 2 clients x 2 requests: every
    answer equals in-process ``predict`` (labels, probabilities 1e-5)."""
    pred = _predictor(data, text_only)
    try:
        res = {"direct": bench_serving.bench_direct(pred, "t", n_iters=2),
               "sustained": bench_serving.bench_sustained(pred, "t", clients=2,
                                                          reqs_per_client=2),
               "http": bench_serving.bench_http(pred, "t", clients=2, reqs_per_client=2)}
    finally:
        pred.close()
    assert bench_serving.leg_ok(res), res
    assert res["http"]["requests"] == 4 and res["sustained"]["requests"] == 4
    assert set(res["direct"]) == {"b1", "b4"} and res["direct"]["b4"]["n"] == 2
    assert {"encode_text_ms", "forward_dispatch_ms", "readback_ms"} <= \
        set(res["direct"]["b1"]["stage_p50_ms"])
    if not text_only:
        fa = bench_serving.floor_analysis(res, 64)
        assert fa["pixel_mb_per_batch"] == 4 * 64 * 64 * 3 / 1e6
        assert "decode_p50_ms" in fa and "chip_forward_ms_b32_roofline" not in fa


# ------------------------------------------------------------- no card


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA default does not raise")


@pytest.mark.parametrize("entry", ["bench.main", "bench_torch.py", "roofline", "bench_serving"])
def test_entry_points_raise_without_a_card(no_cuda, entry, monkeypatch):
    """Without ``platform="cpu"`` the bench and its tools run on the card,
    and raise where there is none, before any work."""
    monkeypatch.setenv("MGNNS_BENCH_MODE", "text")
    monkeypatch.delenv("MGNNS_BENCH_PLATFORM", raising=False)
    if entry == "bench_torch.py":
        r = subprocess.run([sys.executable, os.path.join(ROOT, "bench_torch.py")], cwd=ROOT,
                           capture_output=True, text=True, timeout=120)
        assert r.returncode != 0 and "torch.cuda.is_available() is False" in r.stderr
        assert r.stdout == ""
        return
    fn = {"bench.main": bench.main, "roofline": roofline.main,
          "bench_serving": bench_serving.main}[entry]
    with pytest.raises(RuntimeError, match="cuda"):
        fn([])
