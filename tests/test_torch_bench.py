"""The port's measuring helpers (``mgnns_tpu_torch/tools/{_bench_util,
roofline}.py``) on the CPU, at tiny widths (64 px, 5/6 label classes,
L=16): the flagship data, the FLOP counts against the closed form and
XLA's, and the measuring tools' refusal to run without a card."""

import contextlib
import io

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mgnns_tpu.config import ModelConfig as JModelConfig
from mgnns_tpu.models.mgnns import mgnns_apply as j_mgnns_apply
from mgnns_tpu.models.mgnns import mgnns_init as j_mgnns_init

from mgnns_tpu_torch.config import ModelConfig, TextGraphConfig
from mgnns_tpu_torch.data.loader import DeviceLoader
from mgnns_tpu_torch.engine.metrics import confusion_init
from mgnns_tpu_torch.engine.train import Engine
from mgnns_tpu_torch.models.text_only import text_model_apply, text_model_init
from mgnns_tpu_torch.nn.resnet import RESNET_LAYERS
from mgnns_tpu_torch.tools import _bench_util as U
from mgnns_tpu_torch.tools import roofline

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


# ------------------------------------------------- against the JAX package


def _port_kw(data) -> dict:
    return dict(vocab_size=len(data.vocab), edges_num=data.graph.num_edges, image_size=64,
                object_num_classes=5, place_num_classes=6)


# ------------------------------------------------------------------ FLOPs


@pytest.mark.parametrize("freeze_trunks", [False, True])
def test_flop_counter_equals_the_closed_form(data, freeze_trunks):
    """``FlopCounterMode`` over the fusion model's eval forward and one
    ``Engine.train_step`` (frozen BatchNorm) counts exactly the closed form."""
    m = U.flagship_model(data, device=CPU, compute_dtype="float32", bn_mode="frozen",
                         freeze_trunks=freeze_trunks)
    batch = first_batch(data.ds)
    with torch.inference_mode():
        assert roofline.counted_flops(
            lambda: m.apply_fn(m.params, m.bstats, {k: batch[k] for k in EVAL_KEYS},
                               train=False, generator=None)) == \
            roofline.forward_flops(m.cfg, B, L)
    eng = Engine(m.apply_fn, m.params, m.bstats, num_classes=7, freeze_trunks=freeze_trunks,
                 device=CPU)
    assert roofline.counted_flops(eng.train_step, batch, confusion_init(7, CPU)) == \
        roofline.train_step_flops(m.cfg, B, L)


def test_flop_counter_equals_the_closed_form_text_and_trunks(data):
    params = text_model_init(len(data.vocab), 7, data.graph.num_edges, device=CPU)
    batch = first_batch(data.ds)
    with torch.inference_mode():
        assert roofline.counted_flops(
            lambda: text_model_apply(params, {k: batch[k] for k in ("ids", "lens", "eids")},
                                     ngram=data.graph_cfg.ngram)) == \
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


def test_xla_count_of_the_jax_forward_holds_the_closed_form(data):
    """XLA's ``cost_analysis()["flops"]`` of the JAX eval forward at the tiny
    data's shapes (float32, trunks unrolled so that XLA's count covers every
    block) against the closed form.  XLA counts a conv's
    multiply-adds over the taps that land inside its input only, so the
    closed form is taken without the taps on zero padding (at 64 px they
    are 12% of it; at 448 px 2%), and XLA adds its elementwise work on top:
    the ratio measured here is 1.016, held to [1, 1.05]."""
    c = data.consts_np
    jcfg = JModelConfig(**_port_kw(data), unroll_trunks=True)
    jp, js, jc = j_mgnns_init(jax.random.key(0), jcfg, num_edges=data.graph.num_edges,
                              label_embedding=c["label_embedding"], object_A=c["object_A"],
                              place_A=c["place_A"])
    batch = first_batch(data.ds)
    jbatch = {k: jnp.asarray(np.asarray(batch[k])) for k in EVAL_KEYS}
    jbatch.update(object_inp=jnp.asarray(c["object_inp"]), place_inp=jnp.asarray(c["place_inp"]))
    jfwd = jax.jit(lambda p, s, cc, b: j_mgnns_apply(p, s, cc, b, cfg=jcfg, train=False)[0])
    ca = jfwd.lower(jp, js, jc, jbatch).compile().cost_analysis()
    xla = float((ca[0] if isinstance(ca, list) else ca)["flops"])
    closed = roofline.forward_flops(ModelConfig(**_port_kw(data)), B, L)
    inside = closed - sum(_padding_taps_flops(d, 64, B) for d in (101, 50))
    assert 1.0 <= xla / inside <= 1.05, (xla, closed, inside)


# ------------------------------------------------------------- no card


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA default does not raise")


@pytest.mark.parametrize("entry", ["roofline", "entry.entry", "entry.dryrun_multichip",
                                   "full_split_fused_eval", "eval_batch_ladder",
                                   "warmup_breakdown"])
def test_entry_points_raise_without_a_card(no_cuda, entry):
    """Without ``platform="cpu"`` the measuring tools and the entry surface
    run on the card, and raise where there is none, before any work."""
    from mgnns_tpu_torch import entry as entry_mod
    from mgnns_tpu_torch.tools import eval_batch_ladder, full_split_fused_eval, warmup_breakdown

    fn = {"roofline": roofline.main,
          "entry.entry": lambda argv: entry_mod.entry(),
          "entry.dryrun_multichip": lambda argv: entry_mod.dryrun_multichip(2),
          "full_split_fused_eval": full_split_fused_eval.main,
          "eval_batch_ladder": eval_batch_ladder.main,
          "warmup_breakdown": warmup_breakdown.main}[entry]
    with pytest.raises(RuntimeError, match="cuda"):
        fn([])
