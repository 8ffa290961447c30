"""Shared measurement scaffolding of the port's measuring tools.

The counterpart of the JAX package's ``tools/_bench_util.py``: one copy of
the slope timing, the measured bf16 peak, the card's description and the
flagship data and model setup, so that :mod:`mgnns_tpu_torch.tools.roofline`,
the other tools under :mod:`mgnns_tpu_torch.tools` and ``chip_smoke.py``
measure the same programs the same way.

Data.  ``MGNNS_DATA=<tree>`` reads a tree in the reference's layout
(``all_anno_json/val_all_anno.json``, the vocabulary, GloVe and adjacency
pickles, ``label.json``) through the port's ``data.text`` and
``data.dataset``.  Unset, or ``synthetic``, it is the seeded synthetic
corpus: 10,000 Zipf-like documents over a 20,153-word vocabulary (321,875
PMI edges), seeded 80/365-class label co-occurrences, GloVe stand-ins and
synthetic images.  Every result names which data ran.
"""

from __future__ import annotations

import json
import os
import pickle
import subprocess
import tempfile
import time
from types import SimpleNamespace

import numpy as np
import torch

from mgnns_tpu_torch.config import DataConfig, ModelConfig, TextGraphConfig
from mgnns_tpu_torch.utils import resolve_device

# where the measuring tools write their JSON lines (the JAX tools' results/r5/)
RESULTS_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "results", "torch")
# dense bf16 tensor-core rate of the H100 SXM (NVIDIA data sheet), TFLOP/s
BF16_DATASHEET_TFLOPS = 989.4
VOCAB_SIZE = 20153          # ModelConfig.vocab_size
N_DOCS = 10_000
EMOTIONS = ["angry", "bored", "calm", "fear", "happy", "love", "sad"]  # TumEmo's 7


def timed(fn, args, iters: int, readback) -> float:
    """Slope timing: warm once, run ``iters`` chained calls, then wait for
    them with ``torch.cuda.synchronize()`` (when CUDA is in use) and a real
    ``readback`` of one element.  Seconds per call."""
    out = fn(*args)
    _barrier(out, readback)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    _barrier(out, readback)
    return (time.perf_counter() - t0) / iters


def _barrier(out, readback) -> None:
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    readback(out)


def measured_bf16_peak(n: int = 8192, chain: int = 128, iters: int = 8,
                       device="cuda") -> float:
    """Sustained bf16 product rate of the card in TFLOP/s: ``chain`` chained,
    data-dependent ``n x n`` products per call (nothing can be skipped), one
    element read back.  The yardstick of every share of peak the tools
    report.  Raises if it reads over 105% of the H100's dense bf16 data-sheet
    rate, which no real card reaches."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(0)
    a = (torch.randn(n, n, generator=g, device=dev) / np.sqrt(n)).to(torch.bfloat16)
    x0 = torch.randn(n, n, generator=g, device=dev).to(torch.bfloat16)

    def chained(x, w):
        for _ in range(chain):
            x = x @ w
        return x

    dt = timed(chained, (x0, a), iters, readback=lambda o: float(o[0, 0]))
    tflops = chain * 2 * n ** 3 / dt / 1e12
    if tflops > 1.05 * BF16_DATASHEET_TFLOPS:
        raise RuntimeError(f"measured bf16 peak {tflops} TFLOP/s is over 105% of the data "
                           f"sheet's {BF16_DATASHEET_TFLOPS}: the timing is broken")
    return tflops


def device_info(device: torch.device) -> dict:
    """``{"name", "power_limit"}`` of the card as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them (the
    name alone, from torch, where ``nvidia-smi`` is missing); the CPU's
    ``{"name": "cpu", "power_limit": None}``."""
    if device.type != "cuda":
        return {"name": "cpu", "power_limit": None}
    index = device.index if device.index is not None else torch.cuda.current_device()
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader", "-i", str(index)],
                             capture_output=True, text=True, check=True, timeout=30).stdout
        name, power = (s.strip() for s in out.strip().splitlines()[0].split(","))
    except (OSError, subprocess.SubprocessError):
        name, power = torch.cuda.get_device_name(index), None
    return {"name": name, "power_limit": power}


def tool_device(argv, description: str) -> torch.device:
    """The device of a measuring tool from its command line: ``cuda:0``,
    which raises without a card, unless ``--platform cpu``."""
    import argparse

    p = argparse.ArgumentParser(description=description)
    p.add_argument("--platform", choices=["cuda", "cpu"], default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    return resolve_device("cuda:0" if p.parse_args(argv).platform == "cuda" else "cpu")


def write_result(name: str, out: dict) -> str:
    """Write a tool's result to ``RESULTS_DIR/<name>.json``, print it as one
    JSON line, and return the path."""
    os.makedirs(RESULTS_DIR, exist_ok=True)
    path = os.path.join(RESULTS_DIR, f"{name}.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=2)
    print(json.dumps(out), flush=True)
    return path


# idle seconds around each profiled run.  Without them a profiled captured
# epoch on the card lost up to a few thousand of its ~120,000 kernels in
# about four runs of ten, some at the trace window's start; with them none
# did (fault 3.7 in ROADMAP.md; ``tools/profiler_drops.py`` measures it)
PROFILE_MARGIN_S = 0.25


def kernel_events(events) -> list:
    """The kernels among a profile's ``events()`` or ``key_averages()`` (the
    GPU side of the model's and the engine's named ranges is left out)."""
    return [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.key.startswith(("mgnns.", "engine.", "ProfilerStep"))]


def device_kernels(prof) -> list:
    """Kernel events of a profile averaged by name."""
    return kernel_events(prof.key_averages())


def device_events(run, names: dict, margin_s: float = PROFILE_MARGIN_S, inspect=None) -> dict:
    """Device busy ms, kernel launches, and the launches of the kernels whose
    names contain each of ``names``' values (in any case), of one call of
    ``run()``, read from the profiler's device events of a second call (a
    first, warm-up cycle: events at the very start of a trace can be lost);
    ``"wall_ms"`` is that call's own wall time up to its ``synchronize()``
    (profiler on), ``"out"`` what it returned.  ``margin_s``: idle seconds
    before and after each call; ``inspect(prof)``, where given, reads the
    second call's profile into ``"inspected"``."""
    from torch.profiler import ProfilerActivity, profile, schedule

    got: dict = {}

    def ready(prof):
        got["kernels"] = device_kernels(prof)
        if inspect is not None:
            got["inspected"] = inspect(prof)

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA], schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=ready) as prof:
        for _ in range(2):
            time.sleep(margin_s)
            t0 = time.perf_counter()
            result = run()
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
            time.sleep(margin_s)
            prof.step()
    kernels = got["kernels"]
    out = {"out": result, "busy_ms": sum(e.self_device_time_total for e in kernels) / 1e3,
           "wall_ms": wall_s * 1e3, "launches": sum(e.count for e in kernels),
           "inspected": got.get("inspected")}
    for key, name in names.items():
        out[key] = sum(e.count for e in kernels if name.lower() in e.key.lower())
    return out


# ------------------------------------------------------------------ data


def synthetic_corpus(seed: int = 0):
    """10k documents of 5-90 tokens, Zipf-like over the 20,151 non-special
    words of a 20,153-word vocabulary (PAD, UNK first)."""
    r = np.random.default_rng(seed)
    vocab = ["PAD", "UNK"] + [f"w{i}" for i in range(VOCAB_SIZE - 2)]
    p = 1.0 / np.arange(1, VOCAB_SIZE - 1) ** 1.1
    lens = r.integers(5, 91, N_DOCS)
    toks = r.choice(VOCAB_SIZE - 2, size=int(lens.sum()), p=p / p.sum())
    words = np.array(vocab[2:])[toks]
    cuts = np.cumsum(lens)[:-1]
    return vocab, [" ".join(d) for d in np.split(words, cuts)]


def cooccurrence(C: int, r) -> dict:
    """A seeded ``{'nums', 'adj'}`` label co-occurrence of ``C`` classes."""
    return {"nums": r.integers(1, 200, C).astype(float),
            "adj": r.integers(0, 60, (C, C)).astype(float)}


def flagship_data(ref: str | None = None, n_records: int | None = None,
                  image_size: int = 448, *, graph_cfg: TextGraphConfig | None = None,
                  label_classes: tuple[int, int] = (80, 365)) -> SimpleNamespace:
    """The val split, its vocabulary, PMI graph and model constants at the
    reference's canonical config: the setup every tool measures.

    ``ref``: a tree in the reference's layout, or ``"synthetic"``; default
    ``MGNNS_DATA``, else ``"synthetic"``.  A tree that is not there raises.
    ``graph_cfg`` and ``label_classes`` (object, place) shrink the synthetic
    data for tests; a tree's own files fix them."""
    from mgnns_tpu_torch.data.dataset import TumblrDataset, load_constants
    from mgnns_tpu_torch.data.text import build_text_side, read_anno

    ref = ref or os.environ.get("MGNNS_DATA") or "synthetic"
    graph_cfg = graph_cfg or TextGraphConfig()
    if ref != "synthetic":
        if not os.path.isdir(ref):
            raise FileNotFoundError(f"no data tree at {ref!r} (MGNNS_DATA); unset it or pass "
                                    "'synthetic' for the seeded synthetic corpus")
        data_cfg = DataConfig(  # the reference ships no image files: synthetic pixels
            data_root_path=ref, object_inp_name=f"{ref}/glove/object_glove_word2vec.pkl",
            place_inp_name=f"{ref}/glove/place_glove_word2vec.pkl",
            label_glove_name=f"{ref}/tumblr_label_glove.pkl",
            object_adj_file=f"{ref}/adj/tumblr_objects_adj.pkl",
            place_adj_file=f"{ref}/adj/tumblr_resnet50_places_adj.pkl",
            image_backend="synthetic")
        vocab, graph, _ = build_text_side(ref, graph_cfg, [], pmi_phase="val")
        records = read_anno(ref, "val")[:n_records]
        ds = TumblrDataset(data_cfg, graph_cfg, "val", vocab, graph, image_size=image_size,
                           records=records)
        consts_np = load_constants(data_cfg, object_t=0.4, place_t=0.3)
        return SimpleNamespace(name=ref, graph_cfg=graph_cfg, vocab=vocab, graph=graph, ds=ds,
                               consts_np=consts_np)

    from mgnns_tpu_torch.graphs.cooccur import gen_A
    from mgnns_tpu_torch.graphs.pmi import cal_pmi

    vocab, texts = synthetic_corpus()
    graph = cal_pmi(texts, vocab, window_size=graph_cfg.window_size,
                    min_cooccurrence=graph_cfg.min_cooccurrence, max_len=graph_cfg.max_len)
    r = np.random.default_rng(1)
    cfg = ModelConfig()
    (n_obj, n_plc) = label_classes
    object_A, _ = gen_A(n_obj, cfg.object_t, cooccurrence(n_obj, r), cfg.gama)
    place_A, _ = gen_A(n_plc, cfg.place_t, cooccurrence(n_plc, r), cfg.gama)
    consts_np = {"label_embedding": r.standard_normal((len(EMOTIONS), 300)).astype(np.float32),
                 "object_A": object_A.astype(np.float32), "place_A": place_A.astype(np.float32),
                 "object_inp": r.standard_normal((n_obj, 300)).astype(np.float32),
                 "place_inp": r.standard_normal((n_plc, 300)).astype(np.float32)}
    n = N_DOCS if n_records is None else min(n_records, N_DOCS)
    labels = np.random.default_rng(2).integers(0, len(EMOTIONS), n)
    records = [{"id": f"s{i}", "text": texts[i], "image": f"synthetic_{i}.jpg",
                "label": EMOTIONS[labels[i]]} for i in range(n)]
    with tempfile.TemporaryDirectory(prefix="mgnns_bench_") as root:
        with open(os.path.join(root, "label.json"), "w") as f:
            json.dump({name: i for i, name in enumerate(EMOTIONS)}, f)
        ds = TumblrDataset(DataConfig(data_root_path=root, image_backend="synthetic"),
                           graph_cfg, "val", vocab, graph, image_size=image_size, records=records)
    return SimpleNamespace(name="synthetic", graph_cfg=graph_cfg, vocab=vocab, graph=graph,
                           ds=ds, consts_np=consts_np)


def fusion_apply_fn(cfg: ModelConfig, consts: dict):
    """The engine's ``apply_fn(params, batch_stats, batch, *, train,
    generator, axis=None, model=None)`` of the fusion model over ``consts``
    (``axis``, ``model``: the data and model axes an ``Engine(mesh=)``
    passes)."""
    from mgnns_tpu_torch.models.mgnns import mgnns_apply

    def apply_fn(p, bs, batch, *, train, generator, axis=None, model=None):
        logits, new_bs, aux = mgnns_apply(p, bs, consts, batch, cfg=cfg, train=train,
                                          generator=generator, axis=axis, model=model)
        return logits, new_bs, aux.get("head_diversity", 0.0)

    return apply_fn


def flagship_model(data: SimpleNamespace, *, device="cuda", seed: int = 0,
                   **cfg_overrides) -> SimpleNamespace:
    """The fusion model of ``data`` at bf16 (``ModelConfig(compute_dtype=
    "bfloat16")`` with the vocabulary, edges, label classes and image size
    of ``data``, and ``cfg_overrides``), its weights drawn from ``seed`` on
    ``device``, and its ``apply_fn`` over the constants on the device: the
    program the benchmark and the roofline measure."""
    from mgnns_tpu_torch.models.mgnns import mgnns_init

    c = data.consts_np
    kw = dict(vocab_size=len(data.vocab), edges_num=data.graph.num_edges,
              num_labels=data.ds.num_classes, compute_dtype="bfloat16",
              object_num_classes=c["object_A"].shape[0], place_num_classes=c["place_A"].shape[0],
              image_size=data.ds.image_size)
    kw.update(cfg_overrides)
    cfg = ModelConfig(**kw)
    params, bstats, consts = mgnns_init(
        cfg, num_edges=data.graph.num_edges, label_embedding=c["label_embedding"],
        object_A=c["object_A"], place_A=c["place_A"], object_inp=c["object_inp"],
        place_inp=c["place_inp"], seed=seed, device=device)
    return SimpleNamespace(cfg=cfg, params=params, bstats=bstats, consts=consts,
                           apply_fn=fusion_apply_fn(cfg, consts))


def live_eval(data: SimpleNamespace, *, device="cuda", **cfg_overrides) -> SimpleNamespace:
    """The eval headline's program over ``data``'s split: ``model``
    (:func:`flagship_model`), ``engine`` (``Engine(eval_only=True)`` on its
    weights) and ``loader(B)``, a ``DeviceLoader`` of the split in batches
    of ``B`` from device tables (``device_images``, ``device_text``).  An
    epoch of ``engine.eval_epoch(loader(B))`` builds the tables and captures
    the eval step at its first call and replays it over the epoch plan
    after."""
    from mgnns_tpu_torch.data.loader import DeviceLoader
    from mgnns_tpu_torch.engine.train import Engine

    model = flagship_model(data, device=device, **cfg_overrides)
    engine = Engine(model.apply_fn, model.params, model.bstats,
                    num_classes=data.ds.num_classes, steps_per_epoch=1, eval_only=True,
                    device=device)

    def loader(B: int):
        return DeviceLoader(data.ds, B, shuffle=False, num_threads=8, device_images=True,
                            device_text=True, device=device)

    return SimpleNamespace(model=model, engine=engine, loader=loader)


# ------------------------------------------------------------------ trees


def cli_tree(root: str) -> None:
    """A 3-class data tree whose words separate the classes (as
    ``tests/test_mvsa.py`` builds it): 90 records for each split, seeded
    GloVe pickles, and the adjacency pickles and vocabulary written by the
    port's ``prepare``."""
    from mgnns_tpu_torch.cli import prepare

    r = np.random.default_rng(0)
    pools = {"negative": ["bad", "sad", "awful", "hate", "terrible"],
             "neutral": ["table", "walk", "city", "day", "photo"],
             "positive": ["good", "great", "happy", "love", "wonderful"]}
    os.makedirs(os.path.join(root, "all_anno_json"))
    os.makedirs(os.path.join(root, "glove"))
    with open(os.path.join(root, "label.json"), "w") as f:
        json.dump({name: i for i, name in enumerate(pools)}, f)
    rows = []
    for i in range(90):
        label = list(pools)[i % 3]
        words = list(r.choice(pools[label], 5)) + list(r.choice(pools["neutral"], 2))
        rows.append({"id": f"c{i}", "text": " ".join(words), "image": f"img/{i}.jpg",
                     "label": label, "objects": [int(x) for x in r.integers(0, 80, 3)],
                     "places": [int(x) for x in r.integers(0, 365, 2)]})
    for phase in ("train", "val", "test"):
        with open(os.path.join(root, "all_anno_json", f"{phase}_all_anno.json"), "w") as f:
            f.writelines(json.dumps(rec) + "\n" for rec in rows)
    for rel, shape in (("glove/object_glove_word2vec.pkl", (80, 300)),
                       ("glove/place_glove_word2vec.pkl", (365, 300)),
                       ("tumblr_label_glove.pkl", (3, 300))):
        with open(os.path.join(root, rel), "wb") as f:
            pickle.dump(r.standard_normal(shape).astype(np.float32), f)
    for key, n, name in (("objects", 80, "tumblr_objects_adj.pkl"),
                         ("places", 365, "tumblr_resnet50_places_adj.pkl")):
        prepare.main(["adj", "--data_root_path", root, "--key", key, "--num_classes", str(n),
                      "--output", os.path.join(root, "adj", name)])
    prepare.main(["vocab", "--data_root_path", root, "--text_min_count", "1"])
