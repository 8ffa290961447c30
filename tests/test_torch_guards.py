"""The port's boundaries: it imports without JAX and never imports the JAX
package (nor the JAX entry file ``__graft_entry__.py``), and its entry
points run on the card or raise, never falling back to the CPU by
themselves."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "mgnns_tpu_torch")


def test_imports_with_jax_blocked():
    """Every module of the package imports with ``jax`` unimportable, and no
    module of the JAX package gets loaded."""
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "import mgnns_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(mgnns_tpu_torch.__path__, 'mgnns_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = [m for m in sys.modules if m in ('mgnns_tpu', '__graft_entry__') "
        "or m.startswith('mgnns_tpu.')]\n"
        "assert not bad, bad\n"
        "print(len(names))\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    assert int(r.stdout.split()[-1]) >= 31


def _sources():
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


@pytest.mark.parametrize("path", sorted(os.path.relpath(p, ROOT) for p in _sources()))
def test_source_imports_neither_jax_nor_jax_package(path):
    with open(os.path.join(ROOT, path)) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for n in names:
            top = n.split(".")[0]
            assert top not in ("jax", "jaxlib", "mgnns_tpu", "__graft_entry__"), \
                f"{path} imports {n}"


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA default does not raise")


def _tiny_predictor_args():
    from mgnns_tpu_torch.graphs.pmi import PmiGraph
    from mgnns_tpu_torch.models.text_only import text_model_init
    from mgnns_tpu_torch.config import TextGraphConfig

    graph = PmiGraph(5, np.zeros((0,), np.int64), np.zeros((0,), np.float32))
    params = text_model_init(5, 2, graph.num_edges, device="cpu")
    return dict(vocab=["PAD", "UNK", "a", "b", "c"], graph=graph,
                graph_cfg=TextGraphConfig(), label_map={"x": 0, "y": 1},
                params=params, text_only=True)


def test_predictor_defaults_to_cuda_and_raises_without_it(no_cuda):
    from mgnns_tpu_torch.serving import Predictor

    with pytest.raises(RuntimeError, match="cuda"):
        Predictor(**_tiny_predictor_args())


def test_predictor_runs_on_cpu_when_asked():
    from mgnns_tpu_torch.serving import Predictor

    pred = Predictor(device="cpu", max_batch=2, **_tiny_predictor_args())
    out = pred.predict([{"text": "a b"}, {"text": ""}, {"text": "c c a"}])
    pred.close()
    assert [sorted(o["probs"]) for o in out] == [["x", "y"]] * 3


@pytest.mark.parametrize("entry", ["text_model_init", "mgnns_init", "to_torch",
                                   "import_reference_state_dict", "from_engine_artifacts",
                                   "positional_encoding_table", "load_exported"])
def test_constructors_default_to_cuda_and_raise_without_it(no_cuda, entry, tmp_path):
    from mgnns_tpu_torch import convert
    from mgnns_tpu_torch.config import ModelConfig
    from mgnns_tpu_torch.export import load_exported
    from mgnns_tpu_torch.models.import_reference import import_reference_state_dict
    from mgnns_tpu_torch.models.mgnns import mgnns_init
    from mgnns_tpu_torch.models.text_only import text_model_init
    from mgnns_tpu_torch.nn.attention import positional_encoding_table
    from mgnns_tpu_torch.serving import Predictor

    with pytest.raises(RuntimeError, match="cuda"):
        if entry == "text_model_init":
            text_model_init(10, 3, 4)
        elif entry == "mgnns_init":
            z = np.zeros((2, 2))
            mgnns_init(ModelConfig(), num_edges=2, label_embedding=z, object_A=z,
                       place_A=z, object_inp=z, place_inp=z)
        elif entry == "to_torch":
            convert.to_torch({"w": np.zeros(3)})
        elif entry == "import_reference_state_dict":
            import_reference_state_dict({})
        elif entry == "from_engine_artifacts":
            Predictor.from_engine_artifacts(str(tmp_path), str(tmp_path), text_only=True)
        elif entry == "load_exported":
            load_exported(str(tmp_path))
        else:
            positional_encoding_table(4)


def test_bfloat16_config_is_accepted_with_float32_parameters():
    from mgnns_tpu_torch.config import ModelConfig
    from mgnns_tpu_torch.models.mgnns import mgnns_init
    from mgnns_tpu_torch.utils import tree_leaves

    cfg = ModelConfig(compute_dtype="bfloat16", vocab_size=5, object_num_classes=2,
                      place_num_classes=3)
    assert cfg.cdtype == torch.bfloat16
    assert ModelConfig().cdtype == torch.float32
    z2, z3 = np.eye(2), np.eye(3)
    params, stats, consts = mgnns_init(cfg, num_edges=2, label_embedding=np.zeros((7, 300)),
                                       object_A=z2, place_A=z3, object_inp=np.zeros((2, 300)),
                                       place_inp=np.zeros((3, 300)), device="cpu")
    assert {t.dtype for t in tree_leaves((params, stats, consts))} == {torch.float32}


def test_unknown_compute_dtype_raises():
    from mgnns_tpu_torch.config import ModelConfig

    with pytest.raises(ValueError, match="float16"):
        ModelConfig(compute_dtype="float16")


@pytest.mark.parametrize("cli", ["main", "predict", "serve", "predict --export_model",
                                 "predict --from_exported", "serve --from_exported"])
def test_cli_defaults_to_cuda_and_raises_without_it(no_cuda, cli, tmp_path):
    """The training, predict and serve CLIs run on the card unless given
    --platform cpu, also when they write or serve an exported artifact."""
    from mgnns_tpu_torch.cli import main, predict, serve

    argv = {"main": ["--text_only"],
            "predict": ["--checkpoint", str(tmp_path), "--input", "x.jsonl", "--text_only"],
            "serve": ["--checkpoint", str(tmp_path), "--text_only", "--port", "0"],
            "predict --export_model": ["--checkpoint", str(tmp_path), "--text_only",
                                       "--export_model", str(tmp_path / "art")],
            "predict --from_exported": ["--from_exported", str(tmp_path), "--input", "x.jsonl"],
            "serve --from_exported": ["--from_exported", str(tmp_path), "--port", "0"]}[cli]
    entry = {"main": main, "predict": predict, "serve": serve}[cli.split()[0]]
    with pytest.raises(RuntimeError, match="cuda"):
        entry.main(["--data_root_path", str(tmp_path)] + argv)


@pytest.mark.parametrize("entry", ["engine", "loader", "checkpoint_restore"])
def test_training_entry_points_default_to_cuda_and_raise_without_it(no_cuda, entry, tmp_path):
    """Engine, DeviceLoader and Checkpointer.restore run on the card unless
    given device='cpu', and raise without one."""
    from mgnns_tpu_torch.data.loader import DeviceLoader
    from mgnns_tpu_torch.engine.checkpoint import Checkpointer
    from mgnns_tpu_torch.engine.train import Engine

    apply_fn = lambda p, bs, batch, *, train, generator: (p["w"][None, :], bs)  # noqa: E731
    params = {"w": torch.zeros(2)}
    ck = Checkpointer(str(tmp_path / "ck"))
    ck.save(1, {"w": torch.ones(2)})
    if entry == "engine":
        with pytest.raises(RuntimeError, match="cuda"):
            Engine(apply_fn, params, {}, num_classes=2)
        assert Engine(apply_fn, params, {}, num_classes=2, device="cpu").device.type == "cpu"
    elif entry == "loader":
        ds = [0, 1, 2]  # three samples
        with pytest.raises(RuntimeError, match="cuda"):
            DeviceLoader(ds, 2)
        assert len(DeviceLoader(ds, 2, device="cpu")) == 2
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            ck.restore()
        assert ck.restore(device="cpu")["w"].device.type == "cpu"


@pytest.mark.parametrize("kernel", ["K1", "K2"])
def test_kernels_do_not_fall_back_when_the_build_fails(kernel, monkeypatch):
    """A CUDA tensor goes to the kernel or raises: when the build fails, the
    error surfaces and no plain version runs in its place.  (The launch
    functions, called directly on CPU stand-ins for CUDA tensors, reach the
    build without a card.)"""
    from mgnns_tpu_torch.kernels import build, edge_max

    def fail(name):
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(build, "load", fail)
    monkeypatch.setattr(edge_max, "_library", edge_max._library.__wrapped__)
    plain = []
    monkeypatch.setattr(edge_max, "window_max_aggregate_plain", lambda *a: plain.append(a))
    monkeypatch.setattr(edge_max, "window_max_aggregate_backward_plain", lambda *a: plain.append(a))
    emb, w = torch.zeros(2, 3, 4), torch.zeros(2, 3, 5)
    lens, g = torch.ones(2, dtype=torch.int32), torch.zeros(2, 3, 4)
    with pytest.raises(RuntimeError, match="nvcc"):
        if kernel == "K1":
            edge_max._launch(emb, w, lens, 2)
        else:
            edge_max._launch_bwd(emb, w, lens, g, 2)
    assert not plain
