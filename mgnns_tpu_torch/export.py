"""Serving artifacts: a :class:`~mgnns_tpu_torch.serving.Predictor` written
as a self-contained directory and served again without the model code
(``mgnns_tpu/export.py``).

The serving forward (:func:`mgnns_tpu_torch.serving.eval_probs`: the eval
forward and the softmax) is traced once by :func:`torch.export.export` into
an ``ExportedProgram`` and saved with :func:`torch.export.save`.
:func:`load_exported` loads it in a fresh process, moves it to the device and
serves it through a ``Predictor``; it builds no model and traces nothing.
K1 (``mgnns::edge_max_forward``) is a node of the program, so the program
launches the CUDA kernel on the card and its plain version on the CPU.

Artifact layout (one directory)::

    model.pt2          the ExportedProgram (torch.export.save)
    params.npz         the params / batch_stats leaves, one array each
    params_tree.json   the key paths that rebuild the trees
    preproc.npz/json   vocab, PMI graph, label map, graph config
    meta.json          text_only / image_size / max_batch / input template,
                       conv precision and compute dtype

As in the JAX package, the weights stay outside the program (it takes them as
arguments): ``params.npz`` can be swapped for a newer fine-tune of the same
shapes without exporting again.  The fusion model's constants (label GloVe
query, object / place GloVe inputs) are buffers of the exported module and
bake into the program.  The trees are the port's (OIHW, unstacked trunks,
:mod:`mgnns_tpu_torch.convert`), so a port artifact and a JAX one hold
different ``params.npz`` and each package refuses the other's.

The artifact holds one batch shape, ``max_batch``, as the JAX one does: the
loaded Predictor pads every chunk to it.  A float32 trunk convolution in the
program runs under the package's IEEE pin
(:func:`mgnns_tpu_torch.nn.resnet.ieee_float32_convs`), which
:func:`load_exported` enters around each call: the graph records the
convolution, not the process-wide cuDNN flag.

Usage::

    from mgnns_tpu_torch.export import export_predictor, load_exported
    export_predictor(predictor, "artifacts/mgnns-v1")
    pred = load_exported("artifacts/mgnns-v1")          # on the card
    pred.predict([{"text": "what a wonderful day"}])
"""

from __future__ import annotations

import contextlib
import json
import os

import numpy as np
import torch
from torch.export.passes import move_to_device_pass

from mgnns_tpu_torch.data.text import encode_texts
from mgnns_tpu_torch.kernels import edge_max  # noqa: F401  (registers the programs' mgnns:: ops)
from mgnns_tpu_torch.nn.resnet import ieee_float32_convs
from mgnns_tpu_torch.serving import Predictor, eval_probs, load_preproc, save_preproc
from mgnns_tpu_torch.utils import resolve_device

EXPORT_FILE = "model.pt2"
JAX_EXPORT_FILE = "model.jaxexport"  # the JAX package's program file
PARAMS_NPZ = "params.npz"
TREE_JSON = "params_tree.json"
META_JSON = "meta.json"
CONV_FP32_PRECISION = "ieee"

# ------------------------------------------------------------------ trees


def _flatten_with_paths(tree):
    """(paths, leaves) where each path is a list of [tag, key] steps -- tag
    'k' for a dict key (sorted), 'i' for a sequence index -- the JSON format
    of ``mgnns_tpu/export.py:53-70``."""
    paths, leaves = [], []

    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + [["k", k]])
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, path + [["i", i]])
        else:
            paths.append(path)
            leaves.append(node)

    walk(tree, [])
    return paths, leaves


def _unflatten_from_paths(paths, leaves):
    """The tree of :func:`_flatten_with_paths`' output: dicts in sorted key
    order, sequences as lists; containers without leaves are gone."""
    if not paths:
        return {}
    if not paths[0]:  # a bare leaf
        return leaves[0]
    root: dict | list = {} if paths[0][0][0] == "k" else []

    def ensure(container, step, nxt):
        tag, key = step
        empty = ({} if nxt[0] == "k" else []) if nxt is not None else None
        if tag == "k":
            if empty is not None and key not in container:
                container[key] = empty
            return container.get(key)
        while len(container) <= key:
            container.append(None)
        if empty is not None and container[key] is None:
            container[key] = empty
        return container[key]

    for path, leaf in zip(paths, leaves):
        node = root
        for d, step in enumerate(path[:-1]):
            node = ensure(node, step, path[d + 1])
        tag, key = path[-1]
        if tag == "k":
            node[key] = leaf
        else:
            while len(node) <= key:
                node.append(None)
            node[key] = leaf
    return root


def _weight_tree(params, batch_stats) -> dict:
    """``{"params", "batch_stats"}`` rebuilt as :func:`load_weights` rebuilds
    it: the exported program checks its inputs' tree structure, dict key
    order included."""
    return _unflatten_from_paths(*_flatten_with_paths(
        {"params": params, "batch_stats": batch_stats or {}}))


def save_weights(out_dir: str, params, batch_stats) -> None:
    paths, leaves = _flatten_with_paths({"params": params, "batch_stats": batch_stats or {}})
    # uncompressed: trained float32 weights barely compress, and zlib over
    # the fusion model's ~350 MB would take longer than the export
    np.savez(os.path.join(out_dir, PARAMS_NPZ),
             **{str(i): leaf.detach().cpu().numpy() for i, leaf in enumerate(leaves)})
    with open(os.path.join(out_dir, TREE_JSON), "w") as f:
        json.dump(paths, f)


def load_weights(out_dir: str, device="cuda"):
    """(params, batch_stats) as tensors on ``device``; a text-only model's
    ``batch_stats`` is ``{}``."""
    dev = resolve_device(device)
    with open(os.path.join(out_dir, TREE_JSON)) as f:
        paths = json.load(f)
    with np.load(os.path.join(out_dir, PARAMS_NPZ)) as z:
        leaves = [torch.from_numpy(z[str(i)]).to(dev) for i in range(len(paths))]
    tree = _unflatten_from_paths(paths, leaves)
    return tree.get("params", {}), tree.get("batch_stats", {})


# ------------------------------------------------------------------ export


class _ServingForward(torch.nn.Module):
    """``eval_probs`` with the weights as arguments and the fusion model's
    constants as buffers, which ``torch.export`` bakes into the program."""

    def __init__(self, pred: Predictor):
        super().__init__()
        self.text_only = pred.text_only
        self.ngram = pred.graph_cfg.ngram
        self.cfg = pred.cfg
        self.const_names = sorted(pred.consts or {})
        for name in self.const_names:
            self.register_buffer(name, pred.consts[name])

    def forward(self, params: dict, batch_stats: dict, batch: dict) -> torch.Tensor:
        consts = {name: getattr(self, name) for name in self.const_names}
        return eval_probs(params, batch_stats, consts, batch,
                          text_only=self.text_only, ngram=self.ngram, cfg=self.cfg)


def _example_batch(pred: Predictor) -> dict:
    """A ``max_batch``-row input template with the shapes and dtypes that
    ``Predictor._encode_host`` gives a full chunk (the program is
    fixed-shape); its values do not matter."""
    B = pred.max_batch
    ids, lens, mask, eids = encode_texts(["export template"] * B, pred.w2i, pred.graph,
                                         pred.graph_cfg)
    batch = {"ids": ids, "lens": lens, "mask": mask, "eids": eids}
    if not pred.text_only:
        batch["image"] = np.zeros((B, pred.image_size, pred.image_size, 3), np.uint8)
    return batch


def export_predictor(pred: Predictor, out_dir: str) -> torch.export.ExportedProgram:
    """Write a self-contained serving artifact for ``pred`` to ``out_dir``:
    its serving forward traced by ``torch.export`` on its device at
    ``max_batch`` rows, without gradients.  Returns the program it saved."""
    if pred.forward_fn is not None:
        raise ValueError("this Predictor serves a loaded program; export the model it came from")
    if pred.cfg is not None and pred.cfg.text_encoder is not None:
        raise NotImplementedError("a model with the MoE text encoder cannot be exported yet: "
                                  "its routing has no export rules; serve it live")
    os.makedirs(out_dir, exist_ok=True)
    batch = _example_batch(pred)
    tree = _weight_tree(pred.params, pred.batch_stats)
    with torch.no_grad():
        ep = torch.export.export(
            _ServingForward(pred),
            (tree["params"], tree.get("batch_stats", {}),
             {k: torch.from_numpy(v).to(pred.device) for k, v in batch.items()}))
    # the example inputs hold every weight; the program needs none of them
    ep._example_inputs = None
    # saved on the CPU: load_exported moves it to the device it serves on, so
    # a program traced on either device serves on both
    ep = move_to_device_pass(ep, "cpu")
    torch.export.save(ep, os.path.join(out_dir, EXPORT_FILE))
    save_weights(out_dir, pred.params, pred.batch_stats)
    label_map = {v: k for k, v in pred.idx2label.items()}
    save_preproc(out_dir, pred.vocab, pred.graph, label_map, pred.graph_cfg)
    with open(os.path.join(out_dir, META_JSON), "w") as f:
        json.dump({
            "format_version": 1,
            "text_only": pred.text_only,
            "image_size": pred.image_size,
            "image_backend": pred.image_backend,
            "max_batch": pred.max_batch,
            "devices": ["cpu", "cuda"],
            "torch_version": torch.__version__,
            "conv_fp32_precision": CONV_FP32_PRECISION,
            "compute_dtype": pred.cfg.compute_dtype if pred.cfg is not None else "float32",
            "batch_template": {k: [list(v.shape), str(v.dtype)] for k, v in batch.items()},
        }, f, indent=1)
    return ep


# -------------------------------------------------------------------- load


def load_exported(
    out_dir: str,
    *,
    image_root: str = ".",
    image_backend: str | None = None,
    strict_images: bool = True,
    device="cuda",
) -> Predictor:
    """A :class:`Predictor` on ``device`` (which raises when it is CUDA and no
    card is present) whose forward is the artifact's exported program.

    Builds no model and traces nothing: the program, moved to ``device``,
    takes the artifact's weights and each padded ``max_batch`` chunk, under
    the artifact's float32 conv precision.
    """
    dev = resolve_device(device)
    path = os.path.join(out_dir, EXPORT_FILE)
    if not os.path.exists(path):
        if os.path.exists(os.path.join(out_dir, JAX_EXPORT_FILE)):
            raise FileNotFoundError(
                f"{out_dir} holds {JAX_EXPORT_FILE}, the JAX package's artifact "
                f"(mgnns_tpu.export); this package serves {EXPORT_FILE} artifacts")
        raise FileNotFoundError(f"no {EXPORT_FILE} in {out_dir}")
    with open(os.path.join(out_dir, META_JSON)) as f:
        meta = json.load(f)
    pre = load_preproc(out_dir)
    if pre is None:
        raise FileNotFoundError(f"no preproc artifacts in {out_dir}")
    vocab, graph, label_map, graph_cfg = pre
    if dev.type == "cuda" and dev.index is None:
        # the program's tensor-metadata checks compare devices: name the one
        # its tensors will have, index included
        dev = torch.device("cuda", torch.cuda.current_device())
    ep = move_to_device_pass(torch.export.load(path), dev)
    program = ep.module()
    params, batch_stats = load_weights(out_dir, dev)
    pinned = meta["conv_fp32_precision"] == CONV_FP32_PRECISION

    def forward(p, bs, batch):
        with ieee_float32_convs() if pinned else contextlib.nullcontext():
            return program(p, bs, batch)

    return Predictor(
        vocab=vocab, graph=graph, graph_cfg=graph_cfg, label_map=label_map,
        params=params, batch_stats=batch_stats, forward_fn=forward,
        image_size=meta["image_size"], image_backend=image_backend or meta["image_backend"],
        image_root=image_root, max_batch=meta["max_batch"], text_only=meta["text_only"],
        strict_images=strict_images,
        # the artifact holds one batch shape: no smaller buckets
        batch_buckets=[meta["max_batch"]], device=dev)
