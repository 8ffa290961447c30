"""Weights of the reference PyTorch model, both ways.

Port of the JAX package's ``mgnns_tpu/models/import_reference.py``, with the
same name map.  :func:`import_reference_state_dict` turns a ``state_dict`` of
the reference ``Multi_GCN_Multihead_Att`` (reference
``models/Multi_GCN_Multihead_att.py:135-351``, checkpoints written by
``engine/...:624-643``) into the port's (params, batch_stats) trees;
:func:`export_reference_state_dict` does the reverse, so a model trained here
loads into reference-compatible tooling.

Name map (torch -> port).  ``nn.Linear`` weights are [out, in] and are
transposed; the position-wise ``Conv1d`` weights [out, in, 1] are squeezed
and transposed; LSTM and GRU matrices [G*H, D] are transposed; trunk convs
are OIHW in both, so the trunks only change names
(:func:`mgnns_tpu_torch.nn.resnet.import_torch_state_dict`):

  embedding.weight                          embedding.table (pad row zeroed)
  lstm.weight_ih_l{l}[_reverse] ...         lstm.layers[l][dir].{w_ih,w_hh,b_ih,b_hh}
  text_features.node_hidden.weight          text_gcn.node_embedding
  text_features.seq_edge_w.weight           text_gcn.edge_weight
  object_features.{0,1,4..7}.*              object_trunk.* (Sequential index ->
                                            torchvision names)
  place_features.{0,1,4..7}.*               place_trunk.*
  liner_img_{object,place}.*                liner_img_{object,place}.{w,b}
  gc1.weight / gc2.weight                   gc1.w / gc2.w  (already [in, out])
  {object,place}_attention.{w_q,w_k,w_v,fc} {object,place}_attention.*
  {object,place}_linear_5, _x_linear        same names, .{w,b}
  *_multi_head_att.{i}.slf_attn.*           *_mha[i].slf_attn.{w_qs,w_ks,w_vs,fc,ln}
  *_multi_head_att.{i}.pos_ffn.*            *_mha[i].pos_ffn.{w_1,w_2,ln}
  multi_linear_{1,2}.*                      multi_linear_{1,2}.{w,b}
  object_A / place_A                        object_A / place_A

The dead reference modules (:data:`mgnns_tpu_torch.models.mgnns.DEAD_MODULES`:
``rnn``, the gates, ``{object,place}_linear_1..3``, the
``text_{object,place}_text`` blocks and ``text_features.Linear``) are built
by the reference and never run, so every reference checkpoint holds them.
Import picks up each one that is complete in the ``state_dict`` and treats a
partial one (a pruned or truncated checkpoint) as absent; export emits them
only when the params carry them (``mgnns_init(include_dead_modules=True)``),
which is what a reference-side ``load_state_dict(strict=True)`` needs.
"""

from __future__ import annotations

import numpy as np
import torch

from mgnns_tpu_torch.nn import resnet
from mgnns_tpu_torch.utils import resolve_device, tree_to

_MHA_STACKS = {
    "img_object_text_multi_head_att": "img_object_text_mha",
    "img_place_text_multi_head_att": "img_place_text_mha",
    "text_img_object_multi_head_att": "text_img_object_mha",
    "text_img_place_multi_head_att": "text_img_place_mha",
}
_TRUNK_SEQ = {"0": "conv1", "1": "bn1", "4": "layer1", "5": "layer2",
              "6": "layer3", "7": "layer4"}


def _numpy_scalar_globals() -> list:
    """What a pickled numpy scalar names (the scalar constructor under the
    module names of numpy 1 and 2, and the dtypes), for a weights-only load."""
    try:
        from numpy._core.multiarray import scalar
    except ImportError:  # numpy 1.x
        from numpy.core.multiarray import scalar
    dtypes = {type(np.dtype(c)) for c in np.typecodes["All"]}
    return [(scalar, "numpy.core.multiarray.scalar"), (scalar, "numpy._core.multiarray.scalar"),
            np.dtype, *dtypes]


def load_torch_state_dict(path: str) -> tuple[dict, dict]:
    """(state_dict, meta) from a reference or torchvision ``.pth[.tar]``
    file: a bare ``state_dict`` or the ``{'epoch', 'arch', 'state_dict',
    'best_score'}`` wrapper (the reference's and the Places365 release's
    format), with DataParallel's ``module.`` prefix stripped
    (``mgnns_tpu/cli/main.py:252-272``).  The load is weights-only; numpy
    scalars (a reference wrapper's ``best_score``) are allowed."""
    with torch.serialization.safe_globals(_numpy_scalar_globals()):
        obj = torch.load(path, map_location="cpu", weights_only=True)
    meta = {}
    if isinstance(obj, dict) and "state_dict" in obj:
        meta = {k: obj[k] for k in ("epoch", "best_score") if k in obj}
        obj = obj["state_dict"]
    sd = {k[len("module."):] if k.startswith("module.") else k: v for k, v in obj.items()}
    return sd, meta


def _arr(v) -> torch.Tensor:
    """A float32 CPU copy of a tensor or numpy array."""
    return torch.as_tensor(v).detach().to("cpu", torch.float32).clone()


def _linear(sd, name):
    p = {"w": _arr(sd[f"{name}.weight"]).T.contiguous()}
    if f"{name}.bias" in sd:
        p["b"] = _arr(sd[f"{name}.bias"])
    return p


def _conv1d_linear(sd, name):
    return {"w": _arr(sd[f"{name}.weight"])[:, :, 0].T.contiguous(),
            "b": _arr(sd[f"{name}.bias"])}


def _ln(sd, name):
    return {"gamma": _arr(sd[f"{name}.gamma"]), "beta": _arr(sd[f"{name}.beta"])}


def _trunk_subdict(sd, prefix):
    """``{prefix}.*`` under torchvision's names."""
    out = {}
    for k, v in sd.items():
        if not k.startswith(prefix + "."):
            continue
        idx, _, tail = k[len(prefix) + 1:].partition(".")
        if idx in _TRUNK_SEQ:
            out[_TRUNK_SEQ[idx] + ("." + tail if tail else "")] = v
    return out


def _mha_block(sd, prefix):
    return {
        "slf_attn": {
            "w_qs": _linear(sd, f"{prefix}.slf_attn.w_qs"),
            "w_ks": _linear(sd, f"{prefix}.slf_attn.w_ks"),
            "w_vs": _linear(sd, f"{prefix}.slf_attn.w_vs"),
            "fc": _linear(sd, f"{prefix}.slf_attn.fc"),
            "ln": _ln(sd, f"{prefix}.slf_attn.layer_norm"),
        },
        "pos_ffn": {
            "w_1": _conv1d_linear(sd, f"{prefix}.pos_ffn.w_1"),
            "w_2": _conv1d_linear(sd, f"{prefix}.pos_ffn.w_2"),
            "ln": _ln(sd, f"{prefix}.pos_ffn.layer_norm"),
        },
    }


def _rnn(sd, name, num_layers, dirs):
    return {"layers": [[{
        "w_ih": _arr(sd[f"{name}.weight_ih_l{l}{suf}"]).T.contiguous(),
        "w_hh": _arr(sd[f"{name}.weight_hh_l{l}{suf}"]).T.contiguous(),
        "b_ih": _arr(sd[f"{name}.bias_ih_l{l}{suf}"]),
        "b_hh": _arr(sd[f"{name}.bias_hh_l{l}{suf}"]),
    } for suf in ("", "_reverse")[:dirs]] for l in range(num_layers)]}


def import_reference_state_dict(sd: dict, *, num_layers: int = 2, bidirectional: bool = True,
                                stack_num: int = 2, device="cuda") -> tuple[dict, dict]:
    """(params, batch_stats) in the layout of
    :func:`mgnns_tpu_torch.models.mgnns.mgnns_init`, float32 on ``device``
    (which raises when it is CUDA and no card is present).  ``sd`` maps
    reference names to tensors or numpy arrays."""
    dev = resolve_device(device)
    dirs = 2 if bidirectional else 1
    p: dict = {}
    s: dict = {}
    emb = _arr(sd["embedding.weight"])
    emb[0] = 0.0
    p["embedding"] = {"table": emb}
    p["lstm"] = _rnn(sd, "lstm", num_layers, dirs)
    p["text_gcn"] = {"node_embedding": _arr(sd["text_features.node_hidden.weight"]),
                     "edge_weight": _arr(sd["text_features.seq_edge_w.weight"])}
    for side, depth in (("object", 101), ("place", 50)):
        p[f"{side}_trunk"], s[f"{side}_trunk"] = resnet.import_torch_state_dict(
            _trunk_subdict(sd, f"{side}_features"), depth)
        p[f"liner_img_{side}"] = _linear(sd, f"liner_img_{side}")
        p[f"{side}_attention"] = {k: _linear(sd, f"{side}_attention.{k}")
                                  for k in ("w_q", "w_k", "w_v", "fc")}
        p[f"{side}_linear_5"] = _linear(sd, f"{side}_linear_5")
        p[f"{side}_x_linear"] = _linear(sd, f"{side}_x_linear")
        p[f"{side}_A"] = _arr(sd[f"{side}_A"])
    p["gc1"] = {"w": _arr(sd["gc1.weight"])}
    p["gc2"] = {"w": _arr(sd["gc2.weight"])}
    for torch_name, ours in _MHA_STACKS.items():
        p[ours] = [_mha_block(sd, f"{torch_name}.{i}") for i in range(stack_num)]
    p["multi_linear_1"] = _linear(sd, "multi_linear_1")
    p["multi_linear_2"] = _linear(sd, "multi_linear_2")

    # the dead modules, each when the state_dict holds it whole: a real
    # reference checkpoint carries each one whole or not at all, and a
    # partial one is taken as absent rather than failing the import
    def maybe(name, fn, *args):
        try:
            p[name] = fn(*args)
        except KeyError:
            pass

    if "rnn.weight_ih_l0" in sd:
        maybe("rnn", _rnn, sd, "rnn", num_layers, dirs)
    for side in ("object", "place"):
        if f"{side}_gate.weight" in sd:
            maybe(f"{side}_gate", _linear, sd, f"{side}_gate")
        for i in (1, 2, 3):
            if f"{side}_linear_{i}.weight" in sd:
                maybe(f"{side}_linear_{i}", _linear, sd, f"{side}_linear_{i}")
        if f"text_{side}_text_multi_head_att.slf_attn.w_qs.weight" in sd:
            maybe(f"text_{side}_text_mha", _mha_block, sd, f"text_{side}_text_multi_head_att")
    if "text_features.Linear.weight" in sd:
        maybe("text_head", _linear, sd, "text_features.Linear")
    return tree_to(p, dev), tree_to(s, dev)


# ---------------------------------------------------------------------------
# export


def _out(t: torch.Tensor) -> torch.Tensor:
    """A contiguous CPU copy: the export shares no storage with parameters
    that training goes on updating in place."""
    return t.detach().cpu().clone(memory_format=torch.contiguous_format)


def _exp_linear(out, name, p):
    out[f"{name}.weight"] = _out(p["w"].T)
    if "b" in p:
        out[f"{name}.bias"] = _out(p["b"])


def _exp_conv1d(out, name, p):
    out[f"{name}.weight"] = _out(p["w"].T[:, :, None])
    out[f"{name}.bias"] = _out(p["b"])


def _exp_ln(out, name, p):
    out[f"{name}.gamma"] = _out(p["gamma"])
    out[f"{name}.beta"] = _out(p["beta"])


def _exp_mha_block(out, pre, blk):
    for sub in ("w_qs", "w_ks", "w_vs", "fc"):
        _exp_linear(out, f"{pre}.slf_attn.{sub}", blk["slf_attn"][sub])
    _exp_ln(out, f"{pre}.slf_attn.layer_norm", blk["slf_attn"]["ln"])
    _exp_conv1d(out, f"{pre}.pos_ffn.w_1", blk["pos_ffn"]["w_1"])
    _exp_conv1d(out, f"{pre}.pos_ffn.w_2", blk["pos_ffn"]["w_2"])
    _exp_ln(out, f"{pre}.pos_ffn.layer_norm", blk["pos_ffn"]["ln"])


def _exp_rnn(out, name, params):
    for l, dir_params in enumerate(params["layers"]):
        for d, p in enumerate(dir_params):
            suf = "_reverse" if d == 1 else ""
            out[f"{name}.weight_ih_l{l}{suf}"] = _out(p["w_ih"].T)
            out[f"{name}.weight_hh_l{l}{suf}"] = _out(p["w_hh"].T)
            out[f"{name}.bias_ih_l{l}{suf}"] = _out(p["b_ih"])
            out[f"{name}.bias_hh_l{l}{suf}"] = _out(p["b_hh"])


def _exp_trunk(out, prefix, params, stats):
    seq = {v: k for k, v in _TRUNK_SEQ.items()}

    def bn(name, p, s):
        out[f"{prefix}.{name}.weight"] = _out(p["scale"])
        out[f"{prefix}.{name}.bias"] = _out(p["bias"])
        out[f"{prefix}.{name}.running_mean"] = _out(s["mean"])
        out[f"{prefix}.{name}.running_var"] = _out(s["var"])

    out[f"{prefix}.{seq['conv1']}.weight"] = _out(params["conv1"])
    bn(seq["bn1"], params["bn1"], stats["bn1"])
    for li in range(1, 5):
        for b, (pb, sb) in enumerate(zip(params[f"layer{li}"], stats[f"layer{li}"])):
            pre = f"{seq[f'layer{li}']}.{b}"
            for ci in (1, 2, 3):
                out[f"{prefix}.{pre}.conv{ci}.weight"] = _out(pb[f"conv{ci}"])
                bn(f"{pre}.bn{ci}", pb[f"bn{ci}"], sb[f"bn{ci}"])
            if "downsample_conv" in pb:
                out[f"{prefix}.{pre}.downsample.0.weight"] = _out(pb["downsample_conv"])
                bn(f"{pre}.downsample.1", pb["downsample_bn"], sb["downsample_bn"])


def export_reference_state_dict(params: dict, batch_stats: dict) -> dict:
    """The port's trees -> a reference-named ``state_dict`` of contiguous
    CPU tensors (``torch.save`` it inside the reference's
    ``{"epoch", "arch", "best_score", "state_dict"}`` wrapper)."""
    out: dict = {"embedding.weight": _out(params["embedding"]["table"])}
    _exp_rnn(out, "lstm", params["lstm"])
    out["text_features.node_hidden.weight"] = _out(params["text_gcn"]["node_embedding"])
    out["text_features.seq_edge_w.weight"] = _out(params["text_gcn"]["edge_weight"])
    for side in ("object", "place"):
        _exp_trunk(out, f"{side}_features", params[f"{side}_trunk"], batch_stats[f"{side}_trunk"])
        _exp_linear(out, f"liner_img_{side}", params[f"liner_img_{side}"])
        for sub in ("w_q", "w_k", "w_v", "fc"):
            _exp_linear(out, f"{side}_attention.{sub}", params[f"{side}_attention"][sub])
        _exp_linear(out, f"{side}_linear_5", params[f"{side}_linear_5"])
        _exp_linear(out, f"{side}_x_linear", params[f"{side}_x_linear"])
        out[f"{side}_A"] = _out(params[f"{side}_A"])
    out["gc1.weight"] = _out(params["gc1"]["w"])
    out["gc2.weight"] = _out(params["gc2"]["w"])
    for torch_name, ours in _MHA_STACKS.items():
        for i, blk in enumerate(params[ours]):
            _exp_mha_block(out, f"{torch_name}.{i}", blk)
    _exp_linear(out, "multi_linear_1", params["multi_linear_1"])
    _exp_linear(out, "multi_linear_2", params["multi_linear_2"])

    # the dead modules, when the params carry them
    if "rnn" in params:
        _exp_rnn(out, "rnn", params["rnn"])
    for side in ("object", "place"):
        if f"{side}_gate" in params:
            _exp_linear(out, f"{side}_gate", params[f"{side}_gate"])
        for i in (1, 2, 3):
            if f"{side}_linear_{i}" in params:
                _exp_linear(out, f"{side}_linear_{i}", params[f"{side}_linear_{i}"])
        if f"text_{side}_text_mha" in params:
            _exp_mha_block(out, f"text_{side}_text_multi_head_att", params[f"text_{side}_text_mha"])
    if "text_head" in params:
        _exp_linear(out, "text_features.Linear", params["text_head"])
    return out
