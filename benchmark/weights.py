"""Weights made by the benchmark on the card from the run's seed.

Every leaf is drawn in one of three large calls (all normal leaves at once,
all uniform leaves at once, the fills), in the parameter layout that the
program's ``Engine`` and ``Predictor`` take and the reference reads.  The
scales are those of trained models, not of a fresh init, so that no softmax
saturates: GloVe-like word vectors (standard deviation 0.35), Kaiming
normal convolutions, PyTorch's uniform linear layers, and for the
text-only model a head small enough to leave its probabilities open.  For
an eval-mode forward the trunks' running statistics are calibrated on a
batch of the cell's own images by the reference's train-mode trunk.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference import model as R

EMB_STD = 0.35
TEXT_HEAD_STD = 0.0025


class _Leaf:
    __slots__ = ("shape", "scale", "value")

    def __init__(self, shape, scale):
        self.shape, self.scale, self.value = tuple(shape), scale, None


class _Spec:
    """Leaves to draw: ``n`` normal (scale: standard deviation), ``u``
    uniform (scale: bound), ``f`` filled (scale: value); ``draw`` fills them."""

    def __init__(self):
        self.normal, self.uniform, self.fill = [], [], []

    def n(self, shape, std):
        self.normal.append(_Leaf(shape, std))
        return self.normal[-1]

    def u(self, shape, bound):
        self.uniform.append(_Leaf(shape, bound))
        return self.uniform[-1]

    def f(self, shape, value):
        self.fill.append(_Leaf(shape, value))
        return self.fill[-1]

    def draw(self, g: torch.Generator, device) -> None:
        for group, normal in ((self.normal, True), (self.uniform, False)):
            sizes = [math.prod(leaf.shape) for leaf in group]
            flat = (torch.randn if normal else torch.rand)(sum(sizes), generator=g, device=device)
            for leaf, part in zip(group, flat.split(sizes)):
                part = part * leaf.scale if normal else part * (2 * leaf.scale) - leaf.scale
                leaf.value = part.view(leaf.shape)
        for value in {leaf.scale for leaf in self.fill}:
            group = [leaf for leaf in self.fill if leaf.scale == value]
            sizes = [math.prod(leaf.shape) for leaf in group]
            flat = torch.full((sum(sizes),), float(value), device=device)
            for leaf, part in zip(group, flat.split(sizes)):
                leaf.value = part.view(leaf.shape)


def _resolve(tree):
    if isinstance(tree, dict):
        return {k: _resolve(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_resolve(v) for v in tree]
    return tree.value


def _linear(s: _Spec, i: int, o: int, w=None) -> dict:
    return {"w": w if w is not None else s.u((i, o), 1 / math.sqrt(i)),
            "b": s.u((o,), 1 / math.sqrt(i))}


def _trunk(s: _Spec, depth: int):
    def conv(k, cin, cout):
        return s.n((cout, cin, k, k), math.sqrt(2.0 / (k * k * cout)))

    def bn(c):
        return {"scale": s.f((c,), 1.0), "bias": s.f((c,), 0.0)}, \
               {"mean": s.f((c,), 0.0), "var": s.f((c,), 1.0)}

    p, st = {"conv1": conv(7, 3, 64)}, {}
    p["bn1"], st["bn1"] = bn(64)
    cin = 64
    for li, (blocks, width) in enumerate(zip(R.RESNET_LAYERS[depth], (64, 128, 256, 512)), 1):
        p[f"layer{li}"], st[f"layer{li}"] = [], []
        for b in range(blocks):
            stride = 2 if (li > 1 and b == 0) else 1
            cout = width * 4
            pb, sb = {}, {}
            pb["conv1"] = conv(1, cin, width)
            pb["bn1"], sb["bn1"] = bn(width)
            pb["conv2"] = conv(3, width, width)
            pb["bn2"], sb["bn2"] = bn(width)
            pb["conv3"] = conv(1, width, cout)
            pb["bn3"], sb["bn3"] = bn(cout)
            if stride != 1 or cin != cout:
                pb["downsample_conv"] = conv(1, cin, cout)
                pb["downsample_bn"], sb["downsample_bn"] = bn(cout)
            p[f"layer{li}"].append(pb)
            st[f"layer{li}"].append(sb)
            cin = cout
    return p, st


def _mha(s: _Spec, d: int, n_head: int, d_kv: int) -> dict:
    hd = n_head * d_kv
    ln = lambda: {"gamma": s.f((d,), 1.0), "beta": s.f((d,), 0.0)}  # noqa: E731
    return {"slf_attn": {
        "w_qs": _linear(s, d, hd, s.n((d, hd), math.sqrt(2.0 / (d + d_kv)))),
        "w_ks": _linear(s, d, hd, s.n((d, hd), math.sqrt(2.0 / (d + d_kv)))),
        "w_vs": _linear(s, d, hd, s.n((d, hd), math.sqrt(2.0 / (d + d_kv)))),
        "fc": _linear(s, hd, d, s.n((hd, d), math.sqrt(2.0 / (hd + d)))),
        "ln": ln()},
        "pos_ffn": {"w_1": _linear(s, d, d), "w_2": _linear(s, d, d), "ln": ln()}}


def _text_gcn(s: _Spec, V: int, D: int, E: int) -> dict:
    return {"node_embedding": s.n((V, D), EMB_STD), "edge_weight": s.f((E, 1), 1.0)}


def fusion_weights(cfg: dict, num_edges: int, consts_np: dict, seed: int, device):
    """(params, batch_stats, consts) of the fusion model, ``consts_np``
    holding the label graphs ``object_A``/``place_A`` and the constants
    ``label_query``/``object_inp``/``place_inp`` as numpy arrays."""
    s = _Spec()
    V, D, H = cfg["vocab_size"], cfg["emb_size"], cfg["hidden_size"]
    d = 2 * H
    p: dict = {"text_gcn": _text_gcn(s, V, D, num_edges),
               "embedding": {"table": s.n((V, D), EMB_STD)},
               "lstm": {"layers": [[{
                   "w_ih": s.u((D if l == 0 else d, 4 * H), 1 / math.sqrt(H)),
                   "w_hh": s.u((H, 4 * H), 1 / math.sqrt(H)),
                   "b_ih": s.u((4 * H,), 1 / math.sqrt(H)),
                   "b_hh": s.u((4 * H,), 1 / math.sqrt(H))} for _ in range(2)]
                   for l in range(cfg["num_layers"])]}}
    st: dict = {}
    for side, depth in (("object", cfg["trunks"]["object"]), ("place", cfg["trunks"]["place"])):
        p[f"{side}_trunk"], st[f"{side}_trunk"] = _trunk(s, depth)
    C = {"object": cfg["object_num_classes"], "place": cfg["place_num_classes"]}
    p["liner_img_object"] = _linear(s, 2048, d)
    p["liner_img_place"] = _linear(s, 2048, d)
    p["gc1"] = {"w": s.u((cfg["in_channel"], cfg["gcn_hidden"]), 1 / math.sqrt(cfg["gcn_hidden"]))}
    p["gc2"] = {"w": s.u((cfg["gcn_hidden"], cfg["gcn_out"]), 1 / math.sqrt(cfg["gcn_out"]))}
    for side in ("object", "place"):
        p[f"{side}_attention"] = {"w_q": _linear(s, 300, 300), "w_k": _linear(s, C[side], 300),
                                  "w_v": _linear(s, C[side], 300), "fc": _linear(s, 300, 300)}
    nl = cfg["num_labels"]
    p["object_linear_5"] = _linear(s, 300, 100)
    p["object_x_linear"] = _linear(s, nl * 100, 300)
    p["place_linear_5"] = _linear(s, 300, 100)
    p["place_x_linear"] = _linear(s, nl * 100, 300)
    for name in ("img_object_text_mha", "img_place_text_mha", "text_img_object_mha",
                 "text_img_place_mha"):
        p[name] = [_mha(s, d, cfg["n_head"], cfg["d_kv"]) for _ in range(cfg["stack_num"])]
    p["multi_linear_1"] = _linear(s, 4 * d, d)
    p["multi_linear_2"] = _linear(s, d, nl)
    g = torch.Generator(device=device).manual_seed(seed)
    s.draw(g, device)
    params, stats = _resolve(p), _resolve(st)
    with torch.no_grad():
        params["embedding"]["table"][0] = 0.0
    for side in ("object", "place"):
        params[f"{side}_A"] = torch.as_tensor(consts_np[f"{side}_A"], device=device)
    consts = {k: torch.as_tensor(consts_np[k], device=device)
              for k in ("label_query", "object_inp", "place_inp")}
    return params, stats, consts


def text_weights(cfg: dict, num_edges: int, seed: int, device) -> dict:
    """The text-only model's parameters: the text GCN and its head."""
    s = _Spec()
    p = {"text_gcn": _text_gcn(s, cfg["vocab_size"], cfg["emb_size"], num_edges),
         "head": {"w": s.n((cfg["emb_size"], cfg["num_labels"]), TEXT_HEAD_STD),
                  "b": s.u((cfg["num_labels"],), 1 / math.sqrt(cfg["emb_size"]))}}
    s.draw(torch.Generator(device=device).manual_seed(seed), device)
    return _resolve(p)


def calibrate(params: dict, stats: dict, image_u8: torch.Tensor, dtype) -> None:
    """Set every trunk's running statistics to those of a train-mode
    forward of the reference trunk over ``image_u8`` ([B, H, W, 3] uint8),
    layer by layer, so that an eval-mode forward sees what a trained
    model's statistics would give it."""
    with torch.no_grad():
        image = R.normalize(image_u8, dtype)
        for side in ("object", "place"):
            trunk_s = stats[f"{side}_trunk"]
            _, new = R.resnet(params[f"{side}_trunk"], trunk_s, image, True, dtype)
            # one move of momentum 0.1 from mean 0 and variance 1: undone,
            # it leaves the batch's own mean and unbiased variance
            for path, old, nw in zip(R.paths(trunk_s), R.leaves(trunk_s), R.leaves(new)):
                old.copy_(nw / 0.1 if path.endswith("mean") else (nw - 0.9) / 0.1)
