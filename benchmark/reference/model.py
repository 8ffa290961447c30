"""The plain reference of the two models and of one training step.

Plain PyTorch, written from the reference model's definition (Yang et al.,
ACL 2021, ``models/Multi_GCN_Multihead_att.py``, ``models/Text_GCN.py``,
``models/submodules.py``, ``models/moudles.py``) in the parameter layout
the port takes (a linear weight is ``[in, out]``, a trunk is torchvision's
ResNet with its running statistics in a tree of their own).  It imports
nothing of the program: it is the yardstick the program's outputs are held
to, and it stays as it is when the program changes.

- The text GCN's windowed edge-weighted max is the loop over window slots,
  differentiated by autograd; the readout is the sum over unique words of
  the max over their positions.
- The BiLSTM is a step loop holding the carry at padded steps.
- Dropout follows the seed scheme the program states: the mask of the call
  site reached by the path ``((count, name), ...)`` from a step's root seed
  is ``torch.rand(shape) < 1 - rate`` from a generator seeded with
  ``blake2b`` over the path (:func:`derive_seed`), so that a training step
  can be followed mask for mask.
- ``conv_dtype`` is the trunks' precision; ``quantize`` (the control) rounds
  every conv operand to float8 e4m3 with a per-tensor scale first.
"""

from __future__ import annotations

import hashlib
import math

import torch
import torch.nn.functional as F

RESNET_LAYERS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}
_IMAGE_MEAN = (0.485, 0.456, 0.406)
_IMAGE_STD = (0.229, 0.224, 0.225)
FP8_MAX = 448.0


def derive_seed(seed: int, *parts) -> int:
    key = "/".join(str(p) for p in (seed, *parts)).encode()
    return int.from_bytes(hashlib.blake2b(key, digest_size=8).digest(), "little") >> 1


class Rng:
    """The dropout seed of one call site; ``next(name)`` the next site below it."""

    def __init__(self, seed: int | None):
        self.seed, self.count = seed, 0

    def next(self, name: str) -> "Rng":
        if self.seed is None:
            return self
        self.count += 1
        return Rng(derive_seed(self.seed, self.count, name))


def dropout(x: torch.Tensor, rate: float, rng: Rng) -> torch.Tensor:
    if rng.seed is None or rate <= 0.0:
        return x
    g = torch.Generator(device=x.device).manual_seed(rng.seed)
    u = torch.rand(x.shape, generator=g, device=x.device)
    return torch.where(u < 1.0 - rate, x / (1.0 - rate), 0.0)


def linear(p: dict, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"]
    return y + p["b"] if "b" in p else y


def layer_norm(p: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """``gamma * (x - mean) / (unbiased std + eps) + beta`` (``submodules.py:153-156``)."""
    mean = x.mean(-1, keepdim=True)
    std = x.std(-1, keepdim=True, unbiased=True)
    return p["gamma"] * (x - mean) / (std + eps) + p["beta"]


# ------------------------------------------------------------------ text GCN


def window_max(emb: torch.Tensor, w: torch.Tensor, lens: torch.Tensor, ngram: int):
    """[B, L, D]: at each valid position the max over its window of the
    neighbour's embedding times the edge weight; -inf elsewhere."""
    B, L, D = emb.shape
    pos = torch.arange(L, device=emb.device)
    valid_j = pos[None, :] < lens[:, None]
    m = torch.full((B, L, D), float("-inf"), device=emb.device)
    for k, o in enumerate(range(-ngram, ngram + 1)):
        src = emb[:, torch.clamp(pos + o, 0, L - 1), :]
        ok = (pos + o >= 0) & (pos + o < lens[:, None]) & valid_j
        m = torch.maximum(m, torch.where(ok[:, :, None], src * w[:, :, k:k + 1], float("-inf")))
    return m


def unique_word_sum(m: torch.Tensor, ids: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """[B, D]: the sum over a document's distinct words of the max of ``m``
    over the word's positions."""
    B, L, D = m.shape
    pos = torch.arange(L, device=ids.device)
    valid = pos[None, :] < lens[:, None]
    # first position of each position's word: argmax of the first equal id
    same = (ids[:, :, None] == ids[:, None, :]) & valid[:, None, :] & valid[:, :, None]
    first = same.float().argmax(dim=2)
    slot = torch.where(valid, first, L)
    out = torch.full((B, L + 1, D), float("-inf"), device=m.device)
    out = out.scatter_reduce(1, slot[:, :, None].expand(B, L, D), m, reduce="amax",
                             include_self=True)[:, :L]
    return torch.where(torch.isfinite(out), out, 0.0).sum(dim=1)


def text_gcn(p: dict, ids, lens, eids, ngram: int, rate: float, rng: Rng) -> torch.Tensor:
    emb = p["node_embedding"][ids.long()]
    w = p["edge_weight"][:, 0][eids.long()]
    h = unique_word_sum(window_max(emb, w, lens, ngram), ids, lens)
    return torch.relu(dropout(h, rate, rng))


# ------------------------------------------------------------------ BiLSTM


def lstm(p: dict, x: torch.Tensor, lens: torch.Tensor, rate: float, rng: Rng) -> torch.Tensor:
    """[B, L, 2H]: two layers, both directions, carry held at padded steps,
    outputs zero there; dropout between the layers."""
    rngs = Rng(rng.seed)
    B, L, _ = x.shape
    valid = (torch.arange(L, device=x.device)[:, None] < lens[None, :])[:, :, None]
    out = x
    layers = p["layers"]
    for li, dirs in enumerate(layers):
        feats = []
        for d, q in enumerate(dirs):
            xw = out @ q["w_ih"] + q["b_ih"]
            H = q["w_hh"].shape[0]
            h = out.new_zeros(B, H)
            c = out.new_zeros(B, H)
            outs = [None] * L
            for t in (range(L - 1, -1, -1) if d == 1 else range(L)):
                i, f, g, o = (xw[:, t] + h @ q["w_hh"] + q["b_hh"]).chunk(4, dim=1)
                c2 = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
                h2 = torch.sigmoid(o) * torch.tanh(c2)
                h = torch.where(valid[t], h2, h)
                c = torch.where(valid[t], c2, c)
                outs[t] = torch.where(valid[t], h, 0.0)
            feats.append(torch.stack(outs, dim=1))
        out = torch.cat(feats, dim=-1)
        if li < len(layers) - 1:
            out = dropout(out, rate, rngs.next(f"lstm_l{li}"))
    return out


# ------------------------------------------------------------------ trunks


def _fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under a per-tensor scale, back in its dtype."""
    scale = t.detach().abs().amax().float().clamp(min=1e-12) / FP8_MAX
    q = (t.float() / scale).to(torch.float8_e4m3fn).float() * scale
    return t + (q.to(t.dtype) - t).detach()


def conv(x, w, dtype, stride=1, padding=0, quantize=False):
    x, w = x.to(dtype), w.to(dtype)
    if quantize:
        x, w = _fp8(x), _fp8(w)
    return F.conv2d(x, w, stride=stride, padding=padding)


def bn(p: dict, s: dict, x: torch.Tensor, train: bool, momentum: float = 0.1,
       eps: float = 1e-5) -> tuple[torch.Tensor, dict]:
    """``nn.BatchNorm2d``: train mode normalizes by the batch's biased
    variance and moves the running statistics towards the batch mean and
    unbiased variance; the statistics are float32."""
    if not train:
        return F.batch_norm(x, s["mean"], s["var"], p["scale"], p["bias"], False, 0.0, eps), s
    y = F.batch_norm(x, None, None, p["scale"], p["bias"], True, 0.0, eps)
    with torch.no_grad():
        var, mean = torch.var_mean(x.float(), dim=(0, 2, 3), unbiased=False)
        n = x.numel() // x.shape[1]
        new = {"mean": (1 - momentum) * s["mean"] + momentum * mean,
               "var": (1 - momentum) * s["var"] + momentum * var * n / max(n - 1, 1)}
    return y, new


def resnet(p: dict, s: dict, image: torch.Tensor, train: bool, dtype, quantize=False):
    """[B, H, W, 3] normalized -> ([B, H/32, W/32, 2048], new statistics)."""
    ns: dict = {}
    x = image.permute(0, 3, 1, 2)
    x, ns["bn1"] = bn(p["bn1"], s["bn1"], conv(x, p["conv1"], dtype, 2, 3, quantize), train)
    x = F.max_pool2d(F.relu(x), 3, 2, 1)
    for li in range(1, 5):
        ns[f"layer{li}"] = []
        for b, (pb, sb) in enumerate(zip(p[f"layer{li}"], s[f"layer{li}"])):
            stride = 2 if (li > 1 and b == 0) else 1
            nb = {}
            y, nb["bn1"] = bn(pb["bn1"], sb["bn1"], conv(x, pb["conv1"], dtype, 1, 0, quantize),
                              train)
            y, nb["bn2"] = bn(pb["bn2"], sb["bn2"],
                              conv(F.relu(y), pb["conv2"], dtype, stride, 1, quantize), train)
            y, nb["bn3"] = bn(pb["bn3"], sb["bn3"], conv(F.relu(y), pb["conv3"], dtype, 1, 0,
                                                        quantize), train)
            if "downsample_conv" in pb:
                idn, nb["downsample_bn"] = bn(pb["downsample_bn"], sb["downsample_bn"],
                                              conv(x, pb["downsample_conv"], dtype, stride, 0,
                                                   quantize), train)
            else:
                idn = x
            x = F.relu(y + idn)
            ns[f"layer{li}"].append(nb)
    return x.permute(0, 2, 3, 1), ns


def normalize(image: torch.Tensor, dtype) -> torch.Tensor:
    """ImageNet normalization of uint8 pixels in ``dtype``."""
    mean = torch.tensor(_IMAGE_MEAN, device=image.device)
    std = torch.tensor(_IMAGE_STD, device=image.device)
    scale, bias = (1.0 / (255.0 * std)), (-mean / std)
    return image.to(dtype) * scale.to(dtype) + bias.to(dtype)


# ------------------------------------------------------------------ attention


def mha(p: dict, q, k, mask, n_head: int, d_kv: int, rate: float, rng: Rng):
    """One cross-attention block with a single query: [B, d] over [B, L, d]."""
    rngs = Rng(rng.seed)
    a = p["slf_attn"]
    arng = rngs.next("mha")
    arngs = Rng(arng.seed)
    B, Lk, _ = k.shape
    q1 = q[:, None, :]
    qh = linear(a["w_qs"], q1).reshape(B, 1, n_head, d_kv)
    kh = linear(a["w_ks"], k).reshape(B, Lk, n_head, d_kv)
    vh = linear(a["w_vs"], k).reshape(B, Lk, n_head, d_kv)
    att = torch.einsum("bqhd,bkhd->bhqk", qh, kh) / math.sqrt(d_kv)
    if mask is not None:
        att = att.masked_fill(mask[:, None, None, :] == 0.0, float("-inf"))
    att = dropout(torch.softmax(att, dim=-1), rate, arngs.next("attn"))
    out = torch.einsum("bhqk,bkhd->bqhd", att, vh).reshape(B, 1, n_head * d_kv)
    out = dropout(linear(a["fc"], out), rate, arngs.next("proj"))
    out = layer_norm(a["ln"], out + q1)
    f = p["pos_ffn"]
    h = dropout(linear(f["w_2"], torch.relu(linear(f["w_1"], out))), rate, rngs.next("ffn"))
    return layer_norm(f["ln"], h + out)[:, 0, :]


def label_attention(p: dict, query, x, n_heads: int, rate: float, rng: Rng):
    """Per-head element-wise query-key energies, softmax over each head's
    features (``Multi_GCN_Multihead_att.py:65-133``): [B, labels, 300]."""
    hid, n = query.shape[-1], query.shape[0]
    dh = hid // n_heads
    Q = linear(p["w_q"], query).reshape(n, n_heads, dh)
    K = linear(p["w_k"], x).reshape(-1, n_heads, dh)
    V = linear(p["w_v"], x).reshape(-1, n_heads, dh)
    energy = Q[None] * K[:, None] / float(torch.tensor(dh, dtype=torch.float32).sqrt())
    att = dropout(torch.softmax(energy, dim=-1), rate, rng)
    return linear(p["fc"], (att * V[:, None]).reshape(x.shape[0], n, hid))


def norm_adj(A: torch.Tensor) -> torch.Tensor:
    D = torch.pow(A.sum(dim=1), -0.5)
    return (A * D[None, :]).T * D[None, :]


# ------------------------------------------------------------------ models


def fusion_forward(params: dict, stats: dict, consts: dict, batch: dict, cfg: dict, *,
                   train: bool = False, seed: int | None = None, dtype=torch.float32,
                   quantize: bool = False) -> tuple[torch.Tensor, dict]:
    """(logits [B, labels], new trunk statistics) of the fusion model.
    ``seed``: the step's dropout root seed (train mode)."""
    rngs = Rng(seed if train else None)
    rate = cfg["dropout"]
    ngram = (batch["eids"].shape[-1] - 1) // 2
    text = text_gcn(params["text_gcn"], batch["ids"], batch["lens"], batch["eids"], ngram,
                    cfg["text_dropout"], rngs.next("text_gcn"))
    emb = params["embedding"]["table"][batch["ids"].long()]
    bank = lstm(params["lstm"], emb, batch["lens"], rate, rngs.next("lstm"))
    image = normalize(batch["image"], dtype)
    new_stats, vec, img_bank = {}, {}, {}
    for side in ("object", "place"):
        feats, new_stats[f"{side}_trunk"] = resnet(
            params[f"{side}_trunk"], stats[f"{side}_trunk"], image,
            train and cfg.get("bn_mode", "batch") == "batch", dtype, quantize)
        feats = feats.float()
        B, H, W, C = feats.shape
        img_bank[side] = linear(params[f"liner_img_{side}"], feats.reshape(B, H * W, C))
        adj = norm_adj(params[f"{side}_A"].detach())
        x = adj @ (consts[f"{side}_inp"] @ params["gc1"]["w"])
        x = torch.where(x >= 0, x, 0.2 * x)
        x = adj @ (x @ params["gc2"]["w"])
        x = feats.amax(dim=(1, 2)) @ x.T
        att = label_attention(params[f"{side}_attention"], consts["label_query"], x,
                              cfg["n_label_heads"], rate, rngs.next(f"{side}_label_attn"))
        att = linear(params[f"{side}_linear_5"], att).reshape(B, -1)
        vec[side] = linear(params[f"{side}_x_linear"], att)

    def stack(name, q, kv, mask, tag):
        for i, blk in enumerate(params[name]):
            q = mha(blk, q, kv, mask, cfg["n_head"], cfg["d_kv"], rate, rngs.next(f"{tag}{i}"))
        return q

    iot = stack("img_object_text_mha", vec["object"], bank, batch["mask"], "iot")
    ipt = stack("img_place_text_mha", vec["place"], bank, batch["mask"], "ipt")
    tio = stack("text_img_object_mha", text, img_bank["object"], None, "tio")
    tip = stack("text_img_place_mha", text, img_bank["place"], None, "tip")
    multi = linear(params["multi_linear_1"], torch.cat([tio, tip, iot, ipt], dim=1))
    multi = dropout(multi, rate, rngs.next("classifier"))
    return linear(params["multi_linear_2"], multi), new_stats


def text_forward(params: dict, batch: dict, *, train: bool = False, seed: int | None = None,
                 rate: float = 0.5) -> torch.Tensor:
    """Logits of the text-only model: text GCN, then a linear head."""
    rngs = Rng(seed if train else None)
    ngram = (batch["eids"].shape[-1] - 1) // 2
    h = text_gcn(params["text_gcn"], batch["ids"], batch["lens"], batch["eids"], ngram, rate,
                 rngs.next("text_gcn"))
    return linear(params["head"], h)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, weight: torch.Tensor):
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = logp.gather(1, labels.long()[:, None])[:, 0]
    return -(ll * weight).sum() / torch.clamp(weight.sum(), min=1.0)


# ------------------------------------------------------------------ training


def paths(tree, prefix: str = "") -> list[str]:
    if isinstance(tree, dict):
        return [q for k, v in tree.items() for q in paths(v, f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [q for i, v in enumerate(tree) for q in paths(v, f"{prefix}/{i}")]
    return [prefix]


def leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def unflatten(like, flat):
    it = iter(flat)

    def go(t):
        if isinstance(t, dict):
            return {k: go(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(go(v) for v in t)
        return next(it)

    return go(like)


# the reference's parameter groups (``get_config_optim``): learning-rate factors
GROUP_FACTORS = {"text_gcn": 10.0, "lstm": 10.0, "object_trunk": "lrp", "place_trunk": "lrp",
                 "object_A": 0.0, "place_A": 0.0}


class Adam:
    """``torch.optim.Adam(lr, weight_decay)`` over the reference's groups,
    after clipping every gradient by their global norm: per leaf
    ``g = clip(g) + wd * p``, moments (0.9, 0.999, eps 1e-8) with bias
    correction, then ``p -= lr * factor * m_hat / (sqrt(v_hat) + eps)``."""

    def __init__(self, params: dict, opt: dict):
        self.opt = opt
        self.names = paths(params)
        self.factors = []
        for name in self.names:
            f = GROUP_FACTORS.get(name.split("/")[1], 1.0)
            self.factors.append(opt["lrp"] if f == "lrp" else f)
        self.mu = [torch.zeros_like(p) for p in leaves(params)]
        self.nu = [torch.zeros_like(p) for p in leaves(params)]
        self.count = 0

    def step(self, params: list[torch.Tensor], grads: list) -> list[torch.Tensor | None]:
        """Update ``params`` in place; returns the gradient each trained leaf
        got after the clip and the weight decay (None for a frozen leaf)."""
        o = self.opt
        norm = torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(g) for g in grads if g is not None]))
        scale = torch.where(norm < o["grad_clip"], torch.ones_like(norm), o["grad_clip"] / norm)
        self.count += 1
        c = torch.tensor(float(self.count))
        bc1 = 1 - torch.tensor(0.9) ** c
        bc2 = 1 - torch.tensor(0.999) ** c
        got = []
        for i, (p, g) in enumerate(zip(params, grads)):
            if self.factors[i] == 0.0:
                got.append(None)
                continue
            g = (torch.zeros_like(p) if g is None else g * scale) + o["weight_decay"] * p
            self.mu[i] = 0.9 * self.mu[i] + 0.1 * g
            self.nu[i] = 0.999 * self.nu[i] + 0.001 * g * g
            upd = (self.mu[i] / bc1.to(p.device)) / (torch.sqrt(self.nu[i] / bc2.to(p.device))
                                                     + 1e-8)
            p.sub_(o["lr"] * self.factors[i] * upd)
            got.append(g)
        return got


def fusion_train_step(params: dict, stats: dict, consts: dict, batch: dict, cfg: dict,
                      adam: Adam, seed: int, dtype, quantize: bool = False):
    """One step of the fusion model in place of ``params`` and ``stats``:
    (loss, the gradients as the optimizer got them, in leaf order)."""
    flat = [p.detach().requires_grad_(p.is_floating_point()) for p in leaves(params)]
    logits, new_stats = fusion_forward(unflatten(params, flat), stats, consts, batch, cfg,
                                       train=True, seed=seed, dtype=dtype, quantize=quantize)
    loss = cross_entropy(logits, batch["label"], batch["weight"])
    want = [i for i, name in enumerate(adam.names) if adam.factors[i] != 0.0]
    grads: list = [None] * len(flat)
    for i, g in zip(want, torch.autograd.grad(loss, [flat[i] for i in want], allow_unused=True)):
        grads[i] = g
    with torch.no_grad():
        got = adam.step([p for p in leaves(params)], grads)
        for old, new in zip(leaves(stats), leaves(new_stats)):
            old.copy_(new)
    return float(loss.detach()), got


class precision:
    """``with precision(tf32)``: float32 products and convolutions in TF32
    (the control of a float32 cell) or in IEEE float32 (the reference),
    the caller's settings restored after."""

    def __init__(self, tf32: bool):
        self.mode = "tf32" if tf32 else "ieee"

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.fp32_precision,
                      torch.backends.cudnn.conv.fp32_precision)
        torch.backends.cuda.matmul.fp32_precision = self.mode
        torch.backends.cudnn.conv.fp32_precision = self.mode
        return self

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.fp32_precision,
         torch.backends.cudnn.conv.fp32_precision) = self.saved
        return False
