"""The plain reference of the fusion model with a ``deepseek_v3`` text
encoder (Moonlight-16B-A3B's block) in place of the embedding and the
BiLSTM, and of one training step of it.

Plain PyTorch, written from the published ``deepseek_v3`` modelling code
(https://huggingface.co/moonshotai/Moonlight-16B-A3B, ``config.json`` and
``modeling_deepseek.py``) in the parameter layout the program takes (a
linear weight is ``[in, out]``; an MLP's gate and up projections side by
side in ``w13``; the held experts' leaves stacked).  It imports nothing of
the program: the fusion model around the encoder is
:mod:`benchmark.reference.model`'s.

- Layer ``i``: ``h = x + MLA(RMSNorm(x))``, then ``h + MLP(RMSNorm(h))``
  below ``first_dense``, else ``h + shared(n) + sum over the chosen experts
  that this chip holds of w_e * expert_e(n)``, ``n = RMSNorm(h)``.
- MLA without a query low rank; RoPE on the ``nope``-less part of the query
  and on the one key part all heads share, in the ``deepseek_v3`` layout
  (pairs ``(x[2i], x[2i+1])`` gathered into halves, then ``rotate_half``);
  causal attention scaled by ``1/sqrt(nope + rope)``.
- Routing in float32: ``sigmoid`` scores, the top ``k`` of scores plus
  ``e_score_correction_bias`` (one group), weights the scores without the
  bias, normalised and scaled by ``routed_scaling_factor``.
- The chip's share: the routed experts are a loop over the held experts,
  each over the tokens that chose it (a boolean mask); the absent experts'
  part is left out, as on the chip.  ``held`` may also name every expert:
  the uncut layer.
- Products in ``dtype`` with float32 accumulation, as the configuration
  states; the residual stream, norms, softmax, router and combine float32.
  ``quantize`` (the control) rounds every product's operands to float8
  e4m3 with a per-tensor scale first, the encoder's and the trunks'.
- No dropout in the encoder; the fusion's dropout sites follow
  :mod:`benchmark.reference.model`'s seed scheme, without the BiLSTM's.

Departures from the published model, as the configuration states: no LM
head (a classifier), a slice of the vocabulary, a 2048 -> 300 projection
after the final norm into the fusion's memory bank, every position of a row
computed (padded positions are masked by the fusion's key mask).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from benchmark.reference import model as R


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    x = x.float()
    return w * (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps))


def mm(x: torch.Tensor, w: torch.Tensor, dtype, quantize: bool = False) -> torch.Tensor:
    x, w = x.to(dtype), w.to(dtype)
    if quantize:
        x, w = R._fp8(x), R._fp8(w)
    return x @ w


def mlp(p: dict, x: torch.Tensor, dtype, quantize: bool = False) -> torch.Tensor:
    h = mm(x, p["w13"], dtype, quantize)
    gate, up = h.chunk(2, dim=-1)
    return mm(F.silu(gate) * up, p["w2"], dtype, quantize)


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """``x [B, L, heads, dim]`` at positions 0..L-1."""
    B, L, Hh, d = x.shape
    inv = 1.0 / theta ** (torch.arange(0, d, 2, device=x.device, dtype=torch.float32) / d)
    freqs = torch.arange(L, device=x.device, dtype=torch.float32)[:, None] * inv[None, :]
    emb = torch.cat([freqs, freqs], dim=-1)
    cos, sin = emb.cos()[None, :, None, :], emb.sin()[None, :, None, :]
    x = x.float().reshape(B, L, Hh, d // 2, 2).transpose(3, 4).reshape(B, L, Hh, d)
    rotated = torch.cat([-x[..., d // 2:], x[..., :d // 2]], dim=-1)
    return x * cos + rotated * sin


def mla(p: dict, x: torch.Tensor, enc: dict, dtype, quantize: bool = False) -> torch.Tensor:
    B, L, _ = x.shape
    H = enc["num_attention_heads"]
    dn, dr, dv = enc["qk_nope_head_dim"], enc["qk_rope_head_dim"], enc["v_head_dim"]
    q = mm(x, p["q"], dtype, quantize).reshape(B, L, H, dn + dr)
    kv_a = mm(x, p["kv_a"], dtype, quantize)
    c, k_pe = kv_a[..., :enc["kv_lora_rank"]], kv_a[..., enc["kv_lora_rank"]:]
    kv = mm(rms_norm(c, p["kv_norm"], enc["rms_norm_eps"]), p["kv_b"], dtype,
            quantize).reshape(B, L, H, dn + dv)
    k_nope, v = kv[..., :dn], kv[..., dn:]
    q_pe = rope(q[..., dn:], enc["rope_theta"]).to(dtype)
    k_pe = rope(k_pe.reshape(B, L, 1, dr), enc["rope_theta"]).to(dtype).expand(B, L, H, dr)
    qh = torch.cat([q[..., :dn], q_pe], dim=-1).transpose(1, 2)
    kh = torch.cat([k_nope, k_pe], dim=-1).transpose(1, 2)
    if quantize:
        qh, kh = R._fp8(qh), R._fp8(kh)
    scores = (qh @ kh.transpose(-1, -2)).float() / math.sqrt(dn + dr)
    causal = torch.ones(L, L, dtype=torch.bool, device=x.device).triu(1)
    probs = torch.softmax(scores.masked_fill(causal, float("-inf")), dim=-1).to(dtype)
    vh = v.transpose(1, 2).to(dtype)
    if quantize:
        probs, vh = R._fp8(probs), R._fp8(vh)
    out = (probs @ vh).transpose(1, 2).reshape(B, L, H * dv)
    return mm(out, p["o"], dtype, quantize)


def route(p: dict, n: torch.Tensor, enc: dict, fault: str | None = None):
    """(chosen experts [T, k], their weights [T, k]); ``fault``
    ``"softmax_router"`` scores by a softmax, ``"no_bias"`` chooses without
    the correction bias."""
    logits = n.float() @ p["w"].float()
    scores = torch.softmax(logits, dim=-1) if fault == "softmax_router" else torch.sigmoid(logits)
    choice = scores.detach() if fault == "no_bias" else scores.detach() + p["bias"].detach()
    chosen = torch.topk(choice, enc["num_experts_per_tok"], dim=-1).indices
    w = scores.gather(1, chosen)
    if enc["norm_topk_prob"]:
        w = w / (w.sum(dim=-1, keepdim=True) + 1e-20)
    return chosen, w * enc["routed_scaling_factor"]


def routed(p: dict, n: torch.Tensor, chosen, w, held, dtype, quantize: bool = False):
    """(the held experts' weighted sum [T, d], tokens each held expert got)."""
    out = torch.zeros_like(n, dtype=torch.float32)
    counts = []
    for j, e in enumerate(held):
        hit = chosen == e                                   # [T, k]
        sel = hit.any(dim=-1)
        counts.append(int(sel.sum()))
        if not counts[-1]:
            continue
        y = mlp({"w13": p["w13"][j], "w2": p["w2"][j]}, n[sel], dtype, quantize).float()
        wt = (w * hit).sum(dim=-1)[sel]
        part = torch.zeros_like(out)
        part[sel] = wt[:, None] * y
        out = out + part
    return out, counts


def encoder(p: dict, ids: torch.Tensor, enc: dict, held, dtype, quantize: bool = False,
            fault: str | None = None, counts: list | None = None) -> torch.Tensor:
    """``ids [B, L]`` -> ``[B, L, out]`` float32; ``counts`` (a list)
    receives each MoE layer's tokens per held expert."""
    B, L = ids.shape
    d, eps = enc["hidden_size"], enc["rms_norm_eps"]
    h = p["embed"][ids.long()]
    for i, lp in enumerate(p["layers"]):
        h = h + mla(lp["attn"], rms_norm(h, lp["attn_norm"], eps), enc, dtype, quantize).float()
        n = rms_norm(h, lp["mlp_norm"], eps)
        if i < enc["first_k_dense_replace"]:
            h = h + mlp(lp["mlp"], n, dtype, quantize).float()
            continue
        n = n.reshape(B * L, d)
        chosen, w = route(lp["router"], n, enc, fault)
        out, got = routed(lp["experts"], n, chosen, w, held, dtype, quantize)
        if counts is not None:
            counts.append(got)
        h = h + (mlp(lp["shared"], n, dtype, quantize).float() + out).reshape(B, L, d)
    return R.linear(p["proj"], rms_norm(h, p["norm"], eps))


def fusion_forward(params: dict, stats: dict, consts: dict, batch: dict, cfg: dict, enc: dict,
                   held, *, train: bool = False, seed: int | None = None, dtype=torch.float32,
                   quantize: bool = False, fault: str | None = None,
                   counts: list | None = None):
    """(logits, new trunk statistics) of the fusion model with the encoder
    as its text memory bank (:func:`benchmark.reference.model.fusion_forward`
    with ``encoder`` in place of the embedding and the BiLSTM)."""
    rngs = R.Rng(seed if train else None)
    rate = cfg["dropout"]
    ngram = (batch["eids"].shape[-1] - 1) // 2
    text = R.text_gcn(params["text_gcn"], batch["ids"], batch["lens"], batch["eids"], ngram,
                      cfg["text_dropout"], rngs.next("text_gcn"))
    bank = encoder(params["encoder"], batch["ids"], enc, held, dtype, quantize, fault, counts)
    image = R.normalize(batch["image"], dtype)
    new_stats, vec, img_bank = {}, {}, {}
    for side in ("object", "place"):
        feats, new_stats[f"{side}_trunk"] = R.resnet(
            params[f"{side}_trunk"], stats[f"{side}_trunk"], image,
            train and cfg.get("bn_mode", "batch") == "batch", dtype, quantize)
        feats = feats.float()
        B, H, W, C = feats.shape
        img_bank[side] = R.linear(params[f"liner_img_{side}"], feats.reshape(B, H * W, C))
        adj = R.norm_adj(params[f"{side}_A"].detach())
        x = adj @ (consts[f"{side}_inp"] @ params["gc1"]["w"])
        x = torch.where(x >= 0, x, 0.2 * x)
        x = adj @ (x @ params["gc2"]["w"])
        x = feats.amax(dim=(1, 2)) @ x.T
        att = R.label_attention(params[f"{side}_attention"], consts["label_query"], x,
                                cfg["n_label_heads"], rate, rngs.next(f"{side}_label_attn"))
        att = R.linear(params[f"{side}_linear_5"], att).reshape(B, -1)
        vec[side] = R.linear(params[f"{side}_x_linear"], att)

    def stack(name, q, kv, mask, tag):
        for i, blk in enumerate(params[name]):
            q = R.mha(blk, q, kv, mask, cfg["n_head"], cfg["d_kv"], rate, rngs.next(f"{tag}{i}"))
        return q

    iot = stack("img_object_text_mha", vec["object"], bank, batch["mask"], "iot")
    ipt = stack("img_place_text_mha", vec["place"], bank, batch["mask"], "ipt")
    tio = stack("text_img_object_mha", text, img_bank["object"], None, "tio")
    tip = stack("text_img_place_mha", text, img_bank["place"], None, "tip")
    multi = R.linear(params["multi_linear_1"], torch.cat([tio, tip, iot, ipt], dim=1))
    multi = R.dropout(multi, rate, rngs.next("classifier"))
    return R.linear(params["multi_linear_2"], multi), new_stats


class Adam(R.Adam):
    """:class:`benchmark.reference.model.Adam` with the encoder as a group
    of factor 1 (the reference's default) and its routers' correction
    biases frozen, as the published model trains them by no gradient.
    :meth:`step` is its arithmetic a leaf at a time, each gradient let go
    once used, and hands back norms: 2.7 B parameters leave no room for a
    second list of every gradient."""

    def __init__(self, params: dict, opt: dict):
        super().__init__(params, opt)
        for i, name in enumerate(self.names):
            if name.startswith("/encoder/") and name.endswith("/router/bias"):
                self.factors[i] = 0.0

    def step(self, params: list[torch.Tensor], grads: list) -> list[float | None]:
        """Update ``params`` in place, emptying ``grads``; returns the norm
        of the gradient each trained leaf got after the clip and the weight
        decay (None for a frozen leaf)."""
        o = self.opt
        norm = torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(g) for g in grads if g is not None]))
        scale = torch.where(norm < o["grad_clip"], torch.ones_like(norm), o["grad_clip"] / norm)
        self.count += 1
        c = torch.tensor(float(self.count))
        bc1 = 1 - torch.tensor(0.9) ** c
        bc2 = 1 - torch.tensor(0.999) ** c
        got: list = []
        for i, p in enumerate(params):
            g, grads[i] = grads[i], None
            if self.factors[i] == 0.0:
                got.append(None)
                continue
            g = (torch.zeros_like(p) if g is None else g * scale) + o["weight_decay"] * p
            self.mu[i] = 0.9 * self.mu[i] + 0.1 * g
            self.nu[i] = 0.999 * self.nu[i] + 0.001 * g * g
            upd = (self.mu[i] / bc1.to(p.device)) / (torch.sqrt(self.nu[i] / bc2.to(p.device))
                                                     + 1e-8)
            p.sub_(o["lr"] * self.factors[i] * upd)
            got.append(float(torch.linalg.vector_norm(g.double())))
        return got


def train_step(params: dict, stats: dict, consts: dict, batch: dict, cfg: dict, enc: dict, held,
               adam: Adam, seed: int, dtype, quantize: bool = False, fault: str | None = None,
               counts: list | None = None):
    """One step in place of ``params`` and ``stats`` (as
    :func:`benchmark.reference.model.fusion_train_step`): (loss, the norms
    of the gradients as the optimizer got them, in leaf order)."""
    flat = [p.detach().requires_grad_(p.is_floating_point()) for p in R.leaves(params)]
    logits, new_stats = fusion_forward(R.unflatten(params, flat), stats, consts, batch, cfg, enc,
                                       held, train=True, seed=seed, dtype=dtype,
                                       quantize=quantize, fault=fault, counts=counts)
    loss = R.cross_entropy(logits, batch["label"], batch["weight"])
    want = [i for i, name in enumerate(adam.names) if adam.factors[i] != 0.0]
    grads: list = [None] * len(flat)
    for i, g in zip(want, torch.autograd.grad(loss, [flat[i] for i in want], allow_unused=True)):
        grads[i] = g
    with torch.no_grad():
        got = adam.step([p for p in R.leaves(params)], grads)
        for old, new in zip(R.leaves(stats), R.leaves(new_stats)):
            old.copy_(new)
    return float(loss.detach()), got
