"""Attention blocks: cross-modal multi-head attention, the position-wise
FFN, the 1-query wrapper, the label-query element-wise attention, and the
head-diversity regularizer.

Port of the JAX package's ``mgnns_tpu/nn/attention.py``:

- :func:`mha_apply` — scaled dot product with temperature sqrt(d_k),
  ``mask == 0 -> -inf`` over the key axis, attention dropout, output
  projection + dropout, residual + torch-std LayerNorm, and with ``is_regu``
  the head-diversity penalty (reference ``models/submodules.py:15-119``);
- :func:`my_mha_apply` — the 1-query wrapper + FFN (reference
  ``models/moudles.py:198-230``);
- :func:`label_attention_apply` — per-head *element-wise* Q*K energies (not
  dot products), softmax over the per-head feature slice, element-wise
  product with V (reference ``models/Multi_GCN_Multihead_att.py:65-133``);
- :func:`my_another_mha_init` / :func:`my_another_mha_apply` — the
  reference's ``MyAnotherMultiHeadAttention`` (``moudles.py:232-288``), which
  differs from the 1-query wrapper only in how it orders the (batch, head)
  axes; its blocks are built but their calls are commented out of the
  reference forward (``Multi_GCN_Multihead_att.py:516-532``), so these are
  aliases;
- :func:`positional_encoding_table` / :func:`add_positional_encoding` — the
  reference's sinusoid ``PositionalEncoding`` (``submodules.py:159-182``),
  defined there but never instantiated.

Dropout sits where the JAX package puts it (attention probabilities, output
projection, FFN, label attention) and draws from per-site generators
(:class:`mgnns_tpu_torch.nn.core.RngStream`).

On a model axis (``model=``) the q/k/v projections are column-parallel,
so a rank computes its ``H / N`` heads, and ``fc`` is row-parallel; the
FFN's ``w_1`` is column-parallel and ``w_2`` row-parallel.  A rank draws
the attention dropout mask for every head and keeps its heads', and the
head-diversity penalty gathers every head first.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from mgnns_tpu_torch.nn.core import (
    RngStream, dropout, layer_norm, layer_norm_init, linear, linear_init, scope, sharded,
)
from mgnns_tpu_torch.parallel.collectives import copy_to_model, gather_from_model
from mgnns_tpu_torch.utils import resolve_device


def mha_init(g: torch.Generator, n_head: int, d_model: int, d_k: int, d_v: int) -> dict:
    std_qk = ("normal", math.sqrt(2.0 / (d_model + d_k)))
    std_v = ("normal", math.sqrt(2.0 / (d_model + d_v)))
    return {
        "w_qs": linear_init(g, d_model, n_head * d_k, w_init=std_qk),
        "w_ks": linear_init(g, d_model, n_head * d_k, w_init=std_qk),
        "w_vs": linear_init(g, d_model, n_head * d_v, w_init=std_v),
        "fc": linear_init(g, n_head * d_v, d_model, w_init="xavier_normal"),
        "ln": layer_norm_init(d_model, g.device),
    }


def head_diversity(output_heads: torch.Tensor) -> torch.Tensor:
    """Mean squared pairwise cosine similarity across heads (reference
    ``diff_outputs``, ``models/submodules.py:38-53``).  output_heads
    [B, n_head, d_v] -> [B].  Normalizes by ``sqrt(sum^2 + 1e-12)``, whose
    gradient stays finite at an all-zero head; 0 for fewer than 2 heads."""
    x = output_heads / torch.sqrt((output_heads ** 2).sum(-1, keepdim=True) + 1e-12)
    n_head = output_heads.shape[1]
    if n_head < 2:
        return output_heads.new_zeros(output_heads.shape[0])
    cos = torch.einsum("bhd,bgd->bhg", x, x)
    cos = cos * (1.0 - torch.eye(n_head, dtype=cos.dtype, device=cos.device))
    return (cos ** 2).sum(dim=(1, 2)) / (n_head * (n_head - 1))


def mha_apply(p: dict, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              mask: torch.Tensor | None = None, *, n_head: int, d_k: int, d_v: int,
              dropout_rate: float = 0.1, train: bool = False,
              generator: torch.Generator | None = None, is_regu: bool = False, model=None):
    """q [B, Lq, d_model], k/v [B, Lk, d_model], mask [B, Lq, Lk] float
    (0.0 = masked).  Returns (out [B, Lq, d_model], attn [B, H, Lq, Lk]), and
    with ``is_regu`` also the head-diversity penalty [B] of query 0.  On a
    model axis of N ranks that splits the heads, ``attn`` holds this rank's
    ``H / N`` heads."""
    rngs = RngStream(generator)
    heads = sharded(model, "w_qs/w")
    H = n_head if heads is None else n_head // heads.size
    B, Lq, _ = q.shape
    Lk = k.shape[1]
    qc, kc, vc = q, k, v
    if heads is not None:
        # one gradient all-reduce per distinct input (k is v in the model)
        qc = copy_to_model(q, heads)
        kc = copy_to_model(k, heads)
        vc = kc if v is k else copy_to_model(v, heads)
    qh = linear(p["w_qs"], qc).reshape(B, Lq, H, d_k)
    kh = linear(p["w_ks"], kc).reshape(B, Lk, H, d_k)
    vh = linear(p["w_vs"], vc).reshape(B, Lk, H, d_v)
    attn = torch.einsum("bqhd,bkhd->bhqk", qh, kh) / math.sqrt(d_k)
    if mask is not None:
        attn = attn.masked_fill(mask[:, None, :, :] == 0.0, float("-inf"))
    attn = torch.softmax(attn, dim=-1)
    attn = dropout(attn, dropout_rate, rngs.next("attn"), train,
                   shard=None if heads is None else (heads, 1))
    out_h = torch.einsum("bhqk,bkhd->bqhd", attn, vh)  # [B, Lq, H, d_v]
    out = linear(p["fc"], out_h.reshape(B, Lq, H * d_v), row=sharded(model, "fc/w"))
    out = dropout(out, dropout_rate, rngs.next("proj"), train)
    out = layer_norm(p["ln"], out + q)
    if is_regu:
        query0 = out_h[:, 0, :, :]
        if heads is not None:
            query0 = gather_from_model(query0, heads, dim=1)
        return out, attn, head_diversity(query0)
    return out, attn


def ffn_init(g: torch.Generator, d_in: int, d_hid: int) -> dict:
    return {"w_1": linear_init(g, d_in, d_hid), "w_2": linear_init(g, d_hid, d_in),
            "ln": layer_norm_init(d_in, g.device)}


def ffn_apply(p: dict, x: torch.Tensor, *, dropout_rate: float = 0.1, train: bool = False,
              generator: torch.Generator | None = None, model=None) -> torch.Tensor:
    h = torch.relu(linear(p["w_1"], x, column=sharded(model, "w_1/w")))
    out = linear(p["w_2"], h, row=sharded(model, "w_2/w"))
    out = dropout(out, dropout_rate, generator, train)
    return layer_norm(p["ln"], out + x)


def my_mha_init(g: torch.Generator, n_head: int, d_model: int, d_kv: int) -> dict:
    return {"slf_attn": mha_init(g, n_head, d_model, d_kv, d_kv),
            "pos_ffn": ffn_init(g, d_model, d_model)}


def my_mha_apply(p: dict, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 mask: torch.Tensor | None = None, *, n_head: int, d_kv: int,
                 dropout_rate: float = 0.1, train: bool = False,
                 generator: torch.Generator | None = None, is_regu: bool = False, model=None):
    """q [B, d_model]; k/v [B, L, d_model]; mask [B, L] float or None.
    Returns (out [B, d_model], attn), and the head-diversity penalty [B]
    third with ``is_regu``."""
    rngs = RngStream(generator)
    mask3 = mask[:, None, :] if mask is not None else None
    res = mha_apply(p["slf_attn"], q[:, None, :], k, v, mask3, n_head=n_head, d_k=d_kv,
                    d_v=d_kv, dropout_rate=dropout_rate, train=train,
                    generator=rngs.next("mha"), is_regu=is_regu, model=scope(model, "slf_attn"))
    out = ffn_apply(p["pos_ffn"], res[0], dropout_rate=dropout_rate, train=train,
                    generator=rngs.next("ffn"), model=scope(model, "pos_ffn"))[:, 0, :]
    return (out, *res[1:])


my_another_mha_init = my_mha_init
my_another_mha_apply = my_mha_apply


def positional_encoding_table(d_hid: int, n_position: int = 200, device="cuda") -> torch.Tensor:
    """[n_position, d_hid] float32 sinusoid table on ``device``:
    angle(pos, j) = pos / 10000^(2*(j//2)/d_hid), sin on even dims and cos
    on odd ones, computed in float64 and rounded once."""
    pos = np.arange(n_position, dtype=np.float64)[:, None]
    j = np.arange(d_hid, dtype=np.float64)[None, :]
    angles = pos / np.power(10000.0, 2.0 * np.floor(j / 2.0) / d_hid)
    table = np.where(np.arange(d_hid)[None, :] % 2 == 0, np.sin(angles), np.cos(angles))
    return torch.tensor(table.astype(np.float32), device=resolve_device(device))


def add_positional_encoding(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """x [B, L, D] + table[:L]; no gradient reaches the table (the
    reference's ``x + pos_table[:, :x.size(1)].detach()``)."""
    return x + table[: x.shape[1]].detach()[None, :, :]


def label_attention_init(g: torch.Generator, hid_dim: int, image_dim: int) -> dict:
    return {"w_q": linear_init(g, hid_dim, hid_dim), "w_k": linear_init(g, image_dim, hid_dim),
            "w_v": linear_init(g, image_dim, hid_dim), "fc": linear_init(g, hid_dim, hid_dim)}


def label_attention_apply(p: dict, query: torch.Tensor, key_: torch.Tensor,
                          value: torch.Tensor, *, n_heads: int = 5, dropout_rate: float = 0.5,
                          train: bool = False,
                          generator: torch.Generator | None = None) -> torch.Tensor:
    """query: label embeddings [num_labels, hid_dim]; key_/value: fused image
    vectors [B, image_dim].  Returns [B, num_labels, hid_dim]."""
    hid_dim = query.shape[-1]
    n_labels = query.shape[0]
    dh = hid_dim // n_heads
    Q = linear(p["w_q"], query).reshape(n_labels, n_heads, dh)
    K = linear(p["w_k"], key_).reshape(-1, n_heads, dh)
    V = linear(p["w_v"], value).reshape(-1, n_heads, dh)
    scale = float(torch.tensor(dh, dtype=torch.float32).sqrt())
    energy = Q[None, :, :, :] * K[:, None, :, :] / scale         # [B, C, H, dh]
    attn = dropout(torch.softmax(energy, dim=-1), dropout_rate, generator, train)
    x = attn * V[:, None, :, :]                                   # [B, C, H, dh]
    return linear(p["fc"], x.reshape(x.shape[0], n_labels, hid_dim))
