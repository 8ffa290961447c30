"""The MGNNS fusion model (eval forward): three channels + cross-modal
attention fusion.

Port of the JAX package's ``mgnns_tpu/models/mgnns.py`` (reference
``models/Multi_GCN_Multihead_att.py``, forward ``:431-567``):

text channel   — text-level GCN over the global PMI graph -> [B, 300], and a
                 2-layer BiLSTM memory bank [B, L, 300];
object channel — ResNet-101 trunk -> [B, 14, 14, 2048] at 448 px; memory bank
                 via 2048->300 linear; global max pool; 2-layer GCN over the
                 object graph fused by ``pooled @ x^T``; label-query attention
                 -> 700 -> 300;
scene channel  — the same with the Places ResNet-50 trunk and scene graph;
fusion         — four stacked 1-query cross-attention directions, concat
                 [B, 1200] -> 300 -> num_labels.

Both trunks see the same image.  ``consts`` holds the label-embedding query
and the object/place GloVe inputs (the JAX package passes the latter two in
the batch).  The forward's five stages are named ``torch.profiler`` ranges
(``mgnns.text_gcn``, ``.lstm``, ``.object_channel``, ``.place_channel``,
``.fusion``) for the per-stage breakdown; without a profiler each is one
host call per forward.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function

from mgnns_tpu_torch.config import ModelConfig
from mgnns_tpu_torch.graphs.cooccur import gen_adj
from mgnns_tpu_torch.nn import attention, image_gcn, lstm, resnet, text_gcn
from mgnns_tpu_torch.nn.core import as_param, embedding, embedding_init, leaky_relu, linear, linear_init
from mgnns_tpu_torch.utils import resolve_device

# ImageNet statistics (reference Multi_GCN_Multihead_att.py:350-351)
_IMAGE_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
_IMAGE_STD = np.array([0.229, 0.224, 0.225], np.float32)


def normalize_image_batch(x: torch.Tensor) -> torch.Tensor:
    """On-device ImageNet normalization of raw uint8 pixels [B, H, W, 3];
    float inputs are taken as already normalized and pass through."""
    if x.dtype == torch.uint8:
        scale = torch.tensor((1.0 / (255.0 * _IMAGE_STD)).astype(np.float32), device=x.device)
        bias = torch.tensor((-_IMAGE_MEAN / _IMAGE_STD).astype(np.float32), device=x.device)
        return x.float() * scale + bias
    return x


def mgnns_init(
    cfg: ModelConfig,
    *,
    num_edges: int,
    label_embedding: np.ndarray,
    object_A: np.ndarray,
    place_A: np.ndarray,
    object_inp: np.ndarray,
    place_inp: np.ndarray,
    seed: int = 0,
    device="cuda",
) -> tuple[dict, dict]:
    """Build (params, consts) on ``device`` from a ``torch.Generator``
    seeded with ``seed``; the shapes are the JAX package's ``mgnns_init``.

    Args:
      num_edges: PMI edge-table size (``PmiGraph.num_edges``).
      label_embedding: [num_labels, 300] label GloVe.
      object_A / place_A: outputs of :func:`mgnns_tpu_torch.graphs.cooccur.gen_A`.
      object_inp / place_inp: [C, 300] object / place GloVe inputs.
    """
    g = torch.Generator(device=resolve_device(device)).manual_seed(seed)
    d = cfg.bi_hidden_size
    p: dict = {
        "text_gcn": text_gcn.text_gcn_init(g, cfg.vocab_size, cfg.emb_size, num_edges),
        "embedding": embedding_init(g, cfg.vocab_size, cfg.emb_size),
        "lstm": lstm.lstm_init(g, cfg.emb_size, cfg.hidden_size, cfg.num_layers, cfg.bidirectional),
        "object_trunk": resnet.resnet_init(g, depth=101),
        "place_trunk": resnet.resnet_init(g, depth=50),
        "liner_img_object": linear_init(g, 2048, d),
        "liner_img_place": linear_init(g, 2048, d),
        # gc1/gc2 shared by both image channels (reference :304-305)
        "gc1": image_gcn.graph_conv_init(g, cfg.in_channel, cfg.gcn_hidden),
        "gc2": image_gcn.graph_conv_init(g, cfg.gcn_hidden, cfg.gcn_out),
        "object_attention": attention.label_attention_init(g, 300, cfg.object_num_classes),
        "place_attention": attention.label_attention_init(g, 300, cfg.place_num_classes),
        "object_linear_5": linear_init(g, 300, 100),
        "object_x_linear": linear_init(g, cfg.num_labels * 100, 300),
        "place_linear_5": linear_init(g, 300, 100),
        "place_x_linear": linear_init(g, cfg.num_labels * 100, 300),
    }
    for name in ("img_object_text_mha", "img_place_text_mha",
                 "text_img_object_mha", "text_img_place_mha"):
        p[name] = [attention.my_mha_init(g, cfg.n_head, d, cfg.d_kv) for _ in range(cfg.stack_num)]
    p["multi_linear_1"] = linear_init(g, 4 * d, d)
    p["multi_linear_2"] = linear_init(g, d, cfg.num_labels)
    p["object_A"] = as_param(object_A, g)
    p["place_A"] = as_param(place_A, g)
    consts = {"label_query": as_param(label_embedding, g),
              "object_inp": as_param(object_inp, g),
              "place_inp": as_param(place_inp, g)}
    return p, consts


def _image_channel(params: dict, consts: dict, image: torch.Tensor, *, side: str,
                   cfg: ModelConfig):
    """One image channel (reference ``:450-479`` object / ``:482-506``
    place).  Returns (memory_bank [B, h*w, d], channel_vec [B, 300])."""
    feats = resnet.resnet_apply(params[f"{side}_trunk"], image)   # [B, h, w, 2048]
    B, H, W, C = feats.shape
    memory_bank = linear(params[f"liner_img_{side}"], feats.reshape(B, H * W, C))
    pooled = feats.amax(dim=(1, 2))                                 # [B, 2048]

    adj = gen_adj(params[f"{side}_A"])
    x = image_gcn.graph_conv_apply(params["gc1"], consts[f"{side}_inp"], adj)
    x = leaky_relu(x)
    x = image_gcn.graph_conv_apply(params["gc2"], x, adj)          # [C_cls, 2048]
    x = pooled @ x.T                                                # [B, C_cls]

    att = attention.label_attention_apply(
        params[f"{side}_attention"], consts["label_query"], x, x,
        n_heads=cfg.n_label_heads)                                  # [B, num_labels, 300]
    att = linear(params[f"{side}_linear_5"], att).reshape(B, -1)    # [B, num_labels*100]
    return memory_bank, linear(params[f"{side}_x_linear"], att)     # [B, 300]


def mgnns_apply(params: dict, consts: dict, batch: dict, *, cfg: ModelConfig) -> torch.Tensor:
    """Eval forward (training is queued in ROADMAP.md, queue 1, item 2).

    Args:
      batch: dict with ``ids`` [B, L] token ids (PAD=0, suffix padding),
        ``lens`` [B] int32, ``mask`` [B, L] float (1 = real token), ``eids``
        [B, L, 2*ngram+1] window edge ids, ``image`` [B, H, W, 3] uint8
        pixels or normalized floats (fed to both trunks).
    Returns:
      logits [B, num_labels].
    """
    with record_function("mgnns.text_gcn"):
        text_feature = text_gcn.text_gcn_apply(
            params["text_gcn"], batch["ids"], batch["lens"], batch["eids"],
            ngram=(batch["eids"].shape[-1] - 1) // 2)              # [B, 300]
    with record_function("mgnns.lstm"):
        emb = embedding(params["embedding"]["table"], batch["ids"])
        text_memory_bank, _ = lstm.lstm_apply(params["lstm"], emb, batch["lens"])  # [B, L, 300]

    image = normalize_image_batch(batch["image"])
    with record_function("mgnns.object_channel"):
        obj_bank, obj_vec = _image_channel(params, consts, image, side="object", cfg=cfg)
    with record_function("mgnns.place_channel"):
        plc_bank, plc_vec = _image_channel(params, consts, image, side="place", cfg=cfg)

    def run_stack(name, q, kv, mask):
        for blk in params[name]:
            q, _ = attention.my_mha_apply(blk, q, kv, kv, mask, n_head=cfg.n_head, d_kv=cfg.d_kv)
        return q

    mask = batch["mask"]
    with record_function("mgnns.fusion"):
        multi = torch.cat([
            run_stack("text_img_object_mha", text_feature, obj_bank, None),
            run_stack("text_img_place_mha", text_feature, plc_bank, None),
            run_stack("img_object_text_mha", obj_vec, text_memory_bank, mask),
            run_stack("img_place_text_mha", plc_vec, text_memory_bank, mask),
        ], dim=1)                                                   # [B, 1200]
        return linear(params["multi_linear_2"], linear(params["multi_linear_1"], multi))
