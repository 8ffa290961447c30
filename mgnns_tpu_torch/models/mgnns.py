"""The MGNNS fusion model: three channels + cross-modal attention fusion.

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
the batch).  The trunks' running statistics are the separate
``batch_stats`` tree, which the apply returns updated in train mode
(:mod:`mgnns_tpu_torch.nn.resnet`).  The forward's five stages are named
``torch.profiler`` ranges (``mgnns.text_gcn``, ``.lstm``,
``.object_channel``, ``.place_channel``, ``.fusion``) for the per-stage
breakdown; without a profiler each is one host call per forward.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function
from torch.utils.checkpoint import checkpoint

from mgnns_tpu_torch.config import ModelConfig
from mgnns_tpu_torch.graphs.cooccur import gen_adj
from mgnns_tpu_torch.nn import attention, image_gcn, lstm, resnet, text_gcn
from mgnns_tpu_torch.nn.core import (
    RngStream, as_param, dropout, embedding, embedding_init, leaky_relu, linear, linear_init,
)
from mgnns_tpu_torch.utils import resolve_device, tree_to

# the reference modules that its __init__ builds and its forward never runs
DEAD_MODULES = (
    "rnn", "object_gate", "place_gate",
    *(f"{side}_linear_{i}" for side in ("object", "place") for i in (1, 2, 3)),
    "text_object_text_mha", "text_place_text_mha", "text_head",
)

# ImageNet statistics (reference Multi_GCN_Multihead_att.py:350-351)
_IMAGE_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
_IMAGE_STD = np.array([0.229, 0.224, 0.225], np.float32)


def normalize_image_batch(x: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """On-device ImageNet normalization of raw uint8 pixels [B, H, W, 3] in
    ``dtype``, each operation rounded to it as in the JAX package
    (``mgnns_tpu/models/mgnns.py:61-71``); float inputs are taken as already
    normalized and pass through."""
    if x.dtype == torch.uint8:
        scale = _filled((1.0 / (255.0 * _IMAGE_STD)).astype(np.float32), x.device)
        bias = _filled((-_IMAGE_MEAN / _IMAGE_STD).astype(np.float32), x.device)
        return x.to(dtype) * scale.to(dtype) + bias.to(dtype)
    return x


def _filled(values: np.ndarray, device: torch.device) -> torch.Tensor:
    """float32 ``values`` on ``device``, made by fills there: a CUDA graph
    capture refuses a copy from the host."""
    return torch.stack([torch.full((), float(v), dtype=torch.float32, device=device)
                        for v in values])


def mgnns_init(
    cfg: ModelConfig,
    *,
    num_edges: int,
    label_embedding: np.ndarray,
    object_A: np.ndarray,
    place_A: np.ndarray,
    object_inp: np.ndarray,
    place_inp: np.ndarray,
    vocab_embedding: np.ndarray | None = None,
    node_embedding: np.ndarray | None = None,
    edge_weights: np.ndarray | None = None,
    object_trunk: tuple[dict, dict] | None = None,
    place_trunk: tuple[dict, dict] | None = None,
    include_dead_modules: bool = False,
    seed: int = 0,
    device="cuda",
) -> tuple[dict, dict, dict]:
    """Build (params, batch_stats, consts) on ``device`` from a
    ``torch.Generator`` seeded with ``seed``; the shapes and options are the
    JAX package's ``mgnns_init`` (``mgnns_tpu/models/mgnns.py:74-128``).  A
    given table or trunk is used instead of a random one, and the draws of
    the parameters after it then shift.

    Args:
      num_edges: PMI edge-table size (``PmiGraph.num_edges``).
      label_embedding: [num_labels, 300] label GloVe.
      object_A / place_A: outputs of :func:`mgnns_tpu_torch.graphs.cooccur.gen_A`.
      object_inp / place_inp: [C, 300] object / place GloVe inputs.
      vocab_embedding: optional [V, 300] GloVe for the sequence embedding.
      node_embedding: optional [V, 300] GloVe for the text-GCN nodes.
      edge_weights: optional [E, 1] text-GCN edge-weight table
        (``PmiGraph.initial_edge_weights``).
      object_trunk / place_trunk: optional (params, stats) trunks
        (:func:`mgnns_tpu_torch.nn.resnet.import_torch_state_dict`).
      include_dead_modules: also build the reference modules that its
        ``__init__`` constructs and its forward never runs
        (:data:`DEAD_MODULES`, shapes of ``mgnns_tpu/models/mgnns.py:155-176``),
        so an exported ``state_dict`` satisfies a reference-side strict
        ``load_state_dict``.  :func:`mgnns_apply` never reads them and the
        optimizer freezes them.  They are drawn after every other parameter,
        so the live parameters do not depend on this flag.
    """
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    d = cfg.bi_hidden_size
    s: dict = {}
    p: dict = {
        "text_gcn": text_gcn.text_gcn_init(g, cfg.vocab_size, cfg.emb_size, num_edges,
                                           node_weights=node_embedding,
                                           edge_weights=edge_weights),
        "embedding": embedding_init(g, cfg.vocab_size, cfg.emb_size, weights=vocab_embedding),
        "lstm": lstm.lstm_init(g, cfg.emb_size, cfg.hidden_size, cfg.num_layers, cfg.bidirectional),
    }
    for side, trunk, depth in (("object", object_trunk, 101), ("place", place_trunk, 50)):
        if trunk is None:
            trunk = resnet.resnet_init(g, depth=depth)
        p[f"{side}_trunk"], s[f"{side}_trunk"] = tree_to(trunk, dev)
    p.update({
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
    })
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
    if include_dead_modules:
        # GRU text encoder (reference :172-177), gates (:186-187), the
        # per-channel linear pyramids (:316-326), the text_object_text /
        # text_place_text blocks (:214-245, calls commented out at :516-532)
        # and Text_GCN's classification head (Text_GCN.py:95)
        p["rnn"] = lstm.gru_init(g, cfg.emb_size, cfg.hidden_size, cfg.num_layers,
                                 cfg.bidirectional)
        p["object_gate"] = linear_init(g, 2 * d, d)
        p["place_gate"] = linear_init(g, 2 * d, d)
        for side in ("object", "place"):
            p[f"{side}_linear_1"] = linear_init(g, 2048, 1024)
            p[f"{side}_linear_2"] = linear_init(g, 1024, 512)
            p[f"{side}_linear_3"] = linear_init(g, 512, 256)
        p["text_object_text_mha"] = attention.my_another_mha_init(g, cfg.n_head, d, cfg.d_kv)
        p["text_place_text_mha"] = attention.my_another_mha_init(g, cfg.n_head, d, cfg.d_kv)
        p["text_head"] = linear_init(g, cfg.emb_size, cfg.num_labels)
    return p, s, consts


def _image_channel(params: dict, batch_stats: dict, consts: dict, image: torch.Tensor, *,
                   side: str, cfg: ModelConfig, train: bool, rngs: RngStream, axis=None):
    """One image channel (reference ``:450-479`` object / ``:482-506``
    place).  Returns (memory_bank [B, h*w, d], channel_vec [B, 300],
    new trunk statistics)."""
    trunk_p, trunk_s = params[f"{side}_trunk"], batch_stats[f"{side}_trunk"]
    # bn_mode 'batch' normalizes by batch statistics and moves the running
    # ones in train mode; 'frozen' and frozen trunks use the running ones
    bn_train = train and cfg.bn_mode == "batch" and not cfg.freeze_trunks
    block_remat = cfg.remat_policy == "block"

    def trunk_fn(img):
        return resnet.resnet_apply(trunk_p, trunk_s, img, train=bn_train, block_remat=block_remat,
                                   dtype=cfg.cdtype, axis=axis)

    if cfg.freeze_trunks:
        # feature extraction: no trunk backward and the old statistics, as
        # the JAX package's stop_gradient (the optimizer freezes the trunks)
        with torch.no_grad():
            feats, _ = trunk_fn(image)
        new_stats = trunk_s
    elif ((cfg.remat_trunks or cfg.remat_policy == "trunk") and not block_remat
          and torch.is_grad_enabled()):
        # one checkpoint around the whole trunk; 'block' wins when both are asked
        # no random numbers in a trunk: no RNG state to save (see resnet_apply)
        feats, new_stats = checkpoint(trunk_fn, image, use_reentrant=False,
                                      preserve_rng_state=False)
    else:
        feats, new_stats = trunk_fn(image)                          # [B, h, w, 2048]
    feats = feats.float()  # the heads run in float32 (the JAX package's feats32)
    B, H, W, C = feats.shape
    memory_bank = linear(params[f"liner_img_{side}"], feats.reshape(B, H * W, C))
    pooled = feats.amax(dim=(1, 2))                                 # [B, 2048]

    adj = gen_adj(params[f"{side}_A"].detach())                     # the reference detaches
    x = image_gcn.graph_conv_apply(params["gc1"], consts[f"{side}_inp"], adj)
    x = leaky_relu(x)
    x = image_gcn.graph_conv_apply(params["gc2"], x, adj)          # [C_cls, 2048]
    x = pooled @ x.T                                                # [B, C_cls]

    att = attention.label_attention_apply(
        params[f"{side}_attention"], consts["label_query"], x, x, n_heads=cfg.n_label_heads,
        dropout_rate=cfg.dropout, train=train,
        generator=rngs.next(f"{side}_label_attn"))                  # [B, num_labels, 300]
    att = linear(params[f"{side}_linear_5"], att).reshape(B, -1)    # [B, num_labels*100]
    return memory_bank, linear(params[f"{side}_x_linear"], att), new_stats


def mgnns_apply(params: dict, batch_stats: dict, consts: dict, batch: dict, *,
                cfg: ModelConfig, train: bool = False,
                generator: torch.Generator | None = None,
                axis=None) -> tuple[torch.Tensor, dict, dict]:
    """Forward pass (``mgnns_tpu/models/mgnns.py:277-380``).

    Args:
      batch: dict with ``ids`` [B, L] token ids (PAD=0, suffix padding),
        ``lens`` [B] int32, ``mask`` [B, L] float (1 = real token), ``eids``
        [B, L, 2*ngram+1] window edge ids, ``image`` [B, H, W, 3] uint8
        pixels or normalized floats (fed to both trunks).
      train: dropout from ``generator`` at every site, and train-mode
        BatchNorm under ``cfg.bn_mode == "batch"``.
      axis: the data axis (:class:`~mgnns_tpu_torch.parallel.collectives.
        DataAxis`) when ``batch`` is this rank's rows of a global batch:
        train-mode BatchNorm then takes the global batch's statistics, and
        the dropout masks are the global batch's when ``generator`` comes
        from a :class:`~mgnns_tpu_torch.nn.core.SiteGenerators` with the
        same axis (the engine's).
    Returns:
      (logits [B, num_labels], new_batch_stats, aux); ``aux`` holds
      ``head_diversity`` (the image->text stacks' mean over the batch) when
      ``cfg.is_regu``.  Under an axis of N ranks it is this rank's share of
      the global batch's mean, the rank's mean over N: the shares sum to it
      over the ranks, as the loss's do.
    """
    rngs = RngStream(generator)
    new_stats: dict = {}
    aux: dict = {}
    with record_function("mgnns.text_gcn"):
        text_feature = text_gcn.text_gcn_apply(
            params["text_gcn"], batch["ids"], batch["lens"], batch["eids"],
            ngram=(batch["eids"].shape[-1] - 1) // 2, dropout_rate=cfg.text_dropout,
            train=train, generator=rngs.next("text_gcn"))          # [B, 300]
    with record_function("mgnns.lstm"):
        emb = embedding(params["embedding"]["table"], batch["ids"])
        text_memory_bank, _ = lstm.lstm_apply(
            params["lstm"], emb, batch["lens"], dropout_rate=cfg.dropout, train=train,
            generator=rngs.next("lstm"))                            # [B, L, 300]

    image = normalize_image_batch(batch["image"], cfg.cdtype)
    with record_function("mgnns.object_channel"):
        obj_bank, obj_vec, new_stats["object_trunk"] = _image_channel(
            params, batch_stats, consts, image, side="object", cfg=cfg, train=train, rngs=rngs,
            axis=axis)
    with record_function("mgnns.place_channel"):
        plc_bank, plc_vec, new_stats["place_trunk"] = _image_channel(
            params, batch_stats, consts, image, side="place", cfg=cfg, train=train, rngs=rngs,
            axis=axis)

    head_diffs: list = []

    def run_stack(name, q, kv, mask, tag, is_regu=False):
        for i, blk in enumerate(params[name]):
            res = attention.my_mha_apply(blk, q, kv, kv, mask, n_head=cfg.n_head, d_kv=cfg.d_kv,
                                         dropout_rate=cfg.dropout, train=train,
                                         generator=rngs.next(f"{tag}{i}"), is_regu=is_regu)
            q = res[0]
            if is_regu:
                head_diffs.append(res[2])
        return q

    # the image->text stacks carry the head-diversity regularizer when
    # cfg.is_regu (reference :198-199,:225-226); the text->image ones never do
    mask = batch["mask"]
    with record_function("mgnns.fusion"):
        img_object_text = run_stack("img_object_text_mha", obj_vec, text_memory_bank, mask,
                                    "iot", cfg.is_regu)
        img_place_text = run_stack("img_place_text_mha", plc_vec, text_memory_bank, mask,
                                   "ipt", cfg.is_regu)
        text_img_object = run_stack("text_img_object_mha", text_feature, obj_bank, None, "tio")
        text_img_place = run_stack("text_img_place_mha", text_feature, plc_bank, None, "tip")
        if head_diffs:
            aux["head_diversity"] = torch.stack(head_diffs).mean()
            if axis is not None and axis.size > 1:
                aux["head_diversity"] = aux["head_diversity"] / axis.size
        multi = torch.cat([text_img_object, text_img_place, img_object_text, img_place_text],
                          dim=1)                                    # [B, 1200]
        multi = linear(params["multi_linear_1"], multi)
        multi = dropout(multi, cfg.dropout, rngs.next("classifier"), train)
        logits = linear(params["multi_linear_2"], multi)
    return logits, new_stats, aux
