"""Additive co-attention over text, object and place features.

Port of the JAX package's ``mgnns_tpu/nn/coattention.py`` (reference
``models/moudles.py:51-196``, ``CoAttention``), a block the reference builds
but its fusion model never runs, with the reference's ``masked_mean`` /
``masked_max`` / ``MaskedSoftmax`` helpers (``moudles.py:9-49``):

- text->image scores ``v^T tanh(project(img_feats) + project(text_feat))``
  per image region, softmax over regions, context = weighted sum;
- image->text scores the same way, with the text mask applied by the
  renormalizing masked softmax;
- output = linear(concat of the four contexts), then dropout.
"""

from __future__ import annotations

import torch

from mgnns_tpu_torch.nn.core import dropout, linear, linear_init


def masked_mean(x: torch.Tensor, mask: torch.Tensor | None = None, dim: int = 1) -> torch.Tensor:
    """Mean over ``dim`` counting only rows whose mask is 1."""
    if mask is None:
        return x.mean(dim=dim)
    m = mask[..., None]
    return (x * m).sum(dim=dim) / torch.clamp(m.sum(dim=dim), min=1e-12)


def masked_max(x: torch.Tensor, mask: torch.Tensor | None = None, dim: int = 1) -> torch.Tensor:
    """Max over ``dim`` with masked rows at -inf."""
    if mask is None:
        return x.amax(dim=dim)
    m = mask[..., None]
    return torch.where(m == 0.0, float("-inf"), x).amax(dim=dim)


def masked_softmax(logit: torch.Tensor, mask: torch.Tensor | None = None,
                   dim: int = 1) -> torch.Tensor:
    """Softmax, then mask, then renormalize (the reference's
    ``MaskedSoftmax``), which differs from masking the logits."""
    dist = torch.softmax(logit - logit.amax(dim=dim, keepdim=True), dim=dim)
    if mask is None:
        return dist
    dist = dist * mask
    return dist / torch.clamp(dist.sum(dim=dim, keepdim=True), min=1e-12)


def coattention_init(g: torch.Generator, text_feat_size: int, img_object_feat_size: int,
                     img_place_feat_size: int) -> dict:
    T, O, P = text_feat_size, img_object_feat_size, img_place_feat_size
    return {
        "v_text_object": linear_init(g, T, 1, bias=False),
        "v_text_place": linear_init(g, T, 1, bias=False),
        "v_img_object": linear_init(g, O, 1, bias=False),
        "v_img_place": linear_init(g, P, 1, bias=False),
        "text2img_object_project": linear_init(g, T, O, bias=False),
        "text2img_place_project": linear_init(g, T, P, bias=False),
        "img_object2text_project": linear_init(g, O, T, bias=False),
        "img_place2text_project": linear_init(g, P, T, bias=False),
        "img_object_project": linear_init(g, O, O),
        "img_place_project": linear_init(g, P, P),
        "text_object_project": linear_init(g, T, T),
        "text_place_project": linear_init(g, T, T),
        "linear": linear_init(g, 2 * T + O + P, T),
    }


def _text_att_scores(p, text_feat, img_feats, img_type):
    """[B, img_num] additive scores (reference ``:81-110``)."""
    img_proj = linear(p[f"img_{img_type}2text_project"], img_feats)
    text_proj = linear(p[f"text_{img_type}_project"], text_feat)[:, None, :]
    return linear(p[f"v_text_{img_type}"], torch.tanh(img_proj + text_proj))[..., 0]


def _img_att_scores(p, img_feat, text_feats, img_type):
    """[B, max_src_len] additive scores (reference ``:112-139``)."""
    text_proj = linear(p[f"text2img_{img_type}_project"], text_feats)
    img_proj = linear(p[f"img_{img_type}_project"], img_feat)[:, None, :]
    return linear(p[f"v_img_{img_type}"], torch.tanh(text_proj + img_proj))[..., 0]


def coattention_apply(
    p: dict,
    text_feat: torch.Tensor,         # [B, T]
    text_feats: torch.Tensor,        # [B, L, T]
    img_object_feat: torch.Tensor,   # [B, O]
    img_object_feats: torch.Tensor,  # [B, N_o, O]
    img_place_feat: torch.Tensor,    # [B, P]
    img_place_feats: torch.Tensor,   # [B, N_p, P]
    src_mask: torch.Tensor,          # [B, L] float
    *,
    dropout_rate: float = 0.5,
    train: bool = False,
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """The combined [B, T] representation (reference ``:141-196``)."""
    to_dist = masked_softmax(_text_att_scores(p, text_feat, img_object_feats, "object"))
    img_object_context = torch.einsum("bn,bnd->bd", to_dist, img_object_feats)
    tp_dist = masked_softmax(_text_att_scores(p, text_feat, img_place_feats, "place"))
    img_place_context = torch.einsum("bn,bnd->bd", tp_dist, img_place_feats)
    ot_dist = masked_softmax(_img_att_scores(p, img_object_feat, text_feats, "object"), src_mask)
    text_object_context = torch.einsum("bl,bld->bd", ot_dist, text_feats)
    pt_dist = masked_softmax(_img_att_scores(p, img_place_feat, text_feats, "place"), src_mask)
    text_place_context = torch.einsum("bl,bld->bd", pt_dist, text_feats)
    combined = torch.cat([img_object_context, img_place_context, text_object_context,
                          text_place_context], dim=1)
    return dropout(linear(p["linear"], combined), dropout_rate, generator, train)
