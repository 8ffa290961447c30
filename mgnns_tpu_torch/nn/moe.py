"""A ``deepseek_v3`` decoder stack as the fusion model's text encoder:
latent attention (MLA), one dense SiLU MLP layer, then mixture-of-experts
layers with sigmoid routing and shared experts (Moonlight-16B-A3B's block,
https://huggingface.co/moonshotai/Moonlight-16B-A3B).

Layer ``i`` on the residual stream ``x`` (float32):

- ``h = x + MLA(RMSNorm(x))``;
- layer 0 (and every layer below ``first_dense``): ``h + MLP(RMSNorm(h))``;
- the others: ``n = RMSNorm(h)``, ``h + shared(n) + sum_{e in top_k(n)
  and held} w_e * expert_e(n)``.

MLA, without a query low rank: ``q = n Wq`` as ``H`` heads of ``nope +
rope`` columns; ``[c, k_pe] = n Wkv_a``, ``[k_nope, v] = RMSNorm(c) Wkv_b``
per head; ``k_pe`` (one for all heads) and each head's ``q_pe`` are turned
by RoPE in the ``deepseek_v3`` layout (each vector's interleaved pairs
first gathered into halves); scores ``[q_nope, q_pe] . [k_nope, k_pe] /
sqrt(nope + rope)``, causal over positions 0..L-1 of each row; the heads'
``softmax @ v`` through ``Wo``.  An MLP is ``(silu(n W1) * n W3) W2``, with
``W1`` and ``W3`` side by side in one ``w13`` leaf.

Routing, in float32: ``s = sigmoid(n Wr)`` over all ``n_routed_experts``;
the ``k`` experts of the largest ``s + e_score_correction_bias`` (the
``noaux_tc`` choice with one group); their weights are ``s`` without the
bias, normalised to sum 1 (``norm_topk_prob``) and times
``routed_scaling_factor``.  The bias takes no gradient and the optimizer
leaves it as it is.

Expert parallelism: the layer is told which experts this chip holds
(``experts_held``) and computes their part of the sum alone; the experts'
leaves are stacked ``[held, ...]``.  Every token is routed over all the
experts, no token is dropped, and nothing stands in for the experts held
elsewhere.  The dispatch stays on the device: each (token, choice) slot's
place in a buffer of the held experts' rows, grouped by expert and padded
to :func:`~mgnns_tpu_torch.kernels.grouped_mm.row_align` rows a group, comes
from a stable sort and per-expert counts; each projection is one grouped
product over the groups' offsets; the combine gathers each slot's row back.
The buffer holds the most rows the routing can send here (every token's
choices among the held experts, ``B * L * min(k, held)``), so its shape is
fixed and the step can be captured.  Gathers with a fixed order of sums
replace scatters with atomic adds, so that a replay gives the same bits as
an eager step.

Products run in ``dtype`` (bf16 in the benchmark's cells) with float32
accumulation; the residual stream, the norms, the softmax, the router and
the combine are float32.  The forward is four kinds of
:func:`~mgnns_tpu_torch.tracing.stage` (``encoder.attention``,
``.routing``, ``.experts``, ``.mlp``), none inside another, each output
passing a :func:`~mgnns_tpu_torch.tracing.grad_mark`.  Given counts of
:func:`token_counts`, which its caller makes before a step is captured and
owns, the forward adds the tokens each held expert gets to them:
``moe.tokens`` (since they were zeroed) and ``moe.last_tokens`` (the last
forward's), ``[MoE layers, held]`` each.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from mgnns_tpu_torch import tracing
from mgnns_tpu_torch.config import MoeEncoderConfig
from mgnns_tpu_torch.kernels import grouped_mm as K
from mgnns_tpu_torch.nn.core import linear, linear_init, normal

INIT_STD = 0.02


# ---------------------------------------------------------------------------
# Parameters


def _mlp_init(g, d: int, width: int, lead: tuple = ()) -> dict:
    return {"w13": normal(g, (*lead, d, 2 * width), INIT_STD),
            "w2": normal(g, (*lead, width, d), INIT_STD)}


def encoder_init(g: torch.Generator, cfg: MoeEncoderConfig, out_dim: int) -> dict:
    """Seeded weights: normal(0, 0.02) linears, router and correction bias,
    RMSNorm weights 1, and a ``torch``-initialised projection to
    ``out_dim``."""
    d, H = cfg.hidden_size, cfg.num_heads
    dev = g.device
    layers = []
    for i in range(cfg.num_layers):
        layer = {"attn_norm": torch.ones(d, device=dev),
                 "attn": {"q": normal(g, (d, H * cfg.qk_head_dim), INIT_STD),
                          "kv_a": normal(g, (d, cfg.kv_lora_rank + cfg.qk_rope_head_dim),
                                         INIT_STD),
                          "kv_norm": torch.ones(cfg.kv_lora_rank, device=dev),
                          "kv_b": normal(g, (cfg.kv_lora_rank,
                                             H * (cfg.qk_nope_head_dim + cfg.v_head_dim)),
                                         INIT_STD),
                          "o": normal(g, (H * cfg.v_head_dim, d), INIT_STD)},
                 "mlp_norm": torch.ones(d, device=dev)}
        if i < cfg.first_dense:
            layer["mlp"] = _mlp_init(g, d, cfg.intermediate_size)
        else:
            layer["router"] = {"w": normal(g, (d, cfg.n_routed_experts), INIT_STD),
                               "bias": normal(g, (cfg.n_routed_experts,), INIT_STD)}
            layer["shared"] = _mlp_init(g, d, cfg.n_shared_experts * cfg.moe_intermediate_size)
            layer["experts"] = _mlp_init(g, d, cfg.moe_intermediate_size,
                                         (len(cfg.experts_held),))
        layers.append(layer)
    return {"embed": normal(g, (cfg.vocab_rows, d), INIT_STD), "layers": layers,
            "norm": torch.ones(d, device=dev), "proj": linear_init(g, d, out_dim)}


def frozen_leaf(path: str) -> bool:
    """Whether the encoder's leaf at ``path`` (``/``-joined below the
    encoder) is never trained: the routers' correction biases."""
    return path.endswith("router/bias")


# ---------------------------------------------------------------------------
# Pieces


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    x = x.float()
    return w * (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps))


def _mm(x: torch.Tensor, w: torch.Tensor, dtype) -> torch.Tensor:
    return x.to(dtype) @ w.to(dtype)


def mlp(p: dict, x: torch.Tensor, dtype) -> torch.Tensor:
    gate, up = _mm(x, p["w13"], dtype).chunk(2, dim=-1)
    return _mm(F.silu(gate) * up, p["w2"], dtype)


def rope_tables(L: int, dim: int, theta: float, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) ``[L, dim]`` of positions 0..L-1, each frequency twice
    (made on the device: a captured step may not copy from the host)."""
    inv = 1.0 / theta ** (torch.arange(0, dim, 2, device=device, dtype=torch.float32) / dim)
    freqs = torch.arange(L, device=device, dtype=torch.float32)[:, None] * inv[None, :]
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos(), emb.sin()


def rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """``deepseek_v3``'s rotary embedding of ``x [B, L, heads, dim]``: the
    pairs ``(x[2i], x[2i+1])`` gathered into halves, then rotated."""
    B, L, Hh, d = x.shape
    x = x.float().reshape(B, L, Hh, d // 2, 2).transpose(3, 4).reshape(B, L, Hh, d)
    half = torch.cat([-x[..., d // 2:], x[..., :d // 2]], dim=-1)
    return x * cos[None, :, None, :] + half * sin[None, :, None, :]


def mla(p: dict, x: torch.Tensor, cfg: MoeEncoderConfig, dtype, rope_cs: tuple,
        causal: torch.Tensor) -> torch.Tensor:
    """Latent attention of normed ``x [B, L, d]``, causal (``causal [L, L]``
    true above the diagonal; ``rope_cs``: :func:`rope_tables`): ``[B, L, d]``."""
    B, L, _ = x.shape
    H, dn, dr, dv = cfg.num_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    q = _mm(x, p["q"], dtype).view(B, L, H, dn + dr)
    c, k_pe = _mm(x, p["kv_a"], dtype).split([cfg.kv_lora_rank, dr], dim=-1)
    kv = _mm(rms_norm(c, p["kv_norm"], cfg.rms_norm_eps), p["kv_b"], dtype).view(B, L, H, dn + dv)
    k_nope, v = kv.split([dn, dv], dim=-1)
    cos, sin = rope_cs
    q_pe = rope(q[..., dn:], cos, sin).to(dtype)
    k_pe = rope(k_pe.reshape(B, L, 1, dr), cos, sin).to(dtype).expand(B, L, H, dr)
    qh = torch.cat([q[..., :dn], q_pe], dim=-1).transpose(1, 2)           # [B, H, L, dn+dr]
    kh = torch.cat([k_nope, k_pe], dim=-1).transpose(1, 2)
    scores = (qh @ kh.transpose(-1, -2)).float() / math.sqrt(dn + dr)      # [B, H, L, L]
    probs = torch.softmax(scores.masked_fill(causal, float("-inf")), dim=-1)
    out = (probs.to(dtype) @ v.transpose(1, 2).to(dtype)).transpose(1, 2)  # [B, L, H, dv]
    return _mm(out.reshape(B, L, H * dv), p["o"], dtype)


def route(p: dict, n: torch.Tensor, cfg: MoeEncoderConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """(experts chosen ``[T, k]``, their weights ``[T, k]``) of normed
    tokens ``n [T, d]``, in float32."""
    scores = torch.sigmoid(n.float() @ p["w"].float())
    chosen = torch.topk(scores.detach() + p["bias"].detach(), cfg.num_experts_per_tok,
                        dim=-1).indices
    w = scores.gather(1, chosen)
    if cfg.norm_topk_prob:
        w = w / (w.sum(dim=-1, keepdim=True) + 1e-20)
    # each token's choices in the order of the experts' ids, so that the
    # combine adds the experts' parts in a fixed order
    chosen, order = chosen.sort(dim=-1)
    return chosen, w.gather(1, order) * cfg.routed_scaling_factor


class Dispatch:
    """Where each (token, choice) slot goes in the held experts' buffer:
    ``pos [T, k]`` (``rows`` for a slot whose expert is held elsewhere),
    ``src [rows]`` (the token each buffer row holds, ``T`` for a row that
    holds none), the groups' end offsets ``offs [held]`` (int32, each
    group padded to ``align`` rows) and the routed tokens ``counts
    [held]``."""

    def __init__(self, chosen: torch.Tensor, local_of: torch.Tensor, G: int, align: int):
        """``local_of [n_experts]``: each expert's place among the ``G``
        held ones, ``G`` for an expert held elsewhere (:func:`local_map`)."""
        T, k = chosen.shape
        dev = chosen.device
        self.rows = rows = T * min(k, G) + G * (align - 1)
        local = local_of[chosen].view(-1)                               # [T*k], G: elsewhere
        ones = torch.ones_like(local)
        counts = torch.zeros(G + 1, dtype=torch.int64, device=dev).index_add_(0, local, ones)
        self.counts = counts[:G]
        padded = (self.counts + align - 1) // align * align
        ends = torch.cumsum(padded, 0)
        self.offs = ends.to(torch.int32)
        starts = torch.cat([ends - padded, ends.new_full((1,), rows)])  # group G: the dump row
        order = torch.sort(local, stable=True).indices
        first = torch.cumsum(counts, 0) - counts                        # each group's first slot
        s_local = local[order]
        rank = torch.arange(T * k, device=dev) - first[s_local]
        s_pos = torch.where(s_local < G, starts[s_local] + rank, rows)
        pos = torch.empty_like(s_pos).index_put_((order,), s_pos)
        self.pos = pos.view(T, k)
        self.held = (local < G).view(T, k)
        token = torch.arange(T * k, device=dev) // k
        self.src = torch.full((rows + 1,), T, dtype=torch.int64, device=dev).index_put_(
            (pos,), token)[:rows]


def local_map(held: tuple[int, ...], n_experts: int, device) -> torch.Tensor:
    """``[n_experts]``: each held expert's place in ``held``, ``len(held)``
    for the others (fills on the device, no copy from the host)."""
    m = torch.full((n_experts,), len(held), dtype=torch.int64, device=device)
    for i, e in enumerate(held):
        m[e].fill_(i)  # a fill: item assignment would copy a scalar from the host
    return m


class _Gather(torch.autograd.Function):
    """``x`` with a zero row appended, at rows ``src``; the gradient of a row
    of ``x`` is the sum of its slots' rows ``pos [T, k]`` in a fixed order,
    with no atomic adds."""

    @staticmethod
    def forward(ctx, x, src, pos):
        ctx.save_for_backward(pos)
        return torch.cat([x, x.new_zeros(1, x.shape[1])])[src]

    @staticmethod
    def backward(ctx, g):
        pos, = ctx.saved_tensors
        return torch.cat([g, g.new_zeros(1, g.shape[1])])[pos].sum(dim=1), None, None


class _Combine(torch.autograd.Function):
    """Each token's weighted sum of its slots' rows ``y[pos]`` (a row
    ``rows`` past the end reads zeros), in float32, the slots added one
    after another in their order (the experts' ids).  It saves ``y`` and
    the weights, not a gathered copy; the backward puts each slot's
    gradient in its own row (every held slot has a row of its own) and
    reads each weight's gradient back with a gather."""

    @staticmethod
    def forward(ctx, y, w, pos):
        ctx.save_for_backward(y, w, pos)
        out = y.new_zeros(pos.shape[0], y.shape[1], dtype=torch.float32)
        for j in range(pos.shape[1]):
            out = out + _rows(y, pos[:, j]).float() * w[:, j, None]
        return out

    @staticmethod
    def backward(ctx, g):
        y, w, pos = ctx.saved_tensors
        dy = y.new_zeros(y.shape[0] + 1, y.shape[1])
        dy[pos.view(-1)] = (w[..., None] * g[:, None, :]).to(y.dtype).view(-1, y.shape[1])
        dw = (_rows(y, pos).float() * g[:, None, :]).sum(dim=-1)
        return dy[:-1], dw, None


def _rows(y: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    return torch.cat([y, y.new_zeros(1, y.shape[1])])[pos]


def experts(p: dict, n: torch.Tensor, w: torch.Tensor, disp: Dispatch, dtype) -> torch.Tensor:
    """The held experts' weighted sum for normed tokens ``n [T, d]``:
    ``[T, d]`` float32."""
    x = _Gather.apply(n.to(dtype), disp.src, disp.pos)                  # [rows, d]
    gate, up = torch.ops.mgnns.grouped_mm(x, p["w13"].to(dtype), disp.offs).chunk(2, dim=-1)
    y = torch.ops.mgnns.grouped_mm((F.silu(gate) * up).contiguous(), p["w2"].to(dtype),
                                   disp.offs)
    return _Combine.apply(y, torch.where(disp.held, w, 0.0), disp.pos)


def token_counts(cfg: MoeEncoderConfig, device) -> torch.Tensor:
    """Zero int64 counts ``[2, MoE layers, held]`` for :func:`encoder_apply`:
    ``[0]`` the tokens each held expert got since they were zeroed
    (``moe.tokens``), ``[1]`` those of the last forward
    (``moe.last_tokens``).  A captured step adds to them at their address,
    so they are made before the capture and live as long as its graph."""
    return torch.zeros(2, cfg.num_layers - cfg.first_dense, len(cfg.experts_held),
                       dtype=torch.int64, device=device)


def _count(counts: torch.Tensor, disp: Dispatch) -> None:
    """Add a layer's routed tokens to its ``counts [2, held]``."""
    counts[0].add_(disp.counts)
    counts[1].copy_(disp.counts)


# ---------------------------------------------------------------------------
# The stack


def encoder_apply(p: dict, ids: torch.Tensor, cfg: MoeEncoderConfig, dtype,
                  counts: torch.Tensor | None = None) -> torch.Tensor:
    """``ids [B, L]`` (rows of the embedding slice) -> ``[B, L, out_dim]``
    float32: the stack, its final RMSNorm and the projection.  ``counts``
    (:func:`token_counts`) take the routed tokens when given."""
    B, L = ids.shape
    d, eps = cfg.hidden_size, cfg.rms_norm_eps
    align = K.row_align(dtype)
    G = len(cfg.experts_held)
    want = (2, cfg.num_layers - cfg.first_dense, G)
    if counts is not None and (tuple(counts.shape) != want or counts.dtype != torch.int64):
        raise ValueError(f"token counts of {counts.dtype} {tuple(counts.shape)}, this encoder's "
                         f"are int64 {want} (moe.token_counts)")
    rope_cs = rope_tables(L, cfg.qk_rope_head_dim, cfg.rope_theta, ids.device)
    causal = torch.ones(L, L, dtype=torch.bool, device=ids.device).triu(1)
    local_of = local_map(cfg.experts_held, cfg.n_routed_experts, ids.device)
    h = None
    for i, lp in enumerate(p["layers"]):
        with tracing.stage("encoder.attention"):
            x = p["embed"][ids] if i == 0 else h
            h = tracing.grad_mark(x + mla(lp["attn"], rms_norm(x, lp["attn_norm"], eps), cfg,
                                          dtype, rope_cs, causal).float(), "encoder.attention")
        if i < cfg.first_dense:
            with tracing.stage("encoder.mlp"):
                h = h + mlp(lp["mlp"], rms_norm(h, lp["mlp_norm"], eps), dtype).float()
                h = _tail(p, h, i, cfg)
            continue
        with tracing.stage("encoder.routing"):
            n = rms_norm(h, lp["mlp_norm"], eps).view(B * L, d)
            chosen, w = route(lp["router"], n, cfg)
            disp = Dispatch(chosen, local_of, G, align)
            if counts is not None:
                _count(counts[:, i - cfg.first_dense], disp)
            n, w = tracing.grad_mark((n, w), "encoder.routing")
        with tracing.stage("encoder.experts"):
            routed = tracing.grad_mark(experts(lp["experts"], n, w, disp, dtype),
                                       "encoder.experts")
        with tracing.stage("encoder.mlp"):
            h = h + (mlp(lp["shared"], n, dtype).float() + routed).view(B, L, d)
            h = _tail(p, h, i, cfg)
    return h


def _tail(p: dict, h: torch.Tensor, i: int, cfg: MoeEncoderConfig) -> torch.Tensor:
    """After the last layer the final norm and the projection; the stage's
    gradient mark either way."""
    if i == cfg.num_layers - 1:
        h = linear(p["proj"], rms_norm(h, p["norm"], cfg.rms_norm_eps))
    return tracing.grad_mark(h, "encoder.mlp")
