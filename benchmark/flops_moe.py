"""Closed forms of the MoE text encoder's work: the FLOPs of a train step of
the fusion model with the encoder, and the routed experts' least time.

FLOPs count 2 per multiply-add of every product, as :mod:`benchmark.flops`
does, over every position of every row (the encoder computes the padded
ones too), and for the routed experts over the tokens the routing sent to
the experts this chip holds (``tokens[layer][expert]``, the program's
``moe.tokens`` per step, or the reference's counts).  A train step's
backward takes the input's and the weight's gradient of each product (the
embedding's gather counts nothing).  Attention counts its full ``L x L``
scores and their ``@ v`` per head, as the program computes them under the
causal mask.
"""

from __future__ import annotations

from benchmark import flops as F


def _enc(cfg: dict) -> dict:
    return {"d": cfg["hidden_size"], "H": cfg["num_attention_heads"],
            "dn": cfg["qk_nope_head_dim"], "dr": cfg["qk_rope_head_dim"],
            "dv": cfg["v_head_dim"], "r": cfg["kv_lora_rank"],
            "dense": cfg["intermediate_size"], "moe": cfg["moe_intermediate_size"],
            "shared": cfg["n_shared_experts"] * cfg["moe_intermediate_size"],
            "E": cfg["n_routed_experts"], "layers": cfg["num_hidden_layers"],
            "first": cfg["first_k_dense_replace"]}


def encoder_forward_flops(cfg: dict, B: int, L: int, tokens) -> int:
    """FLOPs of the encoder's forward on ``B`` rows of ``L`` positions;
    ``tokens``: per MoE layer, the tokens each held expert got."""
    e = _enc(cfg)
    d, H, T = e["d"], e["H"], B * L
    attn = 2 * T * (d * H * (e["dn"] + e["dr"]) + d * (e["r"] + e["dr"])
                    + e["r"] * H * (e["dn"] + e["dv"]) + H * e["dv"] * d)
    attn += 2 * B * H * L * L * (e["dn"] + e["dr"] + e["dv"])
    total = e["layers"] * attn
    total += e["first"] * 2 * T * 3 * d * e["dense"]
    n_moe = e["layers"] - e["first"]
    total += n_moe * 2 * T * (d * e["E"] + 3 * d * e["shared"])
    total += routed_forward_flops(cfg, tokens)
    total += 2 * T * d * cfg["fusion"]["hidden_size"] * 2  # the projection to the bank
    return int(total)


def routed_forward_flops(cfg: dict, tokens) -> int:
    """FLOPs of the held experts' products in the forward: three of
    ``d x moe`` per routed token."""
    e = _enc(cfg)
    return int(2 * 3 * e["d"] * e["moe"] * sum(sum(row) for row in tokens))


def routed_least_seconds(cfg: dict, tokens, bytes_per: int = 2) -> float:
    """Least time of the held experts' products in a train step: the larger
    of their FLOPs (forward, and the input's and weight's gradients) over
    the bf16 peak, and their bytes over the HBM bandwidth.  Bytes: each
    held expert's weights read by the forward and by the input's gradient
    and its weight gradient written, and every product's rows read and
    written once a pass (inputs, the gate and up outputs, the activation,
    the outputs)."""
    e = _enc(cfg)
    n_moe = e["layers"] - e["first"]
    held = len(tokens[0]) if tokens else 0
    weights = n_moe * held * 3 * e["d"] * e["moe"] * bytes_per
    rows = sum(sum(row) for row in tokens)
    acts = rows * (e["d"] + 2 * e["moe"] + e["moe"] + e["d"]) * bytes_per
    nbytes = 3 * weights + 3 * acts
    flops = 3 * routed_forward_flops(cfg, tokens)
    return max(flops / F.PEAK_FLOPS["bfloat16"], nbytes / F.HBM_BYTES_PER_S)


def fusion_flops(cfg: dict, B: int) -> int:
    """FLOPs of a train step of the fusion model around the encoder: its
    configuration's closed form without the BiLSTM."""
    return F.train_step_flops(dict(cfg["fusion"], num_layers=0), B)


def train_step_flops(cfg: dict, B: int, L: int, tokens) -> int:
    """FLOPs of one train step of the fusion model with the encoder."""
    return fusion_flops(cfg, B) + 3 * encoder_forward_flops(cfg, B, L, tokens)
