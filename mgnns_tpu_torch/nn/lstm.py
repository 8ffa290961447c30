"""Masked multi-layer bidirectional LSTM.

Port of the JAX package's ``mgnns_tpu/nn/lstm.py:lstm_apply``, the
replacement of the reference's ``pack_padded_sequence -> nn.LSTM ->
pad_packed_sequence`` text encoder (reference
``models/Multi_GCN_Multihead_att.py:366-398``):

- at padded steps the carry is held and the output is zero, which is what
  pad_packed produces;
- the backward direction walks from the end of the padded buffer but only
  starts updating at the last valid token, so its final state is torch's;
- gate order (i, f, g, o); outputs concat as (fwd, bwd);
- in train mode, dropout on every layer's output except the last, like
  ``nn.LSTM(dropout=...)``.

Weights keep the JAX package's input-major layout (``w_ih [D_l, 4H]``,
``w_hh [H, 4H]``): the step loop below uses them as they are.  The input
projection of a whole sequence is one matmul; the recurrence is a Python
loop over the L steps whose outputs are stacked once at the end (no
in-place writes for autograd to track).
"""

from __future__ import annotations

import math

import torch

from mgnns_tpu_torch.nn.core import RngStream, dropout, uniform


def lstm_init(g: torch.Generator, input_size: int, hidden_size: int,
              num_layers: int = 2, bidirectional: bool = True) -> dict:
    """``layers[l][dir]`` with w_ih [D_l, 4H], w_hh [H, 4H], b_ih, b_hh [4H],
    U(+-1/sqrt(H)) like ``nn.LSTM``."""
    dirs = 2 if bidirectional else 1
    bound = 1.0 / math.sqrt(hidden_size)
    H4 = 4 * hidden_size
    layers = []
    for l in range(num_layers):
        d_in = input_size if l == 0 else hidden_size * dirs
        layers.append([{
            "w_ih": uniform(g, (d_in, H4), bound),
            "w_hh": uniform(g, (hidden_size, H4), bound),
            "b_ih": uniform(g, (H4,), bound),
            "b_hh": uniform(g, (H4,), bound),
        } for _ in range(dirs)])
    return {"layers": layers}


def _run_direction(p: dict, x: torch.Tensor, step_valid: torch.Tensor, reverse: bool):
    """One direction over [B, L, D]; ``step_valid`` [L, B, 1] bool.
    Returns (outputs [B, L, H], h_T, c_T)."""
    B, L, _ = x.shape
    H = p["w_hh"].shape[0]
    xw = x @ p["w_ih"] + p["b_ih"]        # [B, L, 4H], one matmul
    h = x.new_zeros(B, H)
    c = x.new_zeros(B, H)
    outs = [None] * L
    for t in (range(L - 1, -1, -1) if reverse else range(L)):
        gates = xw[:, t, :] + h @ p["w_hh"] + p["b_hh"]
        i, f, gg, o = gates.chunk(4, dim=1)
        c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(gg)
        h_new = torch.sigmoid(o) * torch.tanh(c_new)
        upd = step_valid[t]
        h = torch.where(upd, h_new, h)
        c = torch.where(upd, c_new, c)
        outs[t] = torch.where(upd, h, 0.0)
    return torch.stack(outs, dim=1), h, c


def lstm_apply(params: dict, x: torch.Tensor, lens: torch.Tensor, *, dropout_rate: float = 0.0,
               train: bool = False, generator: torch.Generator | None = None):
    """Returns (memory_bank [B, L, dirs*H], (h_final, c_final)) where
    h_final/c_final are [num_layers*dirs, B, H] in torch layout
    (l0_fwd, l0_bwd, l1_fwd, l1_bwd, ...)."""
    rngs = RngStream(generator)
    num_layers = len(params["layers"])
    L = x.shape[1]
    step_valid = (torch.arange(L, device=x.device)[:, None] < lens[None, :])[:, :, None]
    h_finals, c_finals = [], []
    out = x
    for l, dir_params in enumerate(params["layers"]):
        feats = []
        for d, p in enumerate(dir_params):
            o, hT, cT = _run_direction(p, out, step_valid, reverse=(d == 1))
            feats.append(o)
            h_finals.append(hT)
            c_finals.append(cT)
        out = torch.cat(feats, dim=-1) if len(feats) > 1 else feats[0]
        if l < num_layers - 1:
            out = dropout(out, dropout_rate, rngs.next(f"lstm_l{l}"), train)
    return out, (torch.stack(h_finals), torch.stack(c_finals))
