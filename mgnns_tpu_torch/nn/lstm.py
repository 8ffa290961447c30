"""Masked multi-layer bidirectional LSTM, and the GRU of the same form.

Port of the JAX package's ``mgnns_tpu/nn/lstm.py``.  :func:`lstm_apply` is the
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
``w_hh [H, 4H]``).  A layer projects the input of each direction with one
matmul over the whole sequence (``x @ w_ih + b_ih``), then runs the
recurrence, one operator for all directions
(:func:`mgnns_tpu_torch.kernels.lstm.lstm_layer`): on the card one
persistent kernel a layer forward and one backward, on the CPU the plain
versions below, :func:`lstm_layer_plain` (the step loop, whose outputs are
stacked once at the end) and :func:`lstm_layer_backward_plain` (the reverse
recurrence of the gates' gradient).

:func:`gru_init` / :func:`gru_apply` are the GRU the reference builds as
``self.rnn`` but never calls (``Multi_GCN_Multihead_att.py:172-177``): its
weights sit in every reference checkpoint, so the port carries them for
``state_dict`` interop.  Same layouts (``w_ih [D_l, 3H]``, gate order r, z,
n), masking and output order as the LSTM; torch's candidate gate applies the
reset gate to the hidden projection, ``n = tanh(x_n + r * (h @ W_hn + b_hn))``.
"""

from __future__ import annotations

import math

import torch

from mgnns_tpu_torch.kernels import lstm as lstm_kernel
from mgnns_tpu_torch.nn.core import RngStream, dropout, uniform


def lstm_init(g: torch.Generator, input_size: int, hidden_size: int,
              num_layers: int = 2, bidirectional: bool = True) -> dict:
    """``layers[l][dir]`` with w_ih [D_l, 4H], w_hh [H, 4H], b_ih, b_hh [4H],
    U(+-1/sqrt(H)) like ``nn.LSTM``."""
    return _rnn_init(g, input_size, hidden_size, num_layers, bidirectional, 4)


def _rnn_init(g: torch.Generator, input_size: int, hidden_size: int, num_layers: int,
              bidirectional: bool, gates: int) -> dict:
    dirs = 2 if bidirectional else 1
    bound = 1.0 / math.sqrt(hidden_size)
    G = gates * hidden_size
    layers = []
    for l in range(num_layers):
        d_in = input_size if l == 0 else hidden_size * dirs
        layers.append([{
            "w_ih": uniform(g, (d_in, G), bound),
            "w_hh": uniform(g, (hidden_size, G), bound),
            "b_ih": uniform(g, (G,), bound),
            "b_hh": uniform(g, (G,), bound),
        } for _ in range(dirs)])
    return {"layers": layers}


def _step_valid(x: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """[L, B, 1] bool: step t of document b is a real token."""
    L = x.shape[1]
    return (torch.arange(L, device=x.device)[:, None] < lens[None, :])[:, :, None]


def _run_direction(xw: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor,
                   step_valid: torch.Tensor, reverse: bool):
    """One direction over its input projection xw [B, L, 4H] (``x @ w_ih +
    b_ih``); ``step_valid`` [L, B, 1] bool.  Returns (outputs [B, L, H], h_T,
    c_T, gates [B, L, 4H], cells [B, L, H]): the post-activation gates and
    the cell state of every step, 0 where the carry is held."""
    B, L, _ = xw.shape
    H = w_hh.shape[0]
    h = xw.new_zeros(B, H)
    c = xw.new_zeros(B, H)
    outs, gates, cells = [None] * L, [None] * L, [None] * L
    for t in (range(L - 1, -1, -1) if reverse else range(L)):
        i, f, gg, o = (xw[:, t, :] + h @ w_hh + b_hh).chunk(4, dim=1)
        i, f, gg, o = torch.sigmoid(i), torch.sigmoid(f), torch.tanh(gg), torch.sigmoid(o)
        c_new = f * c + i * gg
        h_new = o * torch.tanh(c_new)
        upd = step_valid[t]
        h = torch.where(upd, h_new, h)
        c = torch.where(upd, c_new, c)
        outs[t] = torch.where(upd, h, 0.0)
        gates[t] = torch.where(upd, torch.cat([i, f, gg, o], dim=1), 0.0)
        cells[t] = torch.where(upd, c, 0.0)
    return (torch.stack(outs, dim=1), h, c, torch.stack(gates, dim=1),
            torch.stack(cells, dim=1))


def _run_direction_backward(gates: torch.Tensor, cells: torch.Tensor, w_hh: torch.Tensor,
                            step_valid: torch.Tensor, reverse: bool, g_out, g_h, g_c):
    """The reverse recurrence of one direction: from its saved ``gates``
    [B, L, 4H] and ``cells`` [B, L, H] and the gradients of its outputs
    [B, L, H], h_T and c_T [B, H] (each may be None: zero), the gradient of
    the gates' pre-activations [B, L, 4H].  A held step passes dh and dc on
    and gets 0."""
    B, L, H = cells.shape
    zero = cells.new_zeros(B, H)
    dh = zero if g_h is None else g_h
    dc = zero if g_c is None else g_c
    dgates = [None] * L
    for t in (range(L) if reverse else range(L - 1, -1, -1)):
        upd = step_valid[t]
        i, f, gg, o = gates[:, t, :].chunk(4, dim=1)
        # the carry step t updated: the neighbour's saved cell, 0 at the walk's
        # start and after held steps (saved as 0)
        if reverse:
            c_prev = cells[:, t + 1, :] if t + 1 < L else zero
        else:
            c_prev = cells[:, t - 1, :] if t > 0 else zero
        dht = dh if g_out is None else dh + g_out[:, t, :]
        tc = torch.tanh(cells[:, t, :])
        dct = dc + dht * o * (1.0 - tc * tc)
        da = torch.cat([dct * gg * i * (1.0 - i), dct * c_prev * f * (1.0 - f),
                        dct * i * (1.0 - gg * gg), dht * tc * o * (1.0 - o)], dim=1)
        dgates[t] = torch.where(upd, da, 0.0)
        dh = torch.where(upd, da @ w_hh.t(), dh)
        dc = torch.where(upd, dct * f, dc)
    return torch.stack(dgates, dim=1)


def lstm_layer_plain(xw: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor,
                     lens: torch.Tensor, save: bool):
    """The plain version of ``mgnns_lstm_fwd_kernel``: every direction of one
    layer, xw [dirs, B, L, 4H], w_hh [dirs, H, 4H], b_hh [dirs, 4H].  Returns
    (out [B, L, dirs*H], h_n and c_n [dirs, B, H], gates [dirs, B, L, 4H],
    cells [B, L, dirs*H]); gates and cells are empty unless ``save``."""
    step_valid = _step_valid(xw[0], lens)
    runs = [_run_direction(xw[d], w_hh[d], b_hh[d], step_valid, reverse=(d == 1))
            for d in range(w_hh.shape[0])]
    out, h_n, c_n, gates, cells = zip(*runs)
    saved = ((torch.stack(gates), torch.cat(cells, -1)) if save
             else (xw.new_empty(0), xw.new_empty(0)))
    return (torch.cat(out, -1), torch.stack(h_n), torch.stack(c_n), *saved)


def lstm_layer_backward_plain(gates: torch.Tensor, cells: torch.Tensor, w_hh: torch.Tensor,
                              lens: torch.Tensor, g_out, g_hn, g_cn) -> torch.Tensor:
    """The plain version of ``mgnns_lstm_bwd_kernel``: dgates [dirs, B, L,
    4H] of one layer from :func:`lstm_layer_plain`'s saves and the gradients
    of out [B, L, dirs*H], h_n and c_n [dirs, B, H] (each may be None)."""
    dirs, H, _ = w_hh.shape
    step_valid = _step_valid(cells, lens)
    return torch.stack([_run_direction_backward(
        gates[d], cells[..., d * H:(d + 1) * H], w_hh[d], step_valid, d == 1,
        None if g_out is None else g_out[..., d * H:(d + 1) * H],
        None if g_hn is None else g_hn[d], None if g_cn is None else g_cn[d])
        for d in range(dirs)])


def lstm_apply(params: dict, x: torch.Tensor, lens: torch.Tensor, *, dropout_rate: float = 0.0,
               train: bool = False, generator: torch.Generator | None = None):
    """Returns (memory_bank [B, L, dirs*H], (h_final, c_final)) where
    h_final/c_final are [num_layers*dirs, B, H] in torch layout
    (l0_fwd, l0_bwd, l1_fwd, l1_bwd, ...)."""
    rngs = RngStream(generator)
    num_layers = len(params["layers"])
    h_finals, c_finals = [], []
    out = x
    for l, dir_params in enumerate(params["layers"]):
        # a matmul per direction, stacked direction-major: each direction's
        # weight gradient is its own dense GEMM (a column slice of one GEMM
        # over [w_ih_fwd | w_ih_bwd] would send the optimizer's foreach
        # kernels down their per-tensor path), over contiguous operands
        xw = torch.stack([out @ p["w_ih"] + p["b_ih"] for p in dir_params])
        out, h_n, c_n = lstm_kernel.lstm_layer(
            xw, torch.stack([p["w_hh"] for p in dir_params]),
            torch.stack([p["b_hh"] for p in dir_params]), lens)
        h_finals.append(h_n)
        c_finals.append(c_n)
        if l < num_layers - 1:
            out = dropout(out, dropout_rate, rngs.next(f"lstm_l{l}"), train)
    return out, (torch.cat(h_finals), torch.cat(c_finals))


def gru_init(g: torch.Generator, input_size: int, hidden_size: int,
             num_layers: int = 2, bidirectional: bool = True) -> dict:
    """``layers[l][dir]`` with w_ih [D_l, 3H], w_hh [H, 3H], b_ih, b_hh [3H],
    U(+-1/sqrt(H)) like ``nn.GRU``."""
    return _rnn_init(g, input_size, hidden_size, num_layers, bidirectional, 3)


def _run_gru_direction(p: dict, x: torch.Tensor, step_valid: torch.Tensor, reverse: bool):
    """One GRU direction over [B, L, D]; returns (outputs [B, L, H], h_T)."""
    B, L, _ = x.shape
    H = p["w_hh"].shape[0]
    xw = x @ p["w_ih"] + p["b_ih"]        # [B, L, 3H], one matmul
    h = x.new_zeros(B, H)
    outs = [None] * L
    for t in (range(L - 1, -1, -1) if reverse else range(L)):
        hw = h @ p["w_hh"] + p["b_hh"]
        xr, xz, xn = xw[:, t, :].chunk(3, dim=1)
        hr, hz, hn = hw.chunk(3, dim=1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        upd = step_valid[t]
        h = torch.where(upd, (1.0 - z) * n + z * h, h)
        outs[t] = torch.where(upd, h, 0.0)
    return torch.stack(outs, dim=1), h


def gru_apply(params: dict, x: torch.Tensor, lens: torch.Tensor, *, dropout_rate: float = 0.0,
              train: bool = False, generator: torch.Generator | None = None):
    """Returns (memory_bank [B, L, dirs*H], h_final [num_layers*dirs, B, H])
    in torch layout, as :func:`lstm_apply` (a GRU carries no cell state)."""
    rngs = RngStream(generator)
    num_layers = len(params["layers"])
    step_valid = _step_valid(x, lens)
    h_finals = []
    out = x
    for l, dir_params in enumerate(params["layers"]):
        feats = []
        for d, p in enumerate(dir_params):
            o, hT = _run_gru_direction(p, out, step_valid, reverse=(d == 1))
            feats.append(o)
            h_finals.append(hT)
        out = torch.cat(feats, dim=-1) if len(feats) > 1 else feats[0]
        if l < num_layers - 1:
            out = dropout(out, dropout_rate, rngs.next(f"gru_l{l}"), train)
    return out, torch.stack(h_finals)
