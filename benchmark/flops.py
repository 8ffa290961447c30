"""The yardstick's closed forms: FLOPs of the models' forward and train
step, the bytes and operations K1 and K2 need, and the card's published
peaks.

FLOPs count 2 per multiply-add of every convolution and product (a frozen
copy of the closed forms the port's roofline tool checked against
``FlopCounterMode``); elementwise work and the text GCN's windowed max
count nothing.  K1's and K2's least work counts each input byte read once
and each output byte written once, for the valid rows of the lengths the
kernels were given.
"""

from __future__ import annotations

import numpy as np

# NVIDIA H100 SXM data sheet, dense: bf16 tensor cores, float32 without them
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12
RESNET_LAYERS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}


def _out(n: int, k: int, stride: int, pad: int) -> int:
    return (n + 2 * pad - k) // stride + 1


def resnet_convs(depth: int, image_size: int) -> list[tuple[int, int, int, int]]:
    """(cin, cout, kernel, output pixels) of every conv of a trunk."""
    s = _out(image_size, 7, 2, 3)
    convs = [(3, 64, 7, s * s)]
    s = _out(s, 3, 2, 1)
    cin = 64
    for li, (blocks, width) in enumerate(zip(RESNET_LAYERS[depth], (64, 128, 256, 512)), 1):
        for b in range(blocks):
            stride = 2 if (li > 1 and b == 0) else 1
            out = _out(s, 3, stride, 1)
            cout = width * 4
            convs += [(cin, width, 1, s * s), (width, width, 3, out * out),
                      (width, cout, 1, out * out)]
            if stride != 1 or cin != cout:
                convs.append((cin, cout, 1, out * out))
            s, cin = out, cout
    return convs


def trunk_flops(depth: int, image_size: int, B: int, grads: bool) -> tuple[int, int]:
    """(forward, backward) FLOPs of a trunk's convolutions; the backward
    takes every weight's gradient and every conv input's but the image's."""
    fwd = sum(2 * B * cin * cout * k * k * px for cin, cout, k, px in resnet_convs(depth, image_size))
    if not grads:
        return fwd, 0
    stem = 2 * B * 3 * 64 * 7 * 7 * _out(image_size, 7, 2, 3) ** 2
    return fwd, 2 * fwd - stem


def _products(cfg: dict, B: int) -> tuple[int, int]:
    """(forward, backward) FLOPs of the fusion model's products."""
    fwd = bwd = 0

    def mm(m, k, n, grads=2):
        nonlocal fwd, bwd
        fwd += 2 * m * k * n
        bwd += grads * 2 * m * k * n

    L, H = cfg["max_len"], cfg["hidden_size"]
    d = 2 * H
    d_in = cfg["emb_size"]
    for _ in range(cfg["num_layers"]):
        for _ in range(2):
            mm(B * L, d_in, 4 * H)
            mm(B, H, 4 * H, grads=1)
            for _ in range(L - 1):
                mm(B, H, 4 * H)
        d_in = 2 * H
    hw = resnet_convs(50, cfg["image_size"])[-1][3]
    nl = cfg["num_labels"]
    for C in (cfg["object_num_classes"], cfg["place_num_classes"]):
        mm(B * hw, 2048, d)
        mm(C, cfg["in_channel"], cfg["gcn_hidden"], grads=1)
        mm(C, C, cfg["gcn_hidden"], grads=1)
        mm(C, cfg["gcn_hidden"], cfg["gcn_out"])
        mm(C, C, cfg["gcn_out"], grads=1)
        mm(B, 2048, C)
        mm(nl, 300, 300, grads=1)
        mm(B, C, 300)
        mm(B, C, 300)
        mm(B * nl, 300, 300)
        mm(B * nl, 300, 100)
        mm(B, nl * 100, 300)
    hd = cfg["n_head"] * cfg["d_kv"]
    for lk in (L, L, hw, hw):
        for _ in range(cfg["stack_num"]):
            mm(B, d, hd)
            mm(B * lk, d, hd)
            mm(B * lk, d, hd)
            mm(B * cfg["n_head"], cfg["d_kv"], lk)
            mm(B * cfg["n_head"], lk, cfg["d_kv"])
            mm(B, hd, d)
            mm(B, d, d)
            mm(B, d, d)
    mm(B, 4 * d, d)
    mm(B, d, nl)
    return fwd, bwd


def forward_flops(cfg: dict, B: int) -> int:
    """FLOPs of the fusion model's forward on ``B`` records."""
    return _products(cfg, B)[0] + sum(trunk_flops(depth, cfg["image_size"], B, False)[0]
                                      for depth in cfg["trunks"].values())


def train_step_flops(cfg: dict, B: int) -> int:
    """FLOPs of one train step on ``B`` records: forward and backward."""
    fwd, bwd = _products(cfg, B)
    return fwd + bwd + sum(sum(trunk_flops(depth, cfg["image_size"], B, True))
                           for depth in cfg["trunks"].values())


def text_forward_flops(cfg: dict, B: int) -> int:
    """FLOPs of the text-only model's forward: its head's product."""
    return 2 * B * cfg["emb_size"] * cfg["num_labels"]


def _window_pairs(lens: np.ndarray, ngram: int) -> int:
    """Valid (position, window slot) pairs of documents of ``lens`` tokens."""
    n = np.asarray(lens, np.int64)
    total = np.zeros_like(n)
    for o in range(-ngram, ngram + 1):
        total += np.clip(n - abs(o), 0, None)
    return int(total.sum())


def k1_least_seconds(lens: np.ndarray, L: int, D: int, ngram: int) -> float:
    """Least time of one K1 launch over documents of ``lens`` tokens: the
    valid rows of ``emb`` and ``w`` read, ``lens`` read, ``out`` written
    whole, against a multiply and a max per valid window slot and lane."""
    rows = int(np.sum(lens))
    W = 2 * ngram + 1
    nbytes = rows * D * 4 + rows * W * 4 + len(lens) * 4 + len(lens) * L * D * 4
    return max(nbytes / HBM_BYTES_PER_S, 2 * _window_pairs(lens, ngram) * D / PEAK_FLOPS["float32"])


def k2_least_seconds(lens: np.ndarray, L: int, D: int, ngram: int) -> float:
    """Least time of one K2 launch: the valid rows of ``emb``, ``w`` and the
    incoming gradient read, ``lens`` read, ``d_emb`` and ``d_w`` written
    whole, against 12 operations per valid window slot and lane (the
    forward's multiply and max again, two compares, the tie split, a
    multiply-add each into ``d_emb`` and ``d_w``)."""
    rows = int(np.sum(lens))
    W = 2 * ngram + 1
    nbytes = rows * D * 4 * 2 + rows * W * 4 + len(lens) * 4 + len(lens) * L * (D + W) * 4
    return max(nbytes / HBM_BYTES_PER_S, 12 * _window_pairs(lens, ngram) * D / PEAK_FLOPS["float32"])
