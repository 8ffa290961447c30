"""FLOPs of the port's programs, and their share of the card's measured peak.

The counterpart of the JAX package's ``tools/roofline.py``.  Four programs
of the flagship model (bf16 trunks, frozen BatchNorm) at ``B`` records
(``MGNNS_BENCH_BATCH``, default 32) of the flagship data
(:mod:`mgnns_tpu_torch.tools._bench_util`): the eval forward, the train
step (``Engine.train_step``, timed as the captured step replayed over a
plan), and the gradients of the ResNet-101 and ResNet-50 trunks at the
data's image size.

FLOPs are counted two ways, which must agree:

- :func:`forward_flops`, :func:`train_step_flops`, :func:`trunk_grad_flops`
  and :func:`text_forward_flops` in closed form over the model's
  convolutions and products (2 FLOPs per multiply-add; elementwise work,
  the text GCN's windowed max (K1) and its backward (K2) count nothing);
- ``torch.utils.flop_counter.FlopCounterMode`` over one eager call, which
  counts the same operators (outside any CUDA-graph capture: it is a
  dispatch mode).

Times come from :func:`~mgnns_tpu_torch.tools._bench_util.timed`, and each
program's rate is given as a share of ``measured_bf16_peak``.  Run on a card:

    python -m mgnns_tpu_torch.tools.roofline

It prints a markdown table and, last, one JSON line.  It writes no file.
"""

from __future__ import annotations

import json
import os
import statistics

import torch

from mgnns_tpu_torch.config import ModelConfig
from mgnns_tpu_torch.nn.resnet import EXPANSION, RESNET_LAYERS
from mgnns_tpu_torch.utils import tree_leaves, tree_unflatten


def _conv_out(n: int, k: int, stride: int, pad: int) -> int:
    return (n + 2 * pad - k) // stride + 1


def resnet_convs(depth: int, image_size: int) -> list[tuple[int, int, int, int]]:
    """(cin, cout, kernel, output pixels) of every conv of a trunk, in
    order (:func:`mgnns_tpu_torch.nn.resnet.resnet_apply`)."""
    s = _conv_out(image_size, 7, 2, 3)
    convs = [(3, 64, 7, s * s)]
    s = _conv_out(s, 3, 2, 1)  # max-pool 3/2/1
    cin = 64
    for li, (blocks, width) in enumerate(zip(RESNET_LAYERS[depth], (64, 128, 256, 512)), start=1):
        for b in range(blocks):
            stride = 2 if (li > 1 and b == 0) else 1
            out = _conv_out(s, 3, stride, 1)
            cout = width * EXPANSION
            convs += [(cin, width, 1, s * s), (width, width, 3, out * out),
                      (width, cout, 1, out * out)]
            if stride != 1 or cin != cout:
                convs.append((cin, cout, 1, out * out))
            s, cin = out, cout
    return convs


def feature_pixels(image_size: int) -> int:
    """The trunks' output pixels (``h * w`` of ``[B, h, w, 2048]``)."""
    return resnet_convs(50, image_size)[-1][3]


def trunk_flops(depth: int, image_size: int, B: int, grads: bool) -> tuple[int, int]:
    """(forward, backward) FLOPs of a trunk's convolutions; the backward
    computes every weight's gradient and every conv input's but the
    image's."""
    fwd = sum(2 * B * cin * cout * k * k * px for cin, cout, k, px in resnet_convs(depth, image_size))
    if not grads:
        return fwd, 0
    stem = 2 * B * 3 * 64 * 7 * 7 * _conv_out(image_size, 7, 2, 3) ** 2
    return fwd, 2 * fwd - stem


class _Products:
    """A tally of products: ``mm(m, k, n, grads)`` adds ``2*m*k*n`` to the
    forward and ``grads`` times as much to the backward (the gradients
    autograd computes: one per operand that requires it)."""

    def __init__(self):
        self.fwd = self.bwd = 0

    def mm(self, m: int, k: int, n: int, grads: int = 2) -> None:
        self.fwd += 2 * m * k * n
        self.bwd += grads * 2 * m * k * n


def _mgnns_products(cfg: ModelConfig, B: int, L: int) -> _Products:
    """The products of :func:`mgnns_tpu_torch.models.mgnns.mgnns_apply` and
    of its backward in ``Engine.train_step`` (every parameter trained; the
    constants, the label graphs' normalized adjacency and an LSTM
    direction's zero start state get no gradient)."""
    if cfg.is_regu:
        raise ValueError("the head-diversity regularizer's products are not counted")
    t = _Products()
    d, H = cfg.bi_hidden_size, cfg.hidden_size
    dirs = 2 if cfg.bidirectional else 1
    d_in = cfg.emb_size
    for _ in range(cfg.num_layers):                       # the BiLSTM
        for _ in range(dirs):
            t.mm(B * L, d_in, 4 * H)                      # the input projection
            t.mm(B, H, 4 * H, grads=1)                    # the first step's h is 0
            for _ in range(L - 1):
                t.mm(B, H, 4 * H)
        d_in = H * dirs
    hw = feature_pixels(cfg.image_size)
    trunk = 1 if cfg.freeze_trunks else 2                 # the trunk features' gradient
    nl = cfg.num_labels
    for C in (cfg.object_num_classes, cfg.place_num_classes):
        t.mm(B * hw, 2048, d, grads=trunk)                # liner_img
        t.mm(C, cfg.in_channel, cfg.gcn_hidden, grads=1)  # gc1 on the GloVe constants
        t.mm(C, C, cfg.gcn_hidden, grads=1)               # adj @ ...
        t.mm(C, cfg.gcn_hidden, cfg.gcn_out)              # gc2
        t.mm(C, C, cfg.gcn_out, grads=1)
        t.mm(B, 2048, C, grads=trunk)                     # pooled @ x.T
        t.mm(nl, 300, 300, grads=1)                       # label attention: Q of the constants
        t.mm(B, C, 300)                                   # K
        t.mm(B, C, 300)                                   # V
        t.mm(B * nl, 300, 300)                            # fc
        t.mm(B * nl, 300, 100)                            # linear_5
        t.mm(B, nl * 100, 300)                            # x_linear
    hd = cfg.n_head * cfg.d_kv
    for lk in (L, L, hw, hw):                             # the four 1-query stacks
        for _ in range(cfg.stack_num):
            t.mm(B, d, hd)                                # w_qs
            t.mm(B * lk, d, hd)                           # w_ks
            t.mm(B * lk, d, hd)                           # w_vs
            t.mm(B * cfg.n_head, cfg.d_kv, lk)            # scores
            t.mm(B * cfg.n_head, lk, cfg.d_kv)            # attention @ v
            t.mm(B, hd, d)                                # fc
            t.mm(B, d, d)                                 # FFN w_1
            t.mm(B, d, d)                                 # FFN w_2
    t.mm(B, 4 * d, d)                                     # multi_linear_1
    t.mm(B, d, nl)                                        # multi_linear_2
    return t


def forward_flops(cfg: ModelConfig, B: int, L: int) -> int:
    """FLOPs of the fusion model's forward on ``B`` records of ``L``
    tokens (eval and train alike)."""
    return (_mgnns_products(cfg, B, L).fwd
            + sum(trunk_flops(depth, cfg.image_size, B, False)[0] for depth in (101, 50)))


def train_step_flops(cfg: ModelConfig, B: int, L: int) -> int:
    """FLOPs of ``Engine.train_step`` on ``B`` records: the forward and the
    backward (rematerialization's recomputed forwards are not counted, as
    model FLOPs never count them)."""
    t = _mgnns_products(cfg, B, L)
    trunks = [trunk_flops(depth, cfg.image_size, B, not cfg.freeze_trunks) for depth in (101, 50)]
    return t.fwd + t.bwd + sum(f + b for f, b in trunks)


def trunk_grad_flops(depth: int, image_size: int, B: int) -> int:
    """FLOPs of a trunk's forward and the gradient of its parameters."""
    return sum(trunk_flops(depth, image_size, B, True))


def text_forward_flops(num_labels: int, B: int, hidden: int = 300) -> int:
    """FLOPs of the text-only model's forward: its head (the text GCN's
    windowed max and readout are no products)."""
    return 2 * B * hidden * num_labels


def counted_flops(fn, *args) -> int:
    """FLOPs of one eager call of ``fn(*args)`` by ``FlopCounterMode``."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*args)
    return counter.get_total_flops()


def trunk_grad_fn(depth: int, dtype: torch.dtype, device):
    """(fn, params) where ``fn(params, x)`` returns the gradient of
    ``sum(features ** 2)`` over a trunk's parameters at frozen BatchNorm."""
    from mgnns_tpu_torch.nn import resnet

    g = torch.Generator(device=device).manual_seed(depth)
    params, stats = resnet.resnet_init(g, depth=depth)
    leaves = tree_leaves(params)

    def fn(p, x):
        live = [q.detach().requires_grad_() for q in leaves]
        feats, _ = resnet.resnet_apply(tree_unflatten(params, live), stats, x, train=False, dtype=dtype)
        return torch.autograd.grad((feats.float() ** 2).sum(), live)

    return fn, params


def main(argv=None) -> int:
    import argparse

    from mgnns_tpu_torch.data.loader import DeviceLoader
    from mgnns_tpu_torch.engine.metrics import confusion_init
    from mgnns_tpu_torch.engine.train import Engine
    from mgnns_tpu_torch.models.mgnns import normalize_image_batch
    from mgnns_tpu_torch.tools import _bench_util as U
    from mgnns_tpu_torch.utils import resolve_device

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batch", type=int, default=int(os.environ.get("MGNNS_BENCH_BATCH", "32")))
    args = p.parse_args(argv)
    dev = resolve_device("cuda")
    B = args.batch
    peak = U.measured_bf16_peak(device=dev)
    data = U.flagship_data(n_records=2 * B)
    L = data.graph_cfg.max_len
    model = U.flagship_model(data, bn_mode="frozen", device=dev)
    cfg = model.cfg
    loader = DeviceLoader(data.ds, B, device=dev)
    it = iter(loader)
    batch = next(it)
    it.close()
    rows = []

    def eval_fn(b):
        with torch.inference_mode():
            return model.apply_fn(model.params, model.bstats, b, train=False,
                                  generator=None)[0].argmax(-1)

    rows.append((f"eval forward (B={B})", forward_flops(cfg, B, L), counted_flops(eval_fn, batch),
                 U.timed(eval_fn, (batch,), 20, readback=lambda o: int(o[0]))))

    eng = Engine(model.apply_fn, model.params, model.bstats, num_classes=cfg.num_labels,
                 steps_per_epoch=1, device=dev)
    counted = counted_flops(eng.train_step, batch, confusion_init(cfg.num_labels, dev))
    # the step as the engine runs it over device tables: a captured graph per step
    table = DeviceLoader(data.ds, B, shuffle=True, device_text=True, device_images=True,
                         device=dev)
    eng.train_epoch(table)  # capture
    per_step = [eng.train_epoch(table)["epoch_seconds"] / len(table) for _ in range(5)]
    rows.append((f"train step, captured (B={B})", train_step_flops(cfg, B, L), counted,
                 statistics.median(per_step)))

    x = normalize_image_batch(batch["image"], cfg.cdtype)
    for depth in (101, 50):
        fn, params = trunk_grad_fn(depth, cfg.cdtype, dev)
        rows.append((f"resnet{depth} grad (B={B})", trunk_grad_flops(depth, cfg.image_size, B),
                     counted_flops(fn, params, x),
                     U.timed(fn, (params, x), 10, readback=lambda o: float(o[0].sum()))))

    card = U.device_info(dev)
    print(f"measured peak (chained bf16 8192^3 products): {peak} TFLOP/s on {card}")
    print("| program | FLOPs (closed form) | FLOPs (FlopCounterMode) | time | TFLOP/s | "
          "% of measured peak |")
    print("|---|---|---|---|---|---|")
    results = {"peak_bf16_tflops": peak, "batch": B, "device": card, "data": data.name}
    for name, f, fc, dt in rows:
        tf = f / dt / 1e12
        print(f"| {name} | {f} | {fc} | {dt * 1e3} ms | {tf} | {100 * tf / peak} |")
        results[name.split(" (")[0].replace(" ", "_").replace(",", "")] = {
            "flops": f, "flops_counted": fc, "seconds": dt, "tflops": tf,
            "pct_of_peak": 100 * tf / peak}
    bad = [name for name, f, fc, _ in rows if f != fc]
    print(json.dumps(results))
    if bad:
        raise SystemExit(f"the closed-form FLOPs disagree with FlopCounterMode: {bad}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
