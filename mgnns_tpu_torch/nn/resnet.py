"""ResNet-50/101 trunks (torchvision structure) with train-mode BatchNorm.

Port of the JAX package's ``mgnns_tpu/nn/resnet.py``: stem 7x7/2 + BN +
ReLU + maxpool 3/2/1, then four stages of bottleneck blocks whose stride sits
on the 3x3 conv (torchvision's placement, ``resnet.py:173-189,269-275``).
The trunk's public layout is the JAX package's NHWC: images ``[B, H, W, 3]``
in, features ``[B, H/32, W/32, 2048]`` out; inside, the convs run
NCHW-shaped tensors in the channels_last memory format, which is the same
bytes.

As in the JAX package, the running statistics are a tree of their own
(``batch_stats``) beside the parameters, and the apply returns the new
statistics instead of updating them in place.  So the optimizer never sees
them, a checkpointed (rematerialized) block that runs its forward twice
yields them once, and the engine commits them only after a step's loss
proved finite.

Parameters: ``conv1`` OIHW, ``bn1`` ``{scale, bias}`` and ``layer1..4`` each a
list of blocks ``{conv1..3, bn1..3[, downsample_conv, downsample_bn]}``;
statistics: ``bn1`` ``{mean, var}`` and ``layer1..4`` lists of blocks
``{bn1..3[, downsample_bn]}``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from mgnns_tpu_torch.nn.core import normal

RESNET_LAYERS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}
EXPANSION = 4


def conv_init(g: torch.Generator, kh: int, kw: int, cin: int, cout: int) -> torch.Tensor:
    """Kaiming-normal fan_out (torchvision's ResNet init), OIHW."""
    return normal(g, (cout, cin, kh, kw), math.sqrt(2.0 / (kh * kw * cout)))


def bn_init(c: int, device) -> tuple[dict, dict]:
    return ({"scale": torch.ones(c, device=device), "bias": torch.zeros(c, device=device)},
            {"mean": torch.zeros(c, device=device), "var": torch.ones(c, device=device)})


def bn(p: dict, s: dict, x: torch.Tensor, *, train: bool, momentum: float = 0.1,
       eps: float = 1e-5) -> tuple[torch.Tensor, dict]:
    """Returns (y, new_stats), as ``nn.BatchNorm2d``: train mode normalizes
    by the biased batch variance and moves the running statistics by
    ``momentum`` towards the batch mean and the *unbiased* batch variance
    (``bn_apply``, ``mgnns_tpu/nn/resnet.py:110-138``)."""
    if not train:
        return F.batch_norm(x, s["mean"], s["var"], p["scale"], p["bias"],
                            training=False, eps=eps), s
    y = F.batch_norm(x, None, None, p["scale"], p["bias"], training=True, eps=eps)
    with torch.no_grad():
        var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
        n = x.numel() // x.shape[1]
        unbiased = var * n / max(n - 1, 1)
        new = {"mean": (1 - momentum) * s["mean"] + momentum * mean,
               "var": (1 - momentum) * s["var"] + momentum * unbiased}
    return y, new


def _bottleneck_init(g, cin, width, stride):
    cout = width * EXPANSION
    p: dict = {}
    s: dict = {}
    p["conv1"] = conv_init(g, 1, 1, cin, width)
    p["bn1"], s["bn1"] = bn_init(width, g.device)
    p["conv2"] = conv_init(g, 3, 3, width, width)
    p["bn2"], s["bn2"] = bn_init(width, g.device)
    p["conv3"] = conv_init(g, 1, 1, width, cout)
    p["bn3"], s["bn3"] = bn_init(cout, g.device)
    if stride != 1 or cin != cout:
        p["downsample_conv"] = conv_init(g, 1, 1, cin, cout)
        p["downsample_bn"], s["downsample_bn"] = bn_init(cout, g.device)
    return p, s


def _bottleneck_apply(p, s, x, stride, train):
    ns = {}
    out, ns["bn1"] = bn(p["bn1"], s["bn1"], F.conv2d(x, p["conv1"]), train=train)
    out, ns["bn2"] = bn(p["bn2"], s["bn2"], F.conv2d(F.relu(out), p["conv2"], stride=stride,
                                                     padding=1), train=train)
    out, ns["bn3"] = bn(p["bn3"], s["bn3"], F.conv2d(F.relu(out), p["conv3"]), train=train)
    if "downsample_conv" in p:
        idn, ns["downsample_bn"] = bn(p["downsample_bn"], s["downsample_bn"],
                                      F.conv2d(x, p["downsample_conv"], stride=stride), train=train)
    else:
        idn = x
    return F.relu(out + idn), ns


def resnet_init(g: torch.Generator, depth: int = 50) -> tuple[dict, dict]:
    """(params, batch_stats) of the trunk of ResNet-{depth}, with identity
    running statistics."""
    p: dict = {"conv1": conv_init(g, 7, 7, 3, 64)}
    s: dict = {}
    p["bn1"], s["bn1"] = bn_init(64, g.device)
    cin = 64
    for li, (blocks, width) in enumerate(zip(RESNET_LAYERS[depth], (64, 128, 256, 512)), start=1):
        stride = 1 if li == 1 else 2
        p[f"layer{li}"], s[f"layer{li}"] = [], []
        for b in range(blocks):
            pb, sb = _bottleneck_init(g, cin, width, stride if b == 0 else 1)
            p[f"layer{li}"].append(pb)
            s[f"layer{li}"].append(sb)
            cin = width * EXPANSION
    return p, s


def resnet_apply(params: dict, stats: dict, x: torch.Tensor, *, train: bool = False,
                 block_remat: bool = False) -> tuple[torch.Tensor, dict]:
    """x: [B, H, W, 3] normalized images -> ([B, H/32, W/32, 2048],
    new_batch_stats).  ``block_remat`` checkpoints each bottleneck block
    (``torch.utils.checkpoint``): only block inputs stay resident for the
    backward, which reruns one block's forward at a time."""
    ns: dict = {}
    out = x.permute(0, 3, 1, 2)  # NCHW shape, channels_last memory
    out, ns["bn1"] = bn(params["bn1"], stats["bn1"],
                        F.conv2d(out, params["conv1"], stride=2, padding=3), train=train)
    out = F.max_pool2d(F.relu(out), 3, 2, 1)
    for li in range(1, 5):
        ns[f"layer{li}"] = []
        for b, (pb, sb) in enumerate(zip(params[f"layer{li}"], stats[f"layer{li}"])):
            stride = 2 if (li > 1 and b == 0) else 1
            if block_remat and torch.is_grad_enabled():
                out, nsb = checkpoint(_bottleneck_apply, pb, sb, out, stride, train,
                                      use_reentrant=False)
            else:
                out, nsb = _bottleneck_apply(pb, sb, out, stride, train)
            ns[f"layer{li}"].append(nsb)
    return out.permute(0, 2, 3, 1), ns
