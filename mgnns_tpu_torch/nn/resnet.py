"""ResNet-50/101 trunks (torchvision structure), eval forward.

Port of the JAX package's ``mgnns_tpu/nn/resnet.py``: stem 7x7/2 + BN +
ReLU + maxpool 3/2/1, then four stages of bottleneck blocks whose stride sits
on the 3x3 conv (torchvision's placement, ``resnet.py:173-189,269-275``).
BatchNorm uses the running statistics (eps 1e-5).  The trunk's public layout
is the JAX package's NHWC: images ``[B, H, W, 3]`` in, features
``[B, H/32, W/32, 2048]`` out; inside, the convs run NCHW-shaped tensors in
the channels_last memory format, which is the same bytes.

Parameters: ``conv1`` OIHW, ``bn1`` ``{scale, bias, mean, var}`` and
``layer1..4`` each a list of blocks ``{conv1..3, bn1..3[, downsample_conv,
downsample_bn]}``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from mgnns_tpu_torch.nn.core import normal

RESNET_LAYERS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}
EXPANSION = 4


def conv_init(g: torch.Generator, kh: int, kw: int, cin: int, cout: int) -> torch.Tensor:
    """Kaiming-normal fan_out (torchvision's ResNet init), OIHW."""
    return normal(g, (cout, cin, kh, kw), math.sqrt(2.0 / (kh * kw * cout)))


def bn_init(c: int, device) -> dict:
    return {"scale": torch.ones(c, device=device), "bias": torch.zeros(c, device=device),
            "mean": torch.zeros(c, device=device), "var": torch.ones(c, device=device)}


def bn(p: dict, x: torch.Tensor) -> torch.Tensor:
    return F.batch_norm(x, p["mean"], p["var"], p["scale"], p["bias"],
                        training=False, eps=1e-5)


def _bottleneck_init(g, cin, width, stride):
    cout = width * EXPANSION
    p = {
        "conv1": conv_init(g, 1, 1, cin, width), "bn1": bn_init(width, g.device),
        "conv2": conv_init(g, 3, 3, width, width), "bn2": bn_init(width, g.device),
        "conv3": conv_init(g, 1, 1, width, cout), "bn3": bn_init(cout, g.device),
    }
    if stride != 1 or cin != cout:
        p["downsample_conv"] = conv_init(g, 1, 1, cin, cout)
        p["downsample_bn"] = bn_init(cout, g.device)
    return p


def _bottleneck_apply(p, x, stride):
    out = F.relu(bn(p["bn1"], F.conv2d(x, p["conv1"])))
    out = F.relu(bn(p["bn2"], F.conv2d(out, p["conv2"], stride=stride, padding=1)))
    out = bn(p["bn3"], F.conv2d(out, p["conv3"]))
    if "downsample_conv" in p:
        idn = bn(p["downsample_bn"], F.conv2d(x, p["downsample_conv"], stride=stride))
    else:
        idn = x
    return F.relu(out + idn)


def resnet_init(g: torch.Generator, depth: int = 50) -> dict:
    """Trunk parameters of ResNet-{depth}, with identity running stats."""
    p: dict = {"conv1": conv_init(g, 7, 7, 3, 64), "bn1": bn_init(64, g.device)}
    cin = 64
    for li, (blocks, width) in enumerate(zip(RESNET_LAYERS[depth], (64, 128, 256, 512)), start=1):
        stride = 1 if li == 1 else 2
        layer = []
        for b in range(blocks):
            layer.append(_bottleneck_init(g, cin, width, stride if b == 0 else 1))
            cin = width * EXPANSION
        p[f"layer{li}"] = layer
    return p


def resnet_apply(params: dict, x: torch.Tensor) -> torch.Tensor:
    """x: [B, H, W, 3] normalized images -> [B, H/32, W/32, 2048]."""
    out = x.permute(0, 3, 1, 2)  # NCHW shape, channels_last memory
    out = F.relu(bn(params["bn1"], F.conv2d(out, params["conv1"], stride=2, padding=3)))
    out = F.max_pool2d(out, 3, 2, 1)
    for li in range(1, 5):
        for b, block in enumerate(params[f"layer{li}"]):
            out = _bottleneck_apply(block, out, 2 if (li > 1 and b == 0) else 1)
    return out.permute(0, 2, 3, 1)
