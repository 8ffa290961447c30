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
``{bn1..3[, downsample_bn]}``.  This is torchvision's layout, so
:func:`import_torch_state_dict` only renames.

Precision.  ``resnet_apply(..., dtype=)`` casts exactly where the JAX
package's trunk casts: each conv's input and weight go to ``dtype`` (the
float32 master weights receive float32 gradients through the cast); BatchNorm
takes batch statistics in float32 and normalizes in the activation's dtype
(``F.batch_norm``, which normalizes in float32 and rounds once where XLA
rounds each elementwise op); ReLU, max-pool and the residual add run in the
activation's dtype.

Every trunk conv runs in IEEE float32 on the card when its operands are
float32, forward and backward, whatever torch's global TF32 flags say:
:func:`ieee_float32_convs` sets ``torch.backends.cudnn.conv.fp32_precision``
to ``"ieee"`` for the duration of a call and restores the caller's value
after.  Autograd runs a conv's backward outside any forward-time context, so
the trunk's convs go through :class:`_PinnedConv2d`, an autograd function
whose ``backward`` enters the same pin: the backward is covered whoever
calls it (``Engine.train_step``, a user's ``torch.autograd.grad``, a
rematerialized block).  Only the new ``fp32_precision`` API is used: mixing
it with the legacy ``allow_tf32`` flags can raise.  The same pin sets
``torch.backends.cudnn.deterministic``, for bf16 convs too, so that a train
step is reproducible from run to run, as the JAX package's is; a CUDA graph
captured inside it keeps the algorithms chosen then.

Under a data axis of more than one rank (:mod:`mgnns_tpu_torch.parallel`)
train-mode BatchNorm takes its statistics over the global batch
(:func:`mgnns_tpu_torch.parallel.collectives.sync_batch_norm`); with no axis
or an axis of one rank it is ``F.batch_norm``, as without a mesh.
"""

from __future__ import annotations

import contextlib
import math
import threading

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from mgnns_tpu_torch.nn.core import normal

RESNET_LAYERS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}
EXPANSION = 4


_pin_lock = threading.Lock()
_pin_depth = 0
_pin_saved: tuple = ()


@contextlib.contextmanager
def ieee_float32_convs():
    """Run cuDNN's float32 convolutions in IEEE float32 (no TF32) and with
    cuDNN's deterministic algorithms inside the block.  Without the second
    flag cuDNN's default float32 weight gradient adds with atomics, and two
    runs of the same train steps part from the second step on.  The flags
    are process-wide: the first thread to enter saves the caller's values
    and the last to leave restores them."""
    global _pin_depth, _pin_saved
    conv = torch.backends.cudnn.conv
    with _pin_lock:
        if _pin_depth == 0:
            _pin_saved = (conv.fp32_precision, torch.backends.cudnn.deterministic)
            conv.fp32_precision = "ieee"
            torch.backends.cudnn.deterministic = True
        _pin_depth += 1
    try:
        yield
    finally:
        with _pin_lock:
            _pin_depth -= 1
            if _pin_depth == 0:
                conv.fp32_precision, torch.backends.cudnn.deterministic = _pin_saved


class _PinnedConv2d(torch.autograd.Function):
    """``F.conv2d`` (no bias, dilation 1, one group) whose forward and
    backward both run under :func:`ieee_float32_convs`."""

    @staticmethod
    def forward(ctx, x, w, stride: int, padding: int):
        ctx.save_for_backward(x, w)
        ctx.stride, ctx.padding = stride, padding
        with ieee_float32_convs():
            return F.conv2d(x, w, stride=stride, padding=padding)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        with ieee_float32_convs():
            dx, dw, _ = torch.ops.aten.convolution_backward(
                g, x, w, None, [ctx.stride] * 2, [ctx.padding] * 2, [1, 1], False, [0, 0], 1,
                [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False])
        return dx, dw, None, None


def conv(x: torch.Tensor, w: torch.Tensor, dtype: torch.dtype, stride: int = 1,
         padding: int = 0) -> torch.Tensor:
    """A trunk conv in ``dtype`` (``conv_apply``, ``mgnns_tpu/nn/resnet.py:43-61``):
    input and weight are cast to ``dtype``, and the conv runs pinned."""
    return _PinnedConv2d.apply(x.to(dtype), w.to(dtype), stride, padding)


def conv_init(g: torch.Generator, kh: int, kw: int, cin: int, cout: int) -> torch.Tensor:
    """Kaiming-normal fan_out (torchvision's ResNet init), OIHW."""
    return normal(g, (cout, cin, kh, kw), math.sqrt(2.0 / (kh * kw * cout)))


def bn_init(c: int, device) -> tuple[dict, dict]:
    return ({"scale": torch.ones(c, device=device), "bias": torch.zeros(c, device=device)},
            {"mean": torch.zeros(c, device=device), "var": torch.ones(c, device=device)})


def bn(p: dict, s: dict, x: torch.Tensor, *, train: bool, momentum: float = 0.1,
       eps: float = 1e-5, axis=None) -> tuple[torch.Tensor, dict]:
    """Returns (y, new_stats), as ``nn.BatchNorm2d``: train mode normalizes
    by the biased batch variance and moves the running statistics by
    ``momentum`` towards the batch mean and the *unbiased* batch variance
    (``bn_apply``, ``mgnns_tpu/nn/resnet.py:110-138``).  The statistics are
    float32 whatever ``x``'s dtype; ``y`` has ``x``'s dtype.  ``axis``: the
    data axis of a step on several ranks, over whose global batch train mode
    takes the statistics (the unbiased variance with the global count)."""
    if not train:
        return F.batch_norm(x, s["mean"], s["var"], p["scale"], p["bias"],
                            training=False, eps=eps), s
    if axis is not None and axis.size > 1:
        from mgnns_tpu_torch.parallel.collectives import sync_batch_norm

        y, mean, var, n = sync_batch_norm(x, p["scale"], p["bias"], eps, axis)
    else:
        y = F.batch_norm(x, None, None, p["scale"], p["bias"], training=True, eps=eps)
        with torch.no_grad():
            var, mean = torch.var_mean(x.float(), dim=(0, 2, 3), unbiased=False)
        n = x.numel() // x.shape[1]
    with torch.no_grad():
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


def _bottleneck_apply(p, s, x, stride, train, dtype, axis=None):
    ns = {}
    out, ns["bn1"] = bn(p["bn1"], s["bn1"], conv(x, p["conv1"], dtype), train=train, axis=axis)
    out, ns["bn2"] = bn(p["bn2"], s["bn2"], conv(F.relu(out), p["conv2"], dtype, stride, 1),
                        train=train, axis=axis)
    out, ns["bn3"] = bn(p["bn3"], s["bn3"], conv(F.relu(out), p["conv3"], dtype), train=train,
                        axis=axis)
    if "downsample_conv" in p:
        idn, ns["downsample_bn"] = bn(p["downsample_bn"], s["downsample_bn"],
                                      conv(x, p["downsample_conv"], dtype, stride), train=train,
                                      axis=axis)
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
                 block_remat: bool = False, dtype: torch.dtype = torch.float32,
                 axis=None) -> tuple[torch.Tensor, dict]:
    """x: [B, H, W, 3] normalized images -> ([B, H/32, W/32, 2048] in
    ``dtype``, new_batch_stats).  ``block_remat`` checkpoints each bottleneck
    block (``torch.utils.checkpoint``): only block inputs stay resident for
    the backward, which reruns one block's forward at a time (and, under a
    data ``axis``, its BatchNorm collectives, on every rank alike)."""
    ns: dict = {}
    out = x.permute(0, 3, 1, 2)  # NCHW shape, channels_last memory
    out, ns["bn1"] = bn(params["bn1"], stats["bn1"],
                        conv(out, params["conv1"], dtype, 2, 3), train=train, axis=axis)
    out = F.max_pool2d(F.relu(out), 3, 2, 1)
    for li in range(1, 5):
        ns[f"layer{li}"] = []
        for b, (pb, sb) in enumerate(zip(params[f"layer{li}"], stats[f"layer{li}"])):
            stride = 2 if (li > 1 and b == 0) else 1
            if block_remat and torch.is_grad_enabled():
                # a block draws no random numbers, so its RNG state is not
                # saved: torch would read the card's generator, which a CUDA
                # graph capture forbids
                out, nsb = checkpoint(_bottleneck_apply, pb, sb, out, stride, train, dtype, axis,
                                      use_reentrant=False, preserve_rng_state=False)
            else:
                out, nsb = _bottleneck_apply(pb, sb, out, stride, train, dtype, axis)
            ns[f"layer{li}"].append(nsb)
    return out.permute(0, 2, 3, 1), ns


def import_torch_state_dict(state_dict: dict, depth: int) -> tuple[dict, dict]:
    """(params, batch_stats) of a trunk from a torchvision-format ResNet
    ``state_dict`` (``import_torch_state_dict``,
    ``mgnns_tpu/nn/resnet.py:307-353``), for example the Places365
    ``resnet50_places365.pth.tar`` once its ``module.`` prefix is stripped.
    The layouts are the same, so this renames: each tensor is copied as
    float32 on the CPU."""

    def arr(name):
        return torch.as_tensor(state_dict[name]).detach().to("cpu", torch.float32).clone()

    def bn_pair(name):
        return ({"scale": arr(f"{name}.weight"), "bias": arr(f"{name}.bias")},
                {"mean": arr(f"{name}.running_mean"), "var": arr(f"{name}.running_var")})

    p: dict = {"conv1": arr("conv1.weight")}
    s: dict = {}
    p["bn1"], s["bn1"] = bn_pair("bn1")
    for li, blocks in enumerate(RESNET_LAYERS[depth], start=1):
        p[f"layer{li}"], s[f"layer{li}"] = [], []
        for b in range(blocks):
            pre = f"layer{li}.{b}"
            pb: dict = {}
            sb: dict = {}
            for ci in (1, 2, 3):
                pb[f"conv{ci}"] = arr(f"{pre}.conv{ci}.weight")
                pb[f"bn{ci}"], sb[f"bn{ci}"] = bn_pair(f"{pre}.bn{ci}")
            if f"{pre}.downsample.0.weight" in state_dict:
                pb["downsample_conv"] = arr(f"{pre}.downsample.0.weight")
                pb["downsample_bn"], sb["downsample_bn"] = bn_pair(f"{pre}.downsample.1")
            p[f"layer{li}"].append(pb)
            s[f"layer{li}"].append(sb)
    return p, s
