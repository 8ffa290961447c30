"""Share of the published bf16 peak that the trunks' convolutions reach in
the image stage of the traced training steps: their closed-form forward
and backward FLOPs over the stage's device seconds (image_ms.train)."""

from benchmark import marks as M


def read(ctx):
    return M.image_mfu(ctx, grads=True)
