"""Share of the published bf16 peak that the window's train steps of the
fusion model with the MoE text encoder reach: the closed-form FLOPs of a
step (the fusion model's without the BiLSTM, plus the encoder's over the
tokens the held experts got, the program's ``moe.tokens`` per step) x
steps, over the window's wall seconds."""

from benchmark import flops_moe as FM
from benchmark import readers as R


def read(ctx):
    c = ctx["counters"]
    if "moe_tokens" not in c or not c.get("batch"):
        return None
    cfg = ctx["config"]
    flops = FM.train_step_flops(cfg, c["batch"], cfg["fusion"]["max_len"], c["moe_tokens"])
    return R.mfu(ctx, flops, "steps")
