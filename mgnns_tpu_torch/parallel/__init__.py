"""Data-parallel training on ``torch.distributed``: the process group, the
mesh, input plans and the data axis's collectives (the counterpart of the
JAX package's ``mgnns_tpu/parallel``; its model axis is ``ROADMAP.md``
queue 1 item 6b)."""
