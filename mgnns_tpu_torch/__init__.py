"""MGNNS in PyTorch and CUDA for an NVIDIA H100: the serving and training
paths of the ``mgnns_tpu`` JAX package, ported module by module.

It imports ``torch`` and numpy and never JAX or ``mgnns_tpu``.  Module names
mirror the JAX package: ``config``, ``graphs``, ``data``, ``nn``, ``kernels``,
``models``, ``engine``, ``serving``, ``cli``; ``convert`` carries the JAX
package's parameters across.  Entry points run on the card unless the caller passes
``device="cpu"``.
"""
