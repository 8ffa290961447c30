#!/usr/bin/env python3
"""End-to-end benchmark of the PyTorch/CUDA port (``mgnns_tpu_torch``).

    python bench_torch.py                          # full mode on cuda:0
    MGNNS_BENCH_MODE=text python bench_torch.py    # or train
    MGNNS_BENCH_PLATFORM=cpu python bench_torch.py # on the CPU

Prints one JSON line, as ``bench.py`` (the JAX package's) does; the modes,
settings and keys are in :mod:`mgnns_tpu_torch.bench`.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from mgnns_tpu_torch.bench import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
